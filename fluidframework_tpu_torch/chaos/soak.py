"""Chaos soak: a seeded fault campaign against the full pipeline.

JAX counterpart: ``fluidframework_tpu/chaos/soak.py``; the port's copy of
phase A, imports rebased to this package, with ``DeviceStage``'s applier
a ``GpuDocumentApplier`` on ``cuda`` unless given ``device="cpu"``.
``mesh_shards=n`` runs that applier over a doc-sharded mesh of n shards,
all on the stage's device when one is named, else on n cards (too few
cards raise; no virtual devices are forced). Phase B (socket clients, a
relay-tier gateway, the snapshot plane's served chunks) comes with the
network tier (ROADMAP A8) and raises ``NotImplementedError``.

``python -m fluidframework_tpu_torch.chaos.soak --seed N [--quick]
[--device cpu] [--mesh-shards N]`` runs phase A and asserts every
invariant the monitor knows about, plus replica/device fingerprint
identity at quiescence:

- **Phase A** (in-proc, ``auto_drain=False`` — fully deterministic):
  merge-tree clients edit one document through a LocalServer while the
  fault plane tears/duplicates/rewinds log appends, drops/repeats
  broadcaster fan-out, hard-crashes the orderer (deli replays the raw
  log and re-tickets), crashes an in-soak device stage in both
  checkpoint windows and both overlap windows of its applier, forces the
  applier's wide-dispatch and overflow-to-host escalations, and tears a
  fork of the history plane in both of its crash windows. Same seed ⇒
  same injections in the same places ⇒ the same failure reproduces
  exactly.

The run fails (exit 1) on any invariant violation, on missing boundary
coverage (every class phase A injects — log, fanout, stage, device,
history — must see at least one injection), or when an injected fault
class shows no matching recovery in telemetry. ``--break-dedupe`` and
``--no-recover`` are self-tests: each disables one recovery layer and
the soak MUST fail, proving the monitor actually detects what the faults
inject.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
from dataclasses import replace
from typing import Optional

from ..mergetree.client import MergeTreeClient
from ..mergetree.ops import op_to_wire
from ..obs import get_recorder, tier_counters
from ..protocol.messages import DocumentMessage, MessageType
from ..utils.telemetry import Counters
from .hooks import install
from .monitor import InvariantMonitor, InvariantViolation, doc_fingerprint
from .plane import FaultPlane, SimulatedCrash

TENANT = "chaos"
DOC = "soak"
DS_ID = "default"
CHANNEL_ID = "text"

#: the boundary classes phase A injects (network and snapshot faults are
#: phase B's)
BOUNDARY_REQUIRED = ("log", "fanout", "stage", "device", "history")

_TEXT_POOL = "abcdefgh" * 4


def _chan_msg(cseq: int, ref_seq: int, wire_op: dict) -> DocumentMessage:
    return DocumentMessage(
        client_sequence_number=cseq,
        reference_sequence_number=ref_seq,
        type=MessageType.OPERATION,
        contents={"kind": "chanop", "address": DS_ID,
                  "contents": {"address": CHANNEL_ID, "contents": wire_op}})


def _chan_contents(m):
    """The merge-tree wire op inside a sequenced message, or None."""
    if m.type != MessageType.OPERATION:
        return None
    env = m.contents
    if type(env) is not dict or env.get("kind") != "chanop" \
            or env.get("address") != DS_ID:
        return None
    inner = env["contents"]
    if inner.get("address") != CHANNEL_ID or "attach" in inner:
        return None
    return inner["contents"]


def _replica_fingerprint(replica: MergeTreeClient) -> str:
    text = replica.get_text()
    props = [replica.get_properties_at(i) or {} for i in range(len(text))]
    return doc_fingerprint(text, props)


# =====================================================================
# Phase A: deterministic in-proc campaign
# =====================================================================


class SoakClient:
    """One editing client: a MergeTreeClient replica over a LocalServer
    connection, with the full recovery protocol — seq dedupe, gap repair
    through delta storage, and reconnect + rebase + resubmit."""

    def __init__(self, server, monitor: InvariantMonitor, counters: Counters,
                 rng: random.Random, recover: bool = True):
        self.server = server
        self.monitor = monitor
        self.counters = counters
        self.rng = rng
        self.recover = recover
        self.replica: MergeTreeClient | None = None
        self.conn = None
        self.cseq = 0
        self.last_seq = 0
        self.nacked = False
        self.unresolved: list[int] = []  # this incarnation's open cseqs
        self.reconnects = 0
        self.connect()

    # ---------------------------------------------------------- lifecycle

    def connect(self) -> None:
        conn = self.server.connect(TENANT, DOC)
        self.conn = conn
        if self.replica is None:
            self.replica = MergeTreeClient(conn.client_id)
        else:
            self.replica.update_client_id(conn.client_id)
        self.cseq = 0
        self.nacked = False
        self.unresolved = []
        conn.on_ops = self._on_ops
        conn.on_nack = self._on_nack

    def reconnect(self) -> None:
        """Call only at drain quiescence: abandon open submissions, take a
        new incarnation, rebase pending ops, resubmit."""
        old_id = self.conn.client_id
        self.conn.disconnect()
        for cseq in self.unresolved:
            self.monitor.note_resubmitted(old_id, cseq)
        self.connect()
        self.reconnects += 1
        self.counters.inc("chaos.recovered.reconnect")
        self.catch_up()
        for op in self.replica.regenerate_pending_ops():
            self._submit_wire(op_to_wire(op))

    def catch_up(self) -> None:
        """Backfill any sequenced ops this replica missed (dropped
        broadcasts, disconnect windows) from delta storage."""
        missed = self.server.get_deltas(TENANT, DOC, self.last_seq, 10 ** 9)
        if missed:
            self.counters.inc("chaos.recovered.gap_repair")
        for m in missed:
            if m.sequence_number > self.last_seq:
                self._apply(m)

    # ------------------------------------------------------------ inbound

    def _on_ops(self, batch) -> None:
        for m in batch:
            seq = m.sequence_number
            if seq <= self.last_seq:
                # redelivered (rewound subscriber / crash re-ticket /
                # repeated broadcast): clients dedupe by seq
                self.counters.inc("chaos.recovered.client_dedup")
                continue
            if seq > self.last_seq + 1:
                # a dropped broadcast left a gap: repair from delta
                # storage before applying the new message
                self.counters.inc("chaos.recovered.gap_repair")
                for g in self.server.get_deltas(TENANT, DOC,
                                                self.last_seq, seq):
                    if g.sequence_number > self.last_seq:
                        self._apply(g)
            self._apply(m)

    def _apply(self, m) -> None:
        self.last_seq = m.sequence_number
        wire = _chan_contents(m)
        if wire is not None:
            if self.replica.is_own_message(m.client_id):
                self.unresolved = [c for c in self.unresolved
                                   if c != m.client_sequence_number]
            self.replica.apply_msg(replace(m, contents=wire))
        else:
            # join/leave/noop/summary traffic: advance the window only
            self.replica.tree.current_seq = max(
                self.replica.tree.current_seq, m.sequence_number)
            self.replica.tree.update_min_seq(m.minimum_sequence_number)

    def _on_nack(self, nack) -> None:
        self.nacked = True
        op = getattr(nack, "operation", None)
        cseq = getattr(op, "client_sequence_number", None)
        self.monitor.note_nack(self.conn.client_id, cseq)
        if cseq is not None:
            self.unresolved = [c for c in self.unresolved if c != cseq]

    # ----------------------------------------------------------- outbound

    def _submit_wire(self, wire_op: dict) -> None:
        self.cseq += 1
        self.monitor.note_submit(self.conn.client_id, self.cseq)
        self.unresolved.append(self.cseq)
        self.conn.submit([_chan_msg(
            self.cseq, self.replica.tree.current_seq, wire_op)])

    def edit(self, n_ops: int) -> None:
        if self.nacked:
            return  # wedged until the next quiescent reconnect
        rng = self.rng
        for _ in range(n_ops):
            length = self.replica.get_length()
            r = rng.random()
            if length > 4 and r < 0.3:
                start = rng.randrange(length - 1)
                end = start + 1 + rng.randrange(min(length - start - 1, 4))
                op = self.replica.remove_range_local(start, end)
            elif length > 1 and r < 0.35:
                start = rng.randrange(length - 1)
                end = start + 1 + rng.randrange(min(length - start - 1, 4))
                op = self.replica.annotate_range_local(
                    start, end, {"k": rng.randrange(4)})
            else:
                off = rng.randrange(8)
                text = _TEXT_POOL[off:off + 1 + rng.randrange(6)]
                op = self.replica.insert_text_local(
                    rng.randrange(length + 1), text)
            self._submit_wire(op_to_wire(op))

    @property
    def settled(self) -> bool:
        return not self.unresolved and not self.nacked \
            and not self.replica.pending


class DeviceStage:
    """In-soak stand-in for stage_runner.ApplierStage: a replica farm on
    ``device`` (``cuda`` when None) consuming the deltas topic with the
    same checkpoint protocol (farm save BEFORE offset save), stepped
    synchronously — the applier is not async, so its overlap-window
    crash seams fire on this thread — so the soak can kill it exactly
    inside either crash window and run the real restore. With
    ``mesh_shards`` the farm is doc-sharded over that many shards (the
    multi-device lane): the whole crash/checkpoint/restore protocol must
    hold there too."""

    #: the JAX soak's farm geometry, so both packages' stages take the
    #: same waves
    GEOMETRY = dict(max_docs=8, max_slots=64)

    def __init__(self, server, plane: FaultPlane, counters: Counters,
                 state_dir: str, device=None, mesh_shards: int = 0):
        from ..service.gpu_applier import GpuDocumentApplier

        self.server = server
        self.plane = plane
        self.counters = counters
        self.device = device
        self.ckpt = os.path.join(state_dir, "applier")
        self.topic = f"deltas/{TENANT}/{DOC}"
        self.mesh_shards = mesh_shards
        self.applier = GpuDocumentApplier(**self._applier_kwargs(),
                                          **self.GEOMETRY)
        self.applier.set_replay_source(self._replay_from_log)
        self._offset = -1   # highest offset consumed
        self._handler = None
        self._subscribe(0)

    def _applier_kwargs(self) -> dict:
        kw = {"device": self.device}
        if self.mesh_shards:
            kw["mesh"] = self.mesh_shards
        return kw

    def _replay_from_log(self, tenant_id, document_id):
        """Escalation replay source reading the deltas LOG, not the
        scriptorium db: the log record is durable before any subscriber
        (scriptorium included) sees it, so this source can never lag the
        applier's own subscription the way a db-backed channel_stream can
        when this stage's handler is dispatched ahead of scriptorium's.
        Re-ticketed duplicate windows (orderer hard-crash) are deduped by
        sequence number."""
        topic = f"deltas/{tenant_id}/{document_id}"
        last = 0
        for off in range(self.server.log.length(topic)):
            value = self.server.log.read(topic, off)
            batch = value.get("boxcar")
            for m in (batch if batch is not None else [value["message"]]):
                if m.sequence_number <= last:
                    continue
                wire = _chan_contents(m)
                if wire is None:
                    continue
                last = m.sequence_number
                yield replace(m, contents=wire)

    def _subscribe(self, from_offset: int) -> None:
        def on_deltas(message):
            self._offset = message.offset
            value = message.value
            batch = value.get("boxcar")
            msgs = batch if batch is not None else [value["message"]]
            applied = self.applier.applied_seq(TENANT, DOC)
            pairs = []
            for m in msgs:
                # replay idempotency: the farm checkpoint lands before
                # the offset checkpoint, so a crash between them replays
                # already-applied ops — skip by sequence number
                if m.sequence_number <= applied:
                    continue
                wire = _chan_contents(m)
                if wire is not None:
                    pairs.append((m, wire))
            if pairs:
                self.applier.ingest_batch(TENANT, DOC, pairs)

        self._handler = on_deltas
        self.server.log.subscribe(self.topic, on_deltas,
                                  from_offset=from_offset)

    def checkpoint(self) -> None:
        from ..service.gpu_applier import save_applier_checkpoint

        # crash window 1: consumed but nothing saved
        self.plane("stage.pre_checkpoint", stage="DeviceStage")
        self.applier.flush()
        self.applier.finalize()
        save_applier_checkpoint(self.applier, self.ckpt)
        # crash window 2: farm saved, offsets not — restart replays a
        # window of already-applied ops against the NEWER farm
        self.plane("stage.post_checkpoint", stage="DeviceStage")
        with open(self.ckpt + ".off", "w") as f:
            json.dump({"offset": self._offset}, f)

    def restore(self) -> None:
        """The post-kill restart: reload the last durable farm + offset,
        re-subscribe; the replayed window is absorbed by skip-by-seq."""
        from ..service.gpu_applier import (
            GpuDocumentApplier,
            load_applier_checkpoint,
        )

        self.server.log.unsubscribe(self.topic, self._handler)
        if os.path.exists(self.ckpt + ".json"):
            self.applier = load_applier_checkpoint(self.ckpt,
                                                   **self._applier_kwargs())
        else:
            self.applier = GpuDocumentApplier(**self._applier_kwargs(),
                                              **self.GEOMETRY)
        self.applier.set_replay_source(self._replay_from_log)
        start = 0
        if os.path.exists(self.ckpt + ".off"):
            with open(self.ckpt + ".off") as f:
                start = json.load(f)["offset"] + 1
        self._offset = start - 1
        self._subscribe(start)
        self.counters.inc("chaos.recovered.stage_restart")

    def fingerprint(self) -> str:
        self.applier.finalize()
        text = self.applier.get_text(TENANT, DOC)
        props = [self.applier.get_properties_at(TENANT, DOC, i) or {}
                 for i in range(len(text))]
        return doc_fingerprint(text, props)


def _schedule_phase_a(plane: FaultPlane) -> None:
    def client_boxcar(ctx):
        return ctx["topic"].startswith("rawops/") \
            and type(ctx["record"]).__name__ == "RawBoxcar"

    def deltas(ctx):
        return ctx["topic"].startswith("deltas/")

    plane.rule("log.append", "torn", every=9, times=2, when=client_boxcar)
    plane.rule("log.append", "dup", every=13, times=2, when=client_boxcar)
    plane.rule("log.append", "rewind", every=11, times=2, when=deltas)
    plane.rule("broadcast.publish", "drop", every=10, times=2)
    plane.rule("broadcast.publish", "dup", every=7, times=2)
    plane.rule("applier.dispatch", "force_wide", at=1)
    # escalation late enough (ingest consult ~26 ≈ round 8 of quick's 10)
    # that the overlap-window crash rules below see the doc still on the
    # DEVICE lane — the earlier at=6 escalated the soak's single doc to
    # host in round 1 and starved every later dispatch seam
    plane.rule("applier.ingest", "escalate_host", at=26)
    plane.rule("stage.pre_checkpoint", "crash", at=3)
    plane.rule("stage.post_checkpoint", "crash", at=5)
    plane.rule("stage.crash", "orderer_hard", at=4)
    # overlap-window crashes, BOTH orders: "staged" kills the stage host
    # after wave N+1 is staged (device buffers resident, step not issued)
    # — restore must replay exactly that unexecuted wave; "inflight"
    # kills it after wave N's step is issued but before the next wave
    # stages — the restored farm reloads the last durable checkpoint and
    # skip-by-seq absorbs the already-applied window (no double-apply)
    plane.rule("applier.stage.staged", "crash", at=2)
    plane.rule("applier.stage.inflight", "crash", at=3)
    # crash-mid-fork, BOTH windows: "commit" kills after the pending
    # fork commit record lands but before the doc is seeded (recovery
    # must DISCARD — the fork doc does not exist); "seeded" kills after
    # seeding but before the ref flips (recovery must ADOPT — the doc
    # is durable, only the refs are missing). Either way no ref dangles.
    plane.rule("history.fork", "crash", at=1,
               when=lambda ctx: ctx.get("stage") == "commit")
    plane.rule("history.fork", "crash", at=1,
               when=lambda ctx: ctx.get("stage") == "seeded")


def run_phase_a(seed: int, counters: Counters, rounds: int = 24,
                n_clients: int = 3, recover: bool = True,
                break_dedupe: bool = False,
                mesh_shards: int = 0, device=None
                ) -> tuple[FaultPlane, InvariantMonitor]:
    from ..service.local_server import LocalServer

    monitor = InvariantMonitor(counters, dedupe=not break_dedupe)
    plane = FaultPlane(seed, counters)
    _schedule_phase_a(plane)

    server = LocalServer(auto_drain=False)
    monitor.attach(server.log, f"deltas/{TENANT}/{DOC}")
    uninstall = install(plane, server=server)
    try:
        with tempfile.TemporaryDirectory(prefix="chaos-soak-") as state_dir:
            device = DeviceStage(server, plane, counters, state_dir,
                                 device=device, mesh_shards=mesh_shards)
            install(plane, appliers=[device.applier])
            rng = random.Random(seed)
            clients = [SoakClient(server, monitor, counters,
                                  random.Random(seed * 1000 + i),
                                  recover=recover)
                       for i in range(n_clients)]
            server.drain()

            for rnd in range(rounds):
                for c in clients:
                    c.edit(1 + rng.randrange(2))
                server.drain()
                if plane("stage.crash", round=rnd) == "orderer_hard":
                    # kill -9 of the document pipeline BEFORE this
                    # round's checkpoint lands: the rebuilt deli replays
                    # the raw log from the previous checkpoint and
                    # re-tickets the whole round with identical seqs —
                    # every consumer must dedupe the duplicate window
                    server.crash_orderer(TENANT, DOC)
                    counters.inc("chaos.recovered.orderer_restart")
                    server.drain()
                try:
                    device.checkpoint()
                except SimulatedCrash:
                    device.restore()
                    server.drain()
                    # the freshly-armed restored applier keeps the seam
                    install(plane, appliers=[device.applier])
                server.checkpoint_all()
                if recover:
                    for c in clients:
                        if c.nacked:
                            c.reconnect()
                    server.drain()

            # crash-mid-fork drill: tear a fork at both windows and
            # require restart recovery to adopt-or-discard atomically
            _exercise_fork_crash(server, counters)

            # settle: stop injecting, resolve every open submission
            plane.disarm()
            for _ in range(6):
                server.drain()
                if all(c.settled for c in clients):
                    break
                if recover:
                    for c in clients:
                        if not c.settled:
                            c.reconnect()
            server.drain()
            for c in clients:
                c.catch_up()
            try:
                device.checkpoint()
            except SimulatedCrash:  # pragma: no cover - plane is disarmed
                device.restore()
                server.drain()

            fps = {f"client{i}": _replica_fingerprint(c.replica)
                   for i, c in enumerate(clients)}
            fps["device"] = device.fingerprint()
            fps["oracle"] = _oracle_fingerprint(server)
            monitor.check_quiescent(fps)
            if monitor.observed < 10:
                raise InvariantViolation(
                    f"phase A observed only {monitor.observed} sequenced "
                    "messages — the workload did not run")
    finally:
        uninstall()
    return plane, monitor


def _exercise_fork_crash(server, counters: Counters) -> None:
    """Tear a fork at BOTH crash windows (scheduled in
    ``_schedule_phase_a``), simulate the restart by rebuilding the
    history plane over the same durable records, and require recovery
    to adopt-or-discard atomically. A dangling ref — a fork commit no
    ref covers and no discard marker abandons — is an invariant
    violation, as is adopting an unseeded fork or discarding a seeded
    one."""
    from ..service.history_plane import (
        MAIN_REF,
        HistoryPlane,
        fork_pin_ref,
    )
    from ..service.service_summarizer import (
        HostReplicaSource,
        ServiceSummarizer,
    )

    # forks boot from committed generations: put one on the graph
    ServiceSummarizer(server, HostReplicaSource(server)).summarize_doc(
        TENANT, DOC)

    def torn_fork(new_doc: str) -> None:
        try:
            server.history.fork(TENANT, DOC, new_doc=new_doc)
        except SimulatedCrash:
            return
        raise InvariantViolation(
            f"scheduled crash-mid-fork of {new_doc} did not fire")

    # window 1: commit record written, doc NOT seeded → must discard
    torn_fork("soak-fork-torn")
    rebooted = HistoryPlane(server)  # the restart: fresh in-memory state
    fstore = rebooted._store(TENANT, "soak-fork-torn")
    pstore = rebooted._store(TENANT, DOC)
    dangling = [cid for cid in fstore.commits
                if cid not in set(fstore.refs.values())
                and cid not in fstore.discarded]
    if dangling:
        raise InvariantViolation(
            f"fork recovery left dangling commits {dangling}")
    if fstore.refs or fork_pin_ref(TENANT, "soak-fork-torn") in pstore.refs:
        raise InvariantViolation(
            "recovery adopted an UNSEEDED fork (refs exist for a doc "
            "with no durable v0)")
    counters.inc("chaos.recovered.history_recover")

    # window 2: doc seeded, refs NOT flipped → must adopt
    torn_fork("soak-fork-seeded")
    rebooted = HistoryPlane(server)
    fstore = rebooted._store(TENANT, "soak-fork-seeded")
    pstore = rebooted._store(TENANT, DOC)
    if MAIN_REF not in fstore.refs \
            or fork_pin_ref(TENANT, "soak-fork-seeded") not in pstore.refs:
        raise InvariantViolation(
            "recovery discarded a SEEDED fork (durable v0 exists but "
            "refs were not restored)")
    # the adopted fork must actually serve history reads post-restart
    head = fstore.commits[fstore.refs[MAIN_REF]]
    rebooted.replay_read(TENANT, "soak-fork-seeded", head["base_seq"])
    counters.inc("chaos.recovered.history_recover")


def _oracle_fingerprint(server) -> str:
    """Replay the authoritative sequenced log into a fresh replica — the
    from-scratch consumer every other replica must agree with."""
    from ..service.gpu_applier import channel_stream

    oracle = MergeTreeClient("chaos/oracle")
    for m in channel_stream(server, TENANT, DOC, DS_ID, CHANNEL_ID):
        oracle.apply_msg(m, local=False)
    return _replica_fingerprint(oracle)


def _check_coverage(plane: FaultPlane) -> dict[str, int]:
    by_class = plane.injected_by_class()
    missing = [cls for cls in BOUNDARY_REQUIRED if not by_class.get(cls)]
    if missing:
        raise InvariantViolation(
            f"boundary coverage incomplete: no fault injected for "
            f"{missing}; got {by_class}")
    return by_class


def _cross_check(counters: Counters) -> None:
    """Faults injected must show matching recoveries in telemetry — an
    injection point nobody recovers from is a silent hole."""
    snap = counters.snapshot()

    def count(prefix):
        return sum(v for k, v in snap.items()
                   if k.startswith(prefix) and isinstance(v, int))

    expectations = [
        # a rawops tear loses the record: the client reconnects and
        # resubmits (the columnar segment tear of phase B untears instead)
        ("chaos.injected.log.append.torn", "chaos.recovered.reconnect"),
        ("chaos.injected.log.append.rewind",
         "chaos.recovered.monitor_dedup"),
        ("chaos.injected.broadcast.publish.drop",
         "chaos.recovered.gap_repair"),
        ("chaos.injected.broadcast.publish.dup",
         "chaos.recovered.client_dedup"),
        ("chaos.injected.stage.pre_checkpoint",
         "chaos.recovered.stage_restart"),
        ("chaos.injected.stage.post_checkpoint",
         "chaos.recovered.stage_restart"),
        # overlap-window crashes (both orders) recover through the same
        # checkpoint+replay restart path — dropping either seam or its
        # recovery would open a silent hole in the stage/execute split
        ("chaos.injected.applier.stage.staged",
         "chaos.recovered.stage_restart"),
        ("chaos.injected.applier.stage.inflight",
         "chaos.recovered.stage_restart"),
        ("chaos.injected.stage.crash", "chaos.recovered.orderer_restart"),
        # a crash mid-fork (either window) recovers through the history
        # plane's adopt-or-discard pass on the next load
        ("chaos.injected.history.fork.crash",
         "chaos.recovered.history_recover"),
    ]
    problems = []
    for injected, recovered in expectations:
        if count(injected) > 0 and not count(recovered):
            problems.append(f"{injected}={count(injected)} but "
                            f"{recovered}=0")
    if problems:
        raise InvariantViolation(
            "faults injected without observed recoveries: "
            + "; ".join(problems))


def run_soak(seed: int, quick: bool = False, break_dedupe: bool = False,
             no_recover: bool = False, phases: str = "a",
             mesh_shards: int = 0, device=None) -> dict:
    """Run the campaign's phase A on ``device`` (the stage's applier;
    ``cuda`` when None; over a mesh of ``mesh_shards`` docs shards when
    nonzero) and return its result; raises
    :class:`InvariantViolation` on any failure."""
    if "b" in phases:
        raise NotImplementedError(
            "soak phase B (socket clients, relay gateway, snapshot plane) "
            "is not ported to fluidframework_tpu_torch yet (ROADMAP A8)")
    counters = tier_counters("chaos")
    plane, monitor = run_phase_a(
        seed, counters,
        rounds=10 if quick else 24,
        recover=not no_recover, break_dedupe=break_dedupe,
        mesh_shards=mesh_shards, device=device)
    coverage = _check_coverage(plane)
    _cross_check(counters)
    flight_dump = _check_flight_dump(counters)
    return {
        "seed": seed,
        "coverage": coverage,
        "observed": monitor.observed,
        "redelivered": monitor.redelivered,
        "flight_dump": flight_dump,
        "counters": {k: v for k, v in sorted(counters.snapshot().items())
                     if k.startswith("chaos.")},
    }


def _check_flight_dump(counters: Counters) -> Optional[str]:
    """Phase A injects an orderer crash (stage.crash → orderer_hard); the
    crash path must have dumped the flight recorder, and the dump's tail
    must carry the telemetry preceding the crash — a dump that exists but
    is empty would be a recorder that armed too late to matter."""
    if counters.snapshot().get(
            "chaos.injected.stage.crash.orderer_hard", 0) == 0:
        return None
    path = get_recorder().last_dump
    if path is None or not os.path.exists(path):
        raise InvariantViolation(
            "orderer crash injected but no flight-recorder dump written")
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    header = json.loads(lines[0]) if lines else {}
    if header.get("flight") != "orderer_crash" or len(lines) < 2:
        raise InvariantViolation(
            f"flight dump {path} missing the pre-crash telemetry tail "
            f"(header={header.get('flight')}, lines={len(lines)})")
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="deterministic chaos soak, phase A")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="shorter campaign (CI smoke)")
    parser.add_argument("--phases", default="a", choices=["a"],
                        help="phase B is not ported yet")
    parser.add_argument("--device", default=None,
                        help="the device stage's device (default cuda)")
    parser.add_argument("--mesh-shards", type=int, default=0,
                        help="run phase A's applier stage over a "
                             "doc-sharded mesh of this many shards (all on "
                             "--device when given, else one a card)")
    parser.add_argument("--break-dedupe", action="store_true",
                        help="self-test: disable the monitor's seq dedupe "
                             "(the soak MUST fail)")
    parser.add_argument("--no-recover", action="store_true",
                        help="self-test: clients never resubmit "
                             "(the soak MUST fail)")
    args = parser.parse_args(argv)
    try:
        result = run_soak(args.seed, quick=args.quick,
                          break_dedupe=args.break_dedupe,
                          no_recover=args.no_recover, phases=args.phases,
                          mesh_shards=args.mesh_shards, device=args.device)
    except InvariantViolation as e:
        # attach the flight-recorder dump (if one fired) so the failure
        # report carries the telemetry that preceded the trigger
        dump = get_recorder().last_dump
        where = f"\n  flight recorder: {dump}" if dump else ""
        print(f"SOAK FAILED (seed {args.seed}): {e}{where}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
