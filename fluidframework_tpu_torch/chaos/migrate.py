"""Chaos migration campaign: crash the source core mid-migration.

JAX counterpart: ``fluidframework_tpu/chaos/migrate.py``; the port's copy
of the live-migration campaign, imports rebased to this package.

``python -m fluidframework_tpu_torch.chaos.migrate --seed N`` runs a seeded
in-proc campaign against the placement control plane
(service/placement_plane.py): two doc partitions in one shard dir,
multiple ShardHost "cores" with a short lease TTL, seeded merge-tree
clients editing through whichever core owns their partition, and a
scripted sequence of live migrations where the source core is killed at
each of the engine's crash windows:

- ``placement.pre_fence``   — before the seal: the migration simply
  never happened; the lease goes stale and the target takes the
  partition over on its poll (the single-core kill -9 restart path).
- ``placement.pre_handoff`` — after seal + fence + checkpoint, before
  the lease moved: same takeover recovery, but the target resumes from
  the freshly shipped checkpoint.
- ``placement.post_handoff`` — after the atomic lease transfer: the
  target already owns the log; the dead source merely fails to push the
  route flip and clients discover the new owner via reconnect.

A "kill" abandons the source host object without closing its logs or
releasing its leases — the in-proc stand-in for kill -9. After every
crash the campaign also proves the fence: the zombie source's partition
server must refuse a new connect (lease-freshness clock / seal /
revocation), so a doc mid-migration is never sequenced by two cores.

The run ends with one clean (uncrashed) migration under live traffic —
the partition-1 control client must not be disturbed by it — then
settles and replays the ENTIRE multi-owner durable log from offset 0
through an :class:`InvariantMonitor`: no sequence gap, no duplicate, no
lost or double-resolved submission, and every client replica converges
to the log-replay oracle fingerprint. Same seed ⇒ same edit streams and
the same crash points. Exit 1 on any violation.
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
import sys
import tempfile
import time
from typing import Callable, Optional

from ..mergetree.client import MergeTreeClient
from ..obs import tier_counters
from ..mergetree.ops import op_to_wire
from ..utils.telemetry import Counters
from .monitor import InvariantMonitor, InvariantViolation
from .plane import FaultPlane, SimulatedCrash
from .soak import (CHANNEL_ID, DS_ID, _chan_contents, _chan_msg,
                   _replica_fingerprint)

TENANT = "chaos"

#: lease TTL for the campaign cores — short, so takeover of a killed
#: source completes in well under a second
TTL = 0.5

#: the engine's crash windows, in protocol order
SEAMS = ("pre_fence", "pre_handoff", "post_handoff")


def _doc_for_partition(k: int, n: int) -> str:
    """Smallest ``mig<i>`` doc id that hashes onto partition ``k``."""
    from ..service.stage_runner import doc_partition

    i = 0
    while True:
        doc = f"mig{i}"
        if doc_partition(TENANT, doc, n) == k:
            return doc
        i += 1


class MigrateClient:
    """A SoakClient variant that follows its doc across cores.

    ``resolve()`` returns the live owner's LocalServer for the doc's
    partition (or None mid-takeover); a submit refused by a sealed,
    revoked, or lease-stale server marks the client severed, and the
    next quiescent :meth:`reconnect` rejoins the current owner, rebases
    the pending ops, and resubmits them in client-sequence order.
    """

    def __init__(self, doc: str, resolve: Callable, monitor: InvariantMonitor,
                 counters: Counters, rng: random.Random):
        self.doc = doc
        self.resolve = resolve
        self.monitor = monitor
        self.counters = counters
        self.rng = rng
        self.replica: Optional[MergeTreeClient] = None
        self.server = None
        self.conn = None
        self.cseq = 0
        self.last_seq = 0
        self.nacked = False
        self.severed = False
        self.unresolved: list[int] = []  # this incarnation's open cseqs
        self.reconnects = 0

    # ---------------------------------------------------------- lifecycle

    def connect(self) -> bool:
        server = self.resolve()
        if server is None:
            return False
        try:
            conn = server.connect(TENANT, self.doc)
        except RuntimeError:
            return False  # sealed / fenced: the owner is still flipping
        self.server = server
        self.conn = conn
        if self.replica is None:
            self.replica = MergeTreeClient(conn.client_id)
        else:
            self.replica.update_client_id(conn.client_id)
        self.cseq = 0
        self.nacked = False
        self.severed = False
        self.unresolved = []
        conn.on_ops = self._on_ops
        conn.on_nack = self._on_nack
        return True

    def sever(self) -> None:
        """The connection died under us (core crash / session drop):
        abandon this incarnation's open submissions — the reconnect
        resubmits their effect under the next one."""
        if self.conn is None:
            return
        old_id = self.conn.client_id
        try:
            self.conn.disconnect()
        except RuntimeError:
            pass  # dead/sealed core: the leave can't be sequenced
        self.conn = None
        for cseq in self.unresolved:
            self.monitor.note_resubmitted(old_id, cseq)
        self.unresolved = []
        self.severed = True

    def reconnect(self) -> bool:
        """Call at drain quiescence: rejoin the CURRENT owner, catch up
        on the seqs this replica missed, rebase + resubmit pending ops."""
        self.sever()
        if not self.connect():
            return False  # no live owner yet (mid-takeover): retry later
        self.reconnects += 1
        self.counters.inc("chaos.recovered.reconnect")
        self.catch_up()
        for op in self.replica.regenerate_pending_ops():
            self._submit_wire(op_to_wire(op))
        return True

    def catch_up(self) -> None:
        missed = self.server.get_deltas(TENANT, self.doc,
                                        self.last_seq, 10 ** 9)
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
                self.counters.inc("chaos.recovered.client_dedup")
                continue
            if seq > self.last_seq + 1:
                self.counters.inc("chaos.recovered.gap_repair")
                for g in self.server.get_deltas(TENANT, self.doc,
                                                self.last_seq, seq):
                    if g.sequence_number > self.last_seq:
                        self._apply(g)
            self._apply(m)

    def _apply(self, m) -> None:
        from dataclasses import replace

        self.last_seq = m.sequence_number
        wire = _chan_contents(m)
        if wire is not None:
            if self.replica.is_own_message(m.client_id):
                self.unresolved = [c for c in self.unresolved
                                   if c != m.client_sequence_number]
            self.replica.apply_msg(replace(m, contents=wire))
        else:
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
        try:
            self.conn.submit([_chan_msg(
                self.cseq, self.replica.tree.current_seq, wire_op)])
        except RuntimeError:
            # sealed / revoked / lease-stale: the op stays pending in the
            # replica; the quiescent reconnect rebases + resubmits it
            self.counters.inc("chaos.recovered.migrate_bounce")
            self.sever()

    def edit(self, n_ops: int) -> None:
        if self.conn is None or self.nacked or self.severed:
            return  # wedged until the next quiescent reconnect
        rng = self.rng
        pool = "abcdefgh" * 4
        for _ in range(n_ops):
            if self.severed:
                return
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
                text = pool[off:off + 1 + rng.randrange(6)]
                op = self.replica.insert_text_local(
                    rng.randrange(length + 1), text)
            self._submit_wire(op_to_wire(op))

    @property
    def settled(self) -> bool:
        return (self.conn is not None and not self.severed
                and not self.unresolved and not self.nacked
                and not self.replica.pending)


def _log_fingerprint(server, doc: str) -> str:
    """Replay the authoritative sequenced log (all owners' appends) into
    a fresh replica — the oracle every client must agree with."""
    from ..service.gpu_applier import channel_stream

    oracle = MergeTreeClient("chaos/migrate-oracle")
    for m in channel_stream(server, TENANT, doc, DS_ID, CHANNEL_ID):
        oracle.apply_msg(m, local=False)
    return _replica_fingerprint(oracle)


def run_campaign(seed: int, counters: Counters,
                 quick: bool = False) -> dict:
    from ..service.front_end import ShardHost
    from ..service.placement_plane import EpochTable, MigrationEngine

    plane = FaultPlane(seed, counters)
    rng = random.Random(seed)
    scenarios = (["pre_handoff", None] if quick
                 else list(SEAMS) + [None])
    # campaign-held placement Counters: the process-global tier sum is
    # a weak aggregate (instances die with their owners), so the verdict
    # reads an instance IT holds, wired into every table/engine below
    pc = tier_counters("placement")
    shard_dir = tempfile.mkdtemp(prefix="chaos-migrate-")
    n = 2
    hosts: list = []
    dead: set = set()  # id() of killed hosts — abandoned, never closed
    try:
        doc0 = _doc_for_partition(0, n)
        doc1 = _doc_for_partition(1, n)
        table = EpochTable.for_shard_dir(shard_dir)

        def spawn(prefer=()) -> ShardHost:
            h = ShardHost(shard_dir, n, prefer=prefer, ttl_s=TTL)
            h.address = f"inproc/{h.owner_id}"
            h.table.counters = pc
            hosts.append(h)
            h.poll()
            return h

        def alive() -> list:
            return [h for h in hosts if id(h) not in dead]

        def owner_server(k: int):
            for h in alive():
                s = h.servers.get(k)
                if s is not None and not s.sealed:
                    return s
            return None

        def drain_alive() -> None:
            for h in alive():
                for s in list(h.servers.values()):
                    s.drain()

        def poll_alive() -> None:
            for h in alive():
                h.poll()

        def await_owner(k: int, timeout: float = 15.0):
            """Lease-TTL takeover: poll the survivors until one owns k."""
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                poll_alive()
                s = owner_server(k)
                if s is not None:
                    return s
                time.sleep(0.05)
            raise InvariantViolation(
                f"no live owner for partition {k} within {timeout}s of "
                "the source crash — lease takeover did not happen")

        src0 = spawn(prefer=(0, 1))
        spawn()  # standby: claims only by takeover / adoption
        if 0 not in src0.servers or 1 not in src0.servers:
            raise InvariantViolation("preferring core failed to claim")

        mon0 = InvariantMonitor(counters)
        mon1 = InvariantMonitor(counters)
        clients = [MigrateClient(doc0, lambda: owner_server(0), mon0,
                                 counters, random.Random(seed * 1000 + i))
                   for i in range(3)]
        control = MigrateClient(doc1, lambda: owner_server(1), mon1,
                                counters, random.Random(seed * 1000 + 99))
        for c in clients + [control]:
            if not c.connect():
                raise InvariantViolation("initial connect failed")
        drain_alive()

        def rounds(nr: int) -> None:
            for _ in range(nr):
                for c in clients:
                    c.edit(1 + rng.randrange(2))
                control.edit(1)
                drain_alive()
                poll_alive()
                for c in clients + [control]:
                    if c.conn is None or c.severed or c.nacked:
                        c.reconnect()
                drain_alive()

        recoveries = 0
        epochs_seen = [table.global_epoch()]
        for scen in scenarios:
            rounds(4)
            src = next(h for h in alive() if 0 in h.servers)
            tgt = next(h for h in alive() if h is not src)
            eng_src = MigrationEngine(src, counters=pc)
            eng_tgt = MigrationEngine(tgt, counters=pc)
            eng_src.fault_plane = plane
            zombie = src.servers.get(0)
            if scen is None:
                # the clean migration: seal → fence → checkpoint →
                # atomic handoff; partition 1's control client must not
                # notice
                control_reconnects = control.reconnects
                eng_src.migrate(
                    0, tgt.address,
                    adopt=lambda k, addr: eng_tgt.adopt(k, src.owner_id))
                rounds(3)
                if control.reconnects != control_reconnects:
                    raise InvariantViolation(
                        "partition-1 control client was disturbed by the "
                        "partition-0 migration")
            else:
                plane.rule(f"placement.{scen}", "crash", at=1)
                try:
                    eng_src.migrate(
                        0, tgt.address,
                        adopt=lambda k, addr: eng_tgt.adopt(
                            k, src.owner_id))
                except SimulatedCrash:
                    pass
                else:
                    raise InvariantViolation(
                        f"scheduled crash at placement.{scen} never fired")
                # kill -9: abandon the source — leases unreleased, logs
                # unclosed, no flip pushed. Its sockets die with it, so
                # every client on it is severed.
                dead.add(id(src))
                for c in clients + [control]:
                    if c.server is not None and (
                            c.server is zombie or id_owner(c.server, src)):
                        c.sever()
                await_owner(0)
                await_owner(1)
                # fencing proof: the zombie source (still resident
                # in-proc) must refuse orders — seal, revocation, or the
                # lease-freshness clock, whichever fired first
                if zombie is not None:
                    try:
                        zombie.connect(TENANT, doc0)
                    except RuntimeError:
                        counters.inc("chaos.recovered.zombie_fenced")
                    else:
                        raise InvariantViolation(
                            "zombie source accepted a connect after the "
                            "takeover — two cores could sequence the doc")
                spawn()  # replacement core: keep two alive
                recoveries += 1
            for _ in range(100):
                if all(c.conn is not None for c in clients + [control]):
                    break
                poll_alive()
                for c in clients + [control]:
                    if c.conn is None:
                        c.reconnect()
                drain_alive()
                time.sleep(0.02)
            rounds(2)
            ep = table.global_epoch()
            if ep <= epochs_seen[-1]:
                raise InvariantViolation(
                    f"table epoch did not advance across the migration "
                    f"({epochs_seen[-1]} → {ep})")
            epochs_seen.append(ep)

        # settle: stop injecting, resolve every open submission
        plane.disarm()
        for _ in range(20):
            drain_alive()
            poll_alive()
            if all(c.settled for c in clients) and control.settled:
                break
            for c in clients + [control]:
                if not c.settled:
                    c.reconnect()
            time.sleep(0.02)
        drain_alive()
        for c in clients + [control]:
            if c.conn is not None:
                c.catch_up()

        final0 = owner_server(0)
        final1 = owner_server(1)
        if final0 is None or final1 is None:
            raise InvariantViolation("no live owner at quiescence")

        # the verdict: replay the WHOLE multi-owner history from offset 0
        # — seq contiguity and dedupe across every owner change — and
        # check every replica against the log-replay oracle
        mon0.attach(final0.log, f"deltas/{TENANT}/{doc0}")
        final0.drain()
        mon1.attach(final1.log, f"deltas/{TENANT}/{doc1}")
        final1.drain()
        fps = {f"client{i}": _replica_fingerprint(c.replica)
               for i, c in enumerate(clients)}
        fps["oracle"] = _log_fingerprint(final0, doc0)
        mon0.check_quiescent(fps)
        mon1.check_quiescent({
            "control": _replica_fingerprint(control.replica),
            "oracle": _log_fingerprint(final1, doc1)})
        if mon0.observed < 20:
            raise InvariantViolation(
                f"observed only {mon0.observed} sequenced messages — the "
                "workload did not run")

        # coverage + recovery cross-check
        hit = {p for p, _, _ in plane.injected}
        want = {f"placement.{s}" for s in scenarios if s}
        if not want <= hit:
            raise InvariantViolation(
                f"missing crash coverage: {sorted(want - hit)}")
        delta = {k: v for k, v in pc.snapshot().items() if v}
        if delta.get("placement.migration.committed", 0) < 1:
            raise InvariantViolation("no clean migration committed")
        if delta.get("placement.migration.adopted", 0) < 1:
            raise InvariantViolation("no adoption recorded")
        if delta.get("placement.epoch.bumps", 0) < len(scenarios):
            raise InvariantViolation("epoch did not bump per ownership "
                                     "change")
        snap = counters.snapshot()
        if recoveries and snap.get("chaos.recovered.reconnect", 0) == 0:
            raise InvariantViolation("source crashes injected but no "
                                     "client reconnect recovery observed")
        if recoveries and snap.get(
                "chaos.recovered.zombie_fenced", 0) < recoveries:
            raise InvariantViolation("a crashed source was never probed "
                                     "for fencing")

        return {
            "seed": seed,
            "quick": quick,
            "scenarios": [s or "clean" for s in scenarios],
            "recoveries": recoveries,
            "reconnects": (sum(c.reconnects for c in clients)
                           + control.reconnects),
            "sequenced": {"doc0": mon0.observed, "doc1": mon1.observed},
            "epochs": epochs_seen,
            "placement": dict(sorted(delta.items())),
            "counters": {k: v for k, v in sorted(snap.items())
                         if k.startswith("chaos.")},
        }
    finally:
        for h in hosts:
            for s in list(h.servers.values()):
                try:
                    s.log.close()
                except Exception:
                    pass
        shutil.rmtree(shard_dir, ignore_errors=True)


def id_owner(server, host) -> bool:
    """Is ``server`` one of ``host``'s partition servers?"""
    return any(s is server for s in host.servers.values())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chaos migration campaign: crash the source core at "
                    "each migration seam (tier-1 entry point)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="one crash scenario + the clean migration "
                             "(CI smoke)")
    args = parser.parse_args(argv)
    counters = tier_counters("chaos")
    try:
        result = run_campaign(args.seed, counters, quick=args.quick)
    except InvariantViolation as e:
        print(f"MIGRATION CAMPAIGN FAILED (seed {args.seed}): {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
