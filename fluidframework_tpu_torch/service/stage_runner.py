"""Per-stage service processes over the shared durable log.

JAX counterpart: ``fluidframework_tpu/service/stage_runner.py``; the
port's copy, imports rebased to this package. ``ApplierStage`` runs the
port's ``GpuDocumentApplier`` on the device it is given (``cuda`` unless
the caller passes another; ``--device`` on the command line).

Ref: the reference deploys each pipeline lambda as its own service
process connected only by the Kafka log — alfred/deli/scribe/…
each have a www.ts entrypoint run by the kafka-service runner
(server/routerlicious/packages/routerlicious/src/*/www.ts,
lambdas-driver/src/kafka-service/runner.ts:13, docker-compose.yml).

Here the shared medium is the native C++ op log (csrc/oplog.cpp): the
CORE process (any ``LocalServer`` over a ``DurableLog``) is the single
writer of the rawops/deltas topics and flushes appends into the page
cache (a reader sees only what the writer has flushed); each
stage process opens the same directory READ-ONLY and tails it
(DurableLog.poll). Stage → core communication rides the stage's own
writable log directory (its "backchannel"), which the core polls — every
topic keeps exactly one writer, so no cross-process file locking exists
anywhere.

Stages:

- ``scribe``  — the summary validator/acker (ScribeLambda) out of
  process. Consumes deltas + upload announcements; emits summary
  ack/nack raw messages, version commits, and retention advances on the
  backchannel. Checkpoints its protocol replica + offsets to its own
  log; kill -9 and restart resumes from the checkpoint (deltas replay is
  idempotent by sequence number).
- ``applier`` — the device farm (GpuDocumentApplier) out of
  process: the deli/broadcast hot path never shares a GIL with device
  work. Consumes deltas chanops, checkpoints the device farm
  (save_applier_checkpoint) periodically, and reports per-doc applied
  seqs on its backchannel as status records.

Deployment:

    python -m fluidframework_tpu_torch.service.stage_runner \
        --stage applier --log-dir LOG --state-dir STATE [--device cuda]

The command line builds an ``ApplierStage`` of the class's default
geometry (64 docs); a farm of another size constructs
``ApplierStage(log_dir, state_dir, max_docs=..., max_slots=...)`` itself
and calls ``run_forever``. It prints ``READY`` once it polls.
"""

from __future__ import annotations

import argparse
import os
import signal
import time
from typing import Optional

from ..device import resolve_device
from ..protocol.messages import MessageType
from .core import InMemoryDb, summary_versions_collection
from .durable_log import DurableLog

BACKCHANNEL_TOPIC = "backchannel"
POLL_INTERVAL_S = 0.002


def _doc_of(topic: str) -> tuple[str, str]:
    _, tenant, doc = topic.split("/", 2)
    return tenant, doc


def doc_partition(tenant: str, doc: str, n_partitions: int) -> int:
    """Stable doc → partition map (ref: the Kafka partition-by-docId
    routing, lambdas-driver document-router). md5, NOT hash(): python
    randomizes hash() per process, and every stage process must agree."""
    import hashlib

    digest = hashlib.md5(f"{tenant}/{doc}".encode()).digest()
    return int.from_bytes(digest[:4], "big") % n_partitions


class _StageHostBase:
    """Discovery + poll/drain/checkpoint loop shared by the stages."""

    #: deltas topics are the stage input; uploads only matter to scribe
    topic_prefixes = ("deltas/",)

    #: chaos seam (duck-typed fault plane): crash-window faults. The
    #: plane raises SimulatedCrash from inside the checkpoint sequence —
    #: between consume and farm save ("stage.pre_checkpoint") or between
    #: farm save and the offset/emit records ("stage.post_checkpoint") —
    #: the two windows whose replay/idempotency story must hold on a real
    #: kill -9. None = disarmed, one branch per checkpoint.
    fault_plane = None

    def _fault(self, point: str, **ctx) -> None:
        if self.fault_plane is not None:
            self.fault_plane(point, stage=type(self).__name__, **ctx)

    def __init__(self, log_dir: str, state_dir: str,
                 partition: Optional[tuple] = None):
        self.shared = DurableLog(log_dir, readonly=True)
        self.state = DurableLog(state_dir)
        # (k, n): this process owns docs with doc_partition(...) == k —
        # N stage processes split the doc space; a redeploy with a
        # different split MOVES docs between processes (the new owner
        # resumes from its checkpoints, or replays from 0 for a doc it
        # never owned)
        self.partition = partition
        self._known: set[str] = set()
        self._last_checkpoint = time.monotonic()
        self.checkpoint_every_s = 1.0

    def _owns(self, topic: str) -> bool:
        if self.partition is None:
            return True
        tenant, doc = _doc_of(topic)
        k, n = self.partition
        return doc_partition(tenant, doc, n) == k

    # ------------------------------------------------------------- plumbing

    def emit(self, record: dict) -> None:
        self.state.append(BACKCHANNEL_TOPIC, record)

    def _cp_topic(self, tenant: str, doc: str) -> str:
        return f"cp/{tenant}/{doc}"

    def load_checkpoint(self, tenant: str, doc: str) -> Optional[dict]:
        topic = self._cp_topic(tenant, doc)
        n = self.state.length(topic)
        return self.state.read(topic, n - 1) if n > 0 else None

    def save_checkpoint(self, tenant: str, doc: str, state: dict) -> None:
        self.state.append(self._cp_topic(tenant, doc), state)

    def discover(self) -> None:
        for prefix in self.topic_prefixes:
            for topic in self.shared.list_topics(prefix):
                if topic not in self._known:
                    self._known.add(topic)
                    if self._owns(topic):
                        self.attach(topic)

    # -------------------------------------------------- deterministic ctl
    # Cross-process stepping (the OpProcessingController
    # role, opProcessingController.ts:16, extended across the process
    # boundary): a controller writes ``<state_dir>/ctl.json`` with
    # {"mode": "pause"|"run", "steps": N} and this stage consumes AT
    # MOST N records total while paused — so a composition bug
    # reproduces op-by-op, each step observable through the backchannel.

    def _read_ctl(self) -> None:
        import json
        import os

        path = os.path.join(self.state.directory, "ctl.json")
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return
        if mtime == self._ctl_mtime:
            return
        self._ctl_mtime = mtime
        try:
            with open(path) as f:
                self._ctl = json.load(f)
        except (OSError, ValueError):
            pass

    def _step_once(self) -> bool:
        """Deliver exactly ONE pending record (first lagging topic in
        subscription order). Returns False when fully drained."""
        for topic in list(self.shared._order):
            if self.shared.step(topic):
                return True
        return False

    def run_forever(self) -> None:
        print("READY", flush=True)
        last_discover = 0.0
        self._ctl = {"mode": "run"}
        self._ctl_mtime = None
        self._steps_done = 0
        while True:
            now = time.monotonic()
            if now - last_discover >= 0.25:  # listdir is not free at 2ms
                last_discover = now
                self.discover()
                self._read_ctl()
            moved = self.shared.poll()
            if self._ctl.get("mode") != "pause":
                # leaving (or never entering) a pause episode resets the
                # step ledger: each pause session's budget counts from 0,
                # not from the lifetime total of earlier sessions
                self._steps_done = 0
            if self._ctl.get("mode") == "pause":
                self._read_ctl()
                budget = int(self._ctl.get("steps", 0))
                stepped = False
                while self._steps_done < budget and self._step_once():
                    self._steps_done += 1
                    stepped = True
                if stepped:
                    self.checkpoint()
                    self.state.flush()
                time.sleep(0.01)
                continue
            if moved:
                self.shared.drain()
            now = time.monotonic()
            if now - self._last_checkpoint >= self.checkpoint_every_s:
                self._last_checkpoint = now
                self.checkpoint()
            self.state.flush()
            if not moved:
                time.sleep(POLL_INTERVAL_S)

    def run_once(self) -> bool:
        """ONE deterministic iteration of the run_forever loop body:
        discover, poll, drain, checkpoint, flush. Lets a driver (the
        chaos soak, a test) step a stage in-process and catch a
        SimulatedCrash exactly at the armed window. Returns whether the
        poll found new records."""
        self.discover()
        moved = self.shared.poll()
        if moved:
            self.shared.drain()
        self.checkpoint()
        self.state.flush()
        return moved

    # ------------------------------------------------------------ per-stage

    def attach(self, topic: str) -> None:
        raise NotImplementedError

    def checkpoint(self) -> None:
        pass


class ScribeStage(_StageHostBase):
    """ScribeLambda per doc, out of process (scribe/lambda.ts role)."""

    # uploads BEFORE deltas: an upload announcement always precedes its
    # SUMMARIZE op on disk (the core appends + flushes it during the
    # storage RPC, before the client can submit), and poll marks dirty /
    # drain delivers in SUBSCRIPTION order — so as long as the doc's
    # uploads topic is subscribed before its deltas topic, validation
    # never sees a summarize whose upload record it hasn't ingested.
    # attach() enforces that order by eagerly subscribing the uploads
    # topic when the deltas topic appears (the uploads topic is usually
    # created on disk much later — first upload — and discovery alone
    # would subscribe it AFTER deltas, racing any summarize that lands
    # in the same poll window as its upload)
    topic_prefixes = ("uploads/", "deltas/")

    def __init__(self, log_dir: str, state_dir: str,
                 partition=None):
        super().__init__(log_dir, state_dir, partition=partition)
        self.db = InMemoryDb()
        self.scribes: dict[str, object] = {}  # "tenant/doc" → ScribeLambda

    def _scribe_for(self, tenant: str, doc: str):
        from .scribe import ScribeLambda

        key = f"{tenant}/{doc}"
        scribe = self.scribes.get(key)
        if scribe is None:
            cp = self.load_checkpoint(tenant, doc)

            def send_raw(raw, tenant=tenant, doc=doc):
                # summary ack/nack → core orders it into the stream
                self.emit({"kind": "raw", "tenant": tenant, "doc": doc,
                           "raw": raw})

            def persist_version(handle, version, tenant=tenant, doc=doc):
                self.emit({"kind": "version", "tenant": tenant, "doc": doc,
                           "handle": handle, "version": dict(version)})

            def on_committed(capture_seq, tenant=tenant, doc=doc):
                self.emit({"kind": "retention", "tenant": tenant,
                           "doc": doc, "capture_seq": capture_seq})

            scribe = self.scribes[key] = ScribeLambda(
                tenant, doc, self.db,
                send_to_deli=send_raw,
                checkpoint=cp["scribe"] if cp else None,
                on_summary_committed=on_committed,
                persist_version=persist_version,
            )
        return scribe

    def attach(self, topic: str) -> None:
        tenant, doc = _doc_of(topic)
        scribe = self._scribe_for(tenant, doc)
        if topic.startswith("deltas/"):
            # subscribe the doc's uploads topic FIRST (see class comment)
            up_topic = f"uploads/{tenant}/{doc}"
            if up_topic not in self._known:
                self._known.add(up_topic)
                self.attach(up_topic)
            cp = self.load_checkpoint(tenant, doc)
            start = cp["deltas_offset"] + 1 if cp else 0
            self.shared.subscribe(topic, scribe.handler, from_offset=start)
        else:  # uploads/: version records announced by the core

            def on_upload(message, col=summary_versions_collection(
                    tenant, doc)):
                rec = message.value
                self.db.upsert(col, rec["version_id"], dict(rec["record"]))

            self.shared.subscribe(topic, on_upload, from_offset=0)

    def checkpoint(self) -> None:
        # crash window: records consumed, checkpoint not yet written —
        # a restart replays the window (scribe replay is seq-idempotent)
        self._fault("stage.pre_checkpoint")
        for key, scribe in self.scribes.items():
            tenant, doc = key.split("/", 1)
            self.save_checkpoint(tenant, doc, {
                "scribe": scribe.checkpoint_state(),
                "deltas_offset": scribe.last_offset,
            })


class ApplierStage(_StageHostBase):
    """GpuDocumentApplier out of process: device work off the core GIL.
    ``device`` defaults to ``cuda`` and raises without a card."""

    def __init__(self, log_dir: str, state_dir: str,
                 max_docs: int = 64, max_slots: int = 256,
                 ds_id: str = "default", channel_id: str = "text",
                 partition=None, device=None):
        from .gpu_applier import GpuDocumentApplier, load_applier_checkpoint

        # the device is resolved before any log is opened: no card, no
        # stage
        device = resolve_device(device)
        super().__init__(log_dir, state_dir, partition=partition)
        self.ds_id, self.channel_id = ds_id, channel_id
        ckpt = os.path.join(state_dir, "applier")
        if os.path.exists(ckpt + ".json"):
            self.applier = load_applier_checkpoint(ckpt, device=device)
        else:
            self.applier = GpuDocumentApplier(max_docs=max_docs,
                                              max_slots=max_slots,
                                              device=device)
        self.applier.set_replay_source(lambda t, d: [])
        self._ckpt_path = ckpt
        # the costs of the newest farm save (save_applier_checkpoint)
        self.last_save: Optional[dict] = None
        self._offsets: dict[str, int] = {}
        # highest sequence number CONSUMED per topic (the consumer-group
        # offset semantic): the stream tail includes messages the applier
        # skips (joins, summarize/ack, other channels), and "caught up"
        # must mean consumed-through-tail, not merely
        # last-applicable-op-applied — otherwise a stream ending in a
        # summary ack reads as forever lagging
        self._watermarks: dict[str, int] = {}

    def attach(self, topic: str) -> None:
        tenant, doc = _doc_of(topic)
        cp = self.load_checkpoint(tenant, doc)
        start = cp["offset"] + 1 if cp else 0

        def on_deltas(message, tenant=tenant, doc=doc, topic=topic):
            self._offsets[topic] = message.offset
            value = message.value
            abatch = value.get("abatch")
            if abatch is not None:
                self._watermarks[topic] = max(
                    self._watermarks.get(topic, 0), abatch.last_seq)
                if abatch.last_seq > self.applier.applied_seq(tenant, doc):
                    self.applier.ingest_array_batch(tenant, doc, abatch)
                return
            batch = value.get("boxcar")
            msgs = batch if batch is not None else [value["message"]]
            self._watermarks[topic] = max(
                self._watermarks.get(topic, 0),
                msgs[-1].sequence_number)
            # replay idempotency: the farm checkpoint is saved BEFORE
            # the offset checkpoints, so a crash in between replays a
            # window of already-applied ops — skip by sequence number
            # (double-applying an insert would corrupt the doc)
            applied = self.applier.applied_seq(tenant, doc)
            pairs = []
            for m in msgs:
                if m.sequence_number <= applied:
                    continue
                if m.type is not MessageType.OPERATION:
                    continue
                env = m.contents
                if type(env) is not dict or env.get("kind") != "chanop" \
                        or env.get("address") != self.ds_id:
                    continue
                inner = env["contents"]
                if inner.get("address") != self.channel_id \
                        or "attach" in inner:
                    continue
                pairs.append((m, inner["contents"]))
            if pairs:
                self.applier.ingest_batch(tenant, doc, pairs)

        self.shared.subscribe(topic, on_deltas, from_offset=start)

    def checkpoint(self) -> None:
        from .gpu_applier import save_applier_checkpoint

        # crash window 1: deltas consumed into the farm, nothing saved —
        # a restart resumes from the OLD offsets and replays the window
        # (ingest skips by sequence number)
        self._fault("stage.pre_checkpoint")
        self.applier.flush()
        self.applier.finalize()
        self.last_save = save_applier_checkpoint(self.applier,
                                                 self._ckpt_path)
        # crash window 2: the farm is saved but the offset checkpoints /
        # "applied" emits are not — the restart replays against a NEWER
        # farm, the skip-by-seq path's hardest case
        self._fault("stage.post_checkpoint")
        # thread the hoptail across the process boundary: the applier's
        # last stage/execute wall stamps ride the "applied" record so
        # the core can fold stage_to_execute into its own registry
        wave_hops = getattr(self.applier, "last_wave_hops", None)
        if wave_hops is not None:  # consume: one fold per wave
            self.applier.last_wave_hops = None
        for topic, offset in self._offsets.items():
            tenant, doc = _doc_of(topic)
            self.save_checkpoint(tenant, doc, {"offset": offset})
            rec = {"kind": "applied", "tenant": tenant, "doc": doc,
                   "applied_seq": max(
                       self._watermarks.get(topic, 0),
                       self.applier.applied_seq(tenant, doc))}
            if wave_hops is not None:
                rec["wave_hops"] = list(wave_hops)
                wave_hops = None  # one observation per wave, not per doc
            self.emit(rec)


STAGES = {"scribe": ScribeStage, "applier": ApplierStage}


def main() -> None:
    parser = argparse.ArgumentParser(description="pipeline stage process")
    parser.add_argument("--stage", choices=sorted(STAGES), required=True)
    parser.add_argument("--log-dir", required=True,
                        help="the core's durable log directory (read-only)")
    parser.add_argument("--state-dir", required=True,
                        help="this stage's own writable log directory")
    parser.add_argument("--partition", default=None, metavar="K/N",
                        help="own only docs with doc_partition == K of N "
                             "(N stage processes split the doc space)")
    parser.add_argument("--device", default="cuda",
                        help="the applier stage's device (default cuda)")
    args = parser.parse_args()
    signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
    partition = None
    if args.partition:
        k, _, n = args.partition.partition("/")
        partition = (int(k), int(n))
    kwargs = {"device": args.device} if args.stage == "applier" else {}
    STAGES[args.stage](args.log_dir, args.state_dir,
                       partition=partition, **kwargs).run_forever()


if __name__ == "__main__":
    main()
