"""Closed-loop clients against the in-process collaboration service.

The general driver of every traffic file with ``"driver": "closed_loop"``.
A frozen copy of the program's ``service/load_gen.py::run_inproc_on`` and
``wire_applier``, bounded by time instead of an op count:

- set-up: a ``LocalServer`` (deli, scriptorium, scribe and the
  broadcaster over an in-memory log), the card's replica farm
  (``GpuDocumentApplier`` with the configuration's geometry) subscribed
  to every doc's broadcast, whose escalations replay the server's own
  log, and ``docs × clients_per_doc`` sessions, each with a synthetic
  editor. Before it, a throwaway server and farm of the same geometry
  run the same loop over a few docs, so that every shape the window
  uses is warm.
- the window: clients take turns, round-robin, each submitting its next
  boxcar of ``boxcar`` ops (array lane) once its last one has come back
  (a closed loop: in process the own broadcast returns inside the submit
  call). The farm is flushed every ``flush_every`` ops. When ``seconds``
  have passed the farm is drained (``finalize``), inside the window.
  Every boxcar's ack time is kept.
- the check: every op acked once and in its client's order, each doc's
  sequence numbers contiguous, every acked op applied by the farm, and a
  seeded sample of docs (the longest among them) read back from the
  card and compared with the plain reference replaying the doc's
  broadcast stream.
"""

from __future__ import annotations

import random
import time

from portbench.yardstick.driving import (
    Spans,
    compare_docs,
    farm_texts,
    sample_docs,
    seed_rng,
)
from portbench.yardstick.streams import entry_seqs, reference_ops
from portbench.yardstick.synthetic import (
    CHANNEL_ID,
    DS_ID,
    SyntheticEditor,
)


class _Stats:
    __slots__ = ("submitted", "acked", "order_errors", "latencies",
                 "submit_t")

    def __init__(self):
        self.submitted = 0
        self.acked = 0
        self.order_errors = 0
        self.latencies = []
        self.submit_t = 0.0


class _Service:
    """One server, its farm and its sessions."""

    def __init__(self, cfg: dict, mix: dict, rng: random.Random, docs: list,
                 device: str, spans: Spans, record: bool,
                 control: str = None):
        from fluidframework_tpu_torch.service.array_batch import ArrayBoxcar
        from fluidframework_tpu_torch.service.broadcaster import (
            BroadcasterLambda,
        )
        from fluidframework_tpu_torch.service.gpu_applier import (
            GpuDocumentApplier,
        )
        from fluidframework_tpu_torch.service.local_server import (
            LocalServer,
        )
        from fluidframework_tpu_torch.service.scriptorium import (
            channel_stream,
        )

        self.tenant = tenant = cfg["tenant"]
        self.docs = docs
        self.spans = spans
        self.stats = stats = _Stats()
        self.server = server = LocalServer()
        self.applier = app = GpuDocumentApplier(device=device,
                                                **cfg["applier"])
        app.set_replay_source(lambda t, d: channel_stream(
            server, t, d, DS_ID, CHANNEL_ID))
        self.logs = {d: [] for d in docs} if record else None
        ingest = spans.wrap("ingest", app.ingest_array_batch)
        dup = [0]
        every = cfg["check"]["control_every"]

        def farm_cb(doc):
            def cb(batch):
                if type(batch) is list:
                    return  # joins: no text op reaches the farm
                box = batch.boxcar
                if box.ds_id == DS_ID and box.channel_id == CHANNEL_ID:
                    ingest(tenant, doc, batch)
                    if control is not None:
                        dup[0] += 1
                        if dup[0] % every == 0:
                            ingest(tenant, doc, batch)
            return cb

        for doc in docs:
            server.pubsub.subscribe(BroadcasterLambda.topic(tenant, doc),
                                    farm_cb(doc))
        self.sessions = []
        for doc in docs:
            log = self.logs[doc] if record else None
            for c in range(cfg["clients_per_doc"]):
                conn = server.connect(tenant, doc)
                editor = SyntheticEditor(
                    rng, ArrayBoxcar, mix["remove_fraction"],
                    mix["annotate_fraction"], mix["max_insert"])
                self._wire(conn, editor, log if c == 0 else None)
                self.sessions.append((conn, editor))

    def _wire(self, conn, editor, log) -> None:
        stats = self.stats
        latencies = stats.latencies
        me = conn.client_id
        expect = [1]
        clock = time.perf_counter

        def on_ops(batch):
            for msg in batch:
                editor.observe(msg)
            if log is not None:
                log.append(batch)

        def on_abatch(batch):
            box = batch.boxcar
            if box.client_id == me:
                editor.ref_seq = batch.last_seq
                latencies.append(clock() - stats.submit_t)
                if int(box.cseq[0]) != expect[0]:
                    stats.order_errors += 1
                expect[0] = int(box.cseq[-1]) + 1
                stats.acked += batch.n
            else:
                editor.observe_abatch(batch)
            if log is not None:
                log.append(batch)

        conn.on_ops = on_ops
        conn.on_abatch = on_abatch

    def drive(self, boxcar: int, flush_every: int, until: float,
              rounds: int = None) -> None:
        """Clients take turns until ``until`` or for ``rounds`` whole
        rounds; then the farm is drained."""
        stats, tenant, sessions = self.stats, self.tenant, self.sessions
        n = len(sessions)
        flush = self.spans.wrap("flush", self.applier.flush)
        clock = time.perf_counter
        record = self.spans.add if self.spans.enabled else None
        count = None if rounds is None else rounds * n
        i = since_flush = 0
        while i != count:
            conn, editor = sessions[i % n]
            i += 1
            box = editor.next_boxcar(boxcar, tenant, conn.document_id,
                                     conn.client_id)
            stats.submit_t = t = clock()
            if t >= until:
                break
            conn.submit_array(box)
            if record is not None:
                record("submit", t, clock())
            stats.submitted += boxcar
            since_flush += boxcar
            if since_flush >= flush_every:
                flush()
                since_flush = 0
        flush()
        t = clock()
        self.spans.wrap("finalize", self.applier.finalize)()
        self.drain_s = clock() - t


class Driver:
    """``closed_loop``: see the module docstring."""

    NESTED = {"submit": ["ingest"]}

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 tracing: bool, control: str = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.samples: dict = {}
        self.notes: dict = {}
        t = time.perf_counter()
        warm_docs = [f"warm{i}" for i in range(cfg["warmup_docs"])]
        warm = _Service(cfg, mix, random.Random(seed ^ 0x5EED), warm_docs,
                        device, Spans(False), record=False)
        warm.drive(mix["boxcar"], cfg["flush_every"], float("inf"),
                   rounds=cfg["warmup_rounds"])
        warm.applier.close()
        del warm
        self.notes["setup_warmup_s"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        self.spans = Spans(tracing)
        docs = [f"doc{i}" for i in range(cfg["docs"])]
        self.svc = _Service(cfg, mix, random.Random(seed), docs, device,
                            self.spans, record=True, control=control)
        self.notes["setup_sessions_s"] = round(time.perf_counter() - t, 3)

    def window(self, seconds: float) -> None:
        svc = self.svc
        self.w0 = time.perf_counter()
        svc.drive(self.mix["boxcar"], self.cfg["flush_every"],
                  self.w0 + seconds)
        self.w1 = time.perf_counter()
        self.window_s = self.w1 - self.w0
        self.samples["ack_ms"] = [x * 1e3 for x in svc.stats.latencies]
        self.notes["drain_s"] = round(svc.drain_s, 3)

    def counts(self) -> dict:
        app, st = self.svc.applier, self.svc.stats
        return {
            "acked_ops": st.acked, "submitted_ops": st.submitted,
            "ops_applied": app.ops_applied,
            "host_escalations": app.host_escalations,
            "dispatches": app.dispatches,
            "stage_seconds": app.stage_seconds,
            "submit_s": self.spans.total("submit"),
            "dispatch_s": (self.spans.total("flush")
                           + self.spans.total("finalize")),
            "ingest_s": self.spans.total("ingest"),
        }

    def span_arrays(self) -> dict:
        return self.spans.arrays()

    def check(self) -> dict:
        svc = self.svc
        st, app = svc.stats, svc.applier
        self.attempted = st.submitted
        self.failed = max(0, st.submitted - st.acked)
        # sequencing: each doc's broadcast stream has contiguous seqs and
        # holds every acked op once
        gaps = logged = 0
        sizes = {}
        for doc, entries in svc.logs.items():
            last = None
            ops = 0
            for entry in entries:
                first, end, n = entry_seqs(entry)
                if last is not None and first != last + 1:
                    gaps += 1
                last = end
                ops += n
            logged += ops
            sizes[doc] = ops
        sample = sample_docs(sizes, self.cfg["check"]["sample_docs"],
                             seed_rng(self.seed, 1))
        texts = farm_texts(app, svc.tenant, sample)
        self.notes["slots_max"] = (
            f"{max(app.slot_count(svc.tenant, d) for d in svc.docs)} of "
            f"{self.cfg['applier']['max_slots']}")
        escalated = app.host_escalations
        app_ops = app.ops_applied
        # an escalated doc's rows leave the farm's count, so the count
        # can only be held to the acked ops when no doc escalated; rows
        # past the acked ops are wrong either way
        unapplied = st.acked - app_ops if not escalated else 0
        app.close()
        streams = {d: reference_ops(svc.logs[d]) for d in sample}
        t = time.perf_counter()
        differing, first = compare_docs(texts, streams)
        self.notes["reference_s"] = round(time.perf_counter() - t, 3)
        self.notes["ack_samples"] = len(st.latencies)
        self.notes["docs_compared"] = (
            f"{len(sample)} of {len(sizes)} (largest {max(sizes.values())} "
            "ops)")
        if first:
            self.notes["first_difference"] = first
        if escalated:
            self.notes["unapplied_ops"] = ("not counted: escalated docs "
                                           "leave the farm's op count")
        return {
            "ack_count_error": {"value": abs(st.submitted - st.acked),
                                "limit": 0},
            "client_order_errors": {"value": st.order_errors, "limit": 0},
            "seq_gaps": {"value": gaps, "limit": 0},
            "logged_minus_acked_ops": {"value": abs(logged - st.acked),
                                       "limit": 0},
            "unapplied_ops": {"value": abs(unapplied), "limit": 0},
            "over_applied_ops": {"value": max(0, app_ops - st.acked),
                                 "limit": 0},
            "docs_differing": {"value": differing, "limit": 0},
        }
