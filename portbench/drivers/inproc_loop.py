"""Clients against the in-process collaboration service, on a closed or an
open loop, over docs that may carry a history made in set-up.

The general driver of every traffic file with ``"driver": "inproc_loop"``.
It runs the service of ``closed_loop.py`` (``_Service``: a ``LocalServer``
over an in-memory log, the card's replica farm on the broadcast, a
synthetic editor a client) with two additions:

- history (a configuration with ``history_ops``, ``[lo, hi]``): before
  the window each doc takes a seeded number of ops in that range from one
  writer, in boxcars of up to ``history_boxcar``, docs taking turns, the
  farm flushed every ``flush_every`` ops; only then do the doc's other
  ``clients_per_doc - 1`` clients connect, with the doc's length. One
  writer keeps the collaboration window closed behind it, so a history of
  thousands of ops takes seconds. Such a history outgrows the farm's slots
  unless the farm merges settled runs (its repack), so the driver reads
  the farm's repack counters first and stops at once, naming them, on a
  program without them.
- the loop (the traffic's ``loop``): ``closed``, clients taking turns
  round-robin, each sending its next boxcar once its last is acked (the
  flood's window); or ``open``, boxcars due on a Poisson schedule at the
  traffic's ``rate`` ops a second, each sent by the next client of a
  seeded cycle through all of them and timed from its due instant, so
  that time the loop falls behind counts in the ack.

Either way the farm is flushed every ``flush_every`` ops and, when
``seconds`` have passed (the open loop: once every boxcar due by then is
sent), drained (``finalize``) inside the window.

The check is the flood's: every op acked once and in its client's order,
each doc's sequence numbers contiguous, the log holding every acked op,
every acked op applied once (on the card, or on a host replica for a doc
the farm escalated: the farm's ``host_ops_applied``), and a seeded sample
of docs, the ones the farm repacked in the window first, read back and
compared with the plain reference replaying the doc's whole broadcast
stream, history included.
"""

from __future__ import annotations

import random
import time

import numpy as np

from portbench.drivers.closed_loop import _Service
from portbench.yardstick.driving import (
    Spans,
    compare_docs,
    farm_texts,
    seed_rng,
)
from portbench.yardstick.streams import entry_seqs, reference_ops
from portbench.yardstick.synthetic import SyntheticEditor

#: what the driver reads of the farm for a configuration with a history
REPACK_COUNTERS = ("doc_repacks", "repack_slots_in",
                   "repack_slots_out", "repack_escalations",
                   "host_ops_applied")


def require_repack() -> None:
    """Stop at once unless the program's farm repacks (its counters are
    there): without it a long history escalates every doc to the host."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    probe = GpuDocumentApplier(device="cpu", max_docs=1, max_slots=8,
                               ops_per_dispatch=1)
    missing = [c for c in REPACK_COUNTERS if not hasattr(probe, c)]
    probe.close()
    if missing:
        raise RuntimeError(
            "the farm has no repack counters (" + ", ".join(missing)
            + "): a configuration with history_ops needs the repack, "
            "else every aged doc replays onto the host")


def sample_repacked(sizes: dict, repacked: list, n: int,
                    rng: np.random.Generator) -> list:
    """``n`` docs: the largest by ``sizes``, then docs of ``repacked``
    drawn from ``rng``, then the rest drawn from it."""
    names = sorted(sizes)
    largest = max(names, key=lambda d: (sizes[d], d))
    out = [largest]
    for pool in (sorted(set(repacked) - {largest}),
                 sorted(set(names) - set(repacked) - {largest})):
        room = n - len(out)
        if room <= 0 or not pool:
            continue
        picked = rng.choice(len(pool), size=min(room, len(pool)),
                            replace=False)
        out += [pool[int(i)] for i in picked]
    return out


class Driver:
    """``inproc_loop``: see the module docstring."""

    NESTED = {"submit": ["ingest"]}

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 tracing: bool, control: str = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.samples: dict = {}
        self.notes: dict = {}
        history = cfg.get("history_ops")
        if history:
            require_repack()
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
        self.docs = docs = [f"doc{i}" for i in range(cfg["docs"])]
        rng = random.Random(seed)
        if history:
            writer = dict(cfg, clients_per_doc=1)
            self.svc = _Service(writer, mix, rng, docs, device, self.spans,
                                record=True, control=control)
            self._age(seed_rng(seed, 2).integers(
                history[0], history[1] + 1, len(docs)))
            self.notes["setup_history_s"] = round(time.perf_counter() - t, 3)
            self._join_rest(rng)
        else:
            self.svc = _Service(cfg, mix, rng, docs, device, self.spans,
                                record=True, control=control)
        self.notes["setup_sessions_s"] = round(time.perf_counter() - t, 3)
        app = self.svc.applier
        self._base = {"acked": self.svc.stats.acked,
                      "escalated": app.host_escalations,
                      "repacks": np.array(getattr(app, "doc_repacks", 0))}
        self.svc.stats.latencies.clear()
        self.slots_start = self._slot_counts()

    def _age(self, ops: np.ndarray) -> None:
        """Each doc's writer sends ``ops[d]`` ops, docs taking turns."""
        svc, tenant = self.svc, self.svc.tenant
        box = self.cfg["history_boxcar"]
        flush_every = self.cfg["flush_every"]
        left = ops.astype(np.int64).copy()
        since = 0
        while left.any():
            for d in np.nonzero(left)[0].tolist():
                conn, editor = svc.sessions[d]
                n = int(min(box, left[d]))
                svc.stats.submit_t = time.perf_counter()
                conn.submit_array(editor.next_boxcar(
                    n, tenant, conn.document_id, conn.client_id))
                svc.stats.submitted += n
                left[d] -= n
                since += n
                if since >= flush_every:
                    svc.applier.flush()
                    since = 0
        svc.applier.finalize()
        app = svc.applier
        self.notes["history_ops"] = (
            f"{int(ops.sum())} in all, {int(ops.min())}-{int(ops.max())} "
            "a doc")
        self.notes["history_repacks"] = (
            f"{int(app.doc_repacks.sum())} doc repacks, slots "
            f"{app.repack_slots_in} -> {app.repack_slots_out}; "
            f"{app.host_escalations} escalated")

    def _join_rest(self, rng: random.Random) -> None:
        """Connect each doc's other clients, each editor starting from the
        writer's length of the doc; sessions stay doc-major."""
        from fluidframework_tpu_torch.service.array_batch import ArrayBoxcar

        svc, mix = self.svc, self.mix
        sessions = []
        for d, doc in enumerate(self.docs):
            writer = svc.sessions[d]
            sessions.append(writer)
            for _ in range(self.cfg["clients_per_doc"] - 1):
                conn = svc.server.connect(svc.tenant, doc)
                editor = SyntheticEditor(
                    rng, ArrayBoxcar, mix["remove_fraction"],
                    mix["annotate_fraction"], mix["max_insert"])
                editor.length = writer[1].length
                svc._wire(conn, editor, None)
                sessions.append((conn, editor))
        svc.sessions = sessions

    def _slot_counts(self) -> np.ndarray:
        app, tenant = self.svc.applier, self.svc.tenant
        return np.array([app.slot_count(tenant, d) for d in self.docs])

    def window(self, seconds: float) -> None:
        svc = self.svc
        self.w0 = time.perf_counter()
        if self.mix["loop"] == "open":
            self._open_loop(self.w0 + seconds)
        else:
            svc.drive(self.mix["boxcar"], self.cfg["flush_every"],
                      self.w0 + seconds)
        self.w1 = time.perf_counter()
        self.window_s = self.w1 - self.w0
        self.samples["ack_ms"] = [x * 1e3 for x in svc.stats.latencies]
        self.notes["drain_s"] = round(svc.drain_s, 3)

    def _open_loop(self, until: float) -> None:
        """Poisson boxcars at the traffic's rate, each due at its instant
        and timed from it; the clients in a seeded cycle."""
        svc, tenant, boxcar = self.svc, self.svc.tenant, self.mix["boxcar"]
        rng = seed_rng(self.seed, 3)
        per_s = self.mix["rate"] / boxcar
        span = until - self.w0
        gaps = rng.exponential(1.0 / per_s, int(per_s * span * 1.2) + 64)
        due = self.w0 + np.cumsum(gaps)
        due = due[due < until].tolist()
        order = rng.permutation(len(svc.sessions)).tolist()
        flush = self.spans.wrap("flush", svc.applier.flush)
        record = self.spans.add if self.spans.enabled else None
        clock, sleep = time.perf_counter, time.sleep
        stats, sessions = svc.stats, svc.sessions
        flush_every = self.cfg["flush_every"]
        since = 0
        late = 0
        for i, at in enumerate(due):
            conn, editor = sessions[order[i % len(order)]]
            box = editor.next_boxcar(boxcar, tenant, conn.document_id,
                                     conn.client_id)
            now = clock()
            if at - now > 0.001:
                sleep(at - now - 0.0005)
            while clock() < at:
                pass
            t = clock()
            late += t - at > 0.001
            stats.submit_t = at
            conn.submit_array(box)
            if record is not None:
                record("submit", t, clock())
            stats.submitted += boxcar
            since += boxcar
            if since >= flush_every:
                flush()
                since = 0
        flush()
        t = clock()
        self.spans.wrap("finalize", svc.applier.finalize)()
        svc.drain_s = clock() - t
        self.notes["offered"] = (f"{len(due)} boxcars of {boxcar} due in "
                                 f"{until - self.w0:.3f} s; {late} sent more "
                                 "than 1 ms late")

    def counts(self) -> dict:
        app, st = self.svc.applier, self.svc.stats
        return {
            "acked_ops": st.acked - self._base["acked"],
            "submitted_ops": st.submitted,
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
        window_ops = st.acked - self._base["acked"]
        self.attempted = window_ops
        self.failed = max(0, st.submitted - st.acked)
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
        repacks = np.array(getattr(app, "doc_repacks", 0))
        moved = repacks - self._base["repacks"]
        repacked = [d for d in self.docs
                    if np.ndim(moved) and moved[app.slot_of(svc.tenant, d)]]
        sample = sample_repacked(sizes, repacked,
                                 self.cfg["check"]["sample_docs"],
                                 seed_rng(self.seed, 1))
        texts = farm_texts(app, svc.tenant, sample)
        slots_end = self._slot_counts()
        host_ops = getattr(app, "host_ops_applied", None)
        escalated = app.host_escalations
        app_ops = app.ops_applied
        # ops applied once: on the card, or on a host replica past the
        # escalated doc's last wave; a program that does not count the
        # host's ops is held to it only while no doc escalated
        applied = app_ops + (host_ops or 0)
        unapplied = (st.acked - applied
                     if host_ops is not None or not escalated else 0)
        self.notes["slots_at_window_start"] = _spread(self.slots_start)
        self.notes["slots_at_window_end"] = _spread(slots_end)
        self.notes["max_slots"] = self.cfg["applier"]["max_slots"]
        self.notes["docs_repacked_in_window"] = len(repacked)
        self.notes["repacks"] = (
            f"{int(np.sum(repacks))} doc repacks in all, "
            f"slots {getattr(app, 'repack_slots_in', 'n/a')} -> "
            f"{getattr(app, 'repack_slots_out', 'n/a')}, "
            f"{getattr(app, 'repack_escalations', 'n/a')} escalated after one")
        self.notes["escalated_docs"] = (
            f"{escalated} ({escalated - self._base['escalated']} in the "
            "window)")
        self.notes["largest_doc_ops"] = max(sizes.values())
        app.close()
        streams = {d: reference_ops(svc.logs[d]) for d in sample}
        t = time.perf_counter()
        differing, first = compare_docs(texts, streams)
        self.notes["reference_s"] = round(time.perf_counter() - t, 3)
        self.notes["ack_samples"] = len(st.latencies)
        self.notes["docs_compared"] = (
            f"{len(sample)} of {len(sizes)}, "
            f"{sum(d in repacked for d in sample)} repacked in the window "
            f"(largest {max(sizes.values())} ops)")
        if first:
            self.notes["first_difference"] = first
        if host_ops is None and escalated:
            self.notes["unapplied_ops"] = ("not counted: the farm does not "
                                           "count its host replicas' ops")
        return {
            "ack_count_error": {"value": abs(st.submitted - st.acked),
                                "limit": 0},
            "client_order_errors": {"value": st.order_errors, "limit": 0},
            "seq_gaps": {"value": gaps, "limit": 0},
            "logged_minus_acked_ops": {"value": abs(logged - st.acked),
                                       "limit": 0},
            "unapplied_ops": {"value": abs(unapplied), "limit": 0},
            "over_applied_ops": {"value": max(0, applied - st.acked),
                                 "limit": 0},
            "docs_differing": {"value": differing, "limit": 0},
        }


def _spread(counts: np.ndarray) -> str:
    q = np.percentile(counts, [0, 50, 100]).astype(int).tolist()
    return f"min {q[0]}, median {q[1]}, max {q[2]} of {len(counts)} docs"
