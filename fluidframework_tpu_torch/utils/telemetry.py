"""Telemetry: namespaced logger + perf events + metrics + trace hops.

JAX counterpart: ``fluidframework_tpu/utils/telemetry.py``; the port's copy,
imports rebased to this package.

Ref: packages/utils/telemetry-utils/src/logger.ts — ChildLogger
namespacing (:239), MultiSinkLogger (:283), PerformanceEvent scoped
timing (:434); server metric counters (services/src/metricClient.ts:7);
wire-level trace hops consumed for per-hop latency
(protocol-definitions/src/protocol.ts:59, deli stamping).

Sinks are plain callables (no transport baked in), and the trace
consumer (``TraceAggregator``) turns the hops deli already stamps into the
per-hop latency breakdown the socket load reports.

``SPANS`` is the process's span recorder: host spans at the layer
boundaries inside one process (deli, the store, the fan-out, the replica
farm's waves), on ``time.perf_counter``, kept in memory while
``tracing()`` is true and free when it is not; ``record`` switches it
on where no profiler runs.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import struct
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Optional

Sink = Callable[[dict], None]

# --------------------------------------------------------------- hop taxonomy
#
# The per-tier trace-hop vocabulary. Columnar wire frames carry hops
# as compact (hop id, timestamp) pairs (the binwire hoptail); rec
# frames carry the (service, action) strings. Both sides map through
# THIS table — it is the taxonomy's single source of truth.
#
# STABILITY: hop ids are WIRE values (hoptail u8, durable replays,
# mixed-version gateways) — existing ids are FROZEN and new hops are
# APPENDED, never inserted (numeric id order therefore stopped
# matching path order at id 6).
HOPS = (
    ("client", "submit", "submit"),
    ("gateway", "relay", "relay"),
    ("frontend", "admit", "admit"),
    ("deli", "sequence", "deli"),
    ("broadcast", "fanout", "fanout"),
    ("client", "ack", "ack"),
    # -- appended later: ids 6+ are newer than some stampers --
    ("frontend", "shed", "shed"),      # client parked the op on a shed nack
    ("applier", "stage", "stage"),     # host half of a dispatch wave
    ("applier", "execute", "execute"),  # device half of a dispatch wave
)
(HOP_SUBMIT, HOP_RELAY, HOP_ADMIT, HOP_DELI, HOP_FANOUT,
 HOP_ACK, HOP_SHED, HOP_STAGE, HOP_EXECUTE) = range(len(HOPS))
#: hop id → (service, action) — the rec-frame string pair.
HOP_SERVICE_ACTION = tuple((s, a) for s, a, _ in HOPS)
#: (service, action) → hop id.
HOP_ID = {(s, a): i for i, (s, a, _) in enumerate(HOPS)}
#: hop id → short key used in breakdown pair names.
HOP_SHORT = tuple(short for _, _, short in HOPS)
#: Hop ids in PIPELINE order — shed precedes submit (the park happens
#: before the retry-flush restamps submit), stage/execute sit between
#: sequencing and fan-out (the applier consumes the sequenced stream).
HOP_PIPELINE = (HOP_SHED, HOP_SUBMIT, HOP_RELAY, HOP_ADMIT, HOP_DELI,
                HOP_STAGE, HOP_EXECUTE, HOP_FANOUT, HOP_ACK)
#: hop id → pipeline position (the sort key for breakdown legs).
HOP_ORDER = {h: i for i, h in enumerate(HOP_PIPELINE)}


def hop_pair_name(a: int, b: int) -> str:
    """The breakdown key for the leg between two hop ids."""
    return f"{HOP_SHORT[a]}_to_{HOP_SHORT[b]}"


def hop_pairs(hops) -> list[tuple[str, float]]:
    """[(hop_id, ts), ...] → [(pair_name, delta_ms), ...] between
    consecutive PRESENT hops in pipeline order (unknown ids ignored;
    a repeated id keeps its last timestamp — EXCEPT gateway/relay,
    where every stamp is kept in arrival order: stacked relay tiers
    each stamp the same id, so the repeats ARE the relay depth and
    each inter-tier leg surfaces as a ``relay_to_relay`` pair)."""
    ts_by_id: dict[int, float] = {}
    relays: list[float] = []
    for i, ts in hops:
        if not 0 <= i < len(HOPS):
            continue
        if i == HOP_RELAY:
            relays.append(ts)
        else:
            ts_by_id[i] = ts
    seq: list[tuple[int, float]] = []
    for h in HOP_PIPELINE:
        if h == HOP_RELAY:
            seq.extend((HOP_RELAY, ts) for ts in relays)
        elif h in ts_by_id:
            seq.append((h, ts_by_id[h]))
    return [(hop_pair_name(a, b), (tb - ta) * 1e3)
            for (a, ta), (b, tb) in zip(seq, seq[1:])]


def count_unknown_hops(hops) -> int:
    """Entries whose id falls outside the taxonomy — a version-skewed
    stamper. Callers surface the count as ``obs.trace.unknown_hops``
    (this module sits below obs/, so it cannot reach the registry)."""
    return sum(1 for i, _ in hops if not 0 <= i < len(HOPS))


def percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


class TelemetryLogger:
    """Namespaced event logger with injectable sinks.

    ``child("deli")`` shares the sink chain and prefixes the namespace —
    the ChildLogger pattern. Events are dicts with at least
    ``{"category", "event", "namespace", "ts"}``.
    """

    def __init__(self, namespace: str = "", sinks: Optional[list[Sink]] = None):
        self.namespace = namespace
        self._sinks: list[Sink] = sinks if sinks is not None else []

    def child(self, namespace: str) -> "TelemetryLogger":
        ns = f"{self.namespace}:{namespace}" if self.namespace else namespace
        out = TelemetryLogger(ns)
        out._sinks = self._sinks  # shared chain: adding a sink later
        return out                # reaches existing children too

    def add_sink(self, sink: Sink) -> None:
        self._sinks.append(sink)

    def send(self, category: str, event: str, **fields: Any) -> None:
        if not self._sinks:
            return
        record = {"category": category, "event": event,
                  "namespace": self.namespace, "ts": time.time(), **fields}
        for sink in self._sinks:
            sink(record)

    def info(self, event: str, **fields: Any) -> None:
        self.send("generic", event, **fields)

    def error(self, event: str, **fields: Any) -> None:
        self.send("error", event, **fields)

    def perf(self, event: str, **fields: Any) -> "PerformanceEvent":
        return PerformanceEvent(self, event, fields)


class BufferSink:
    """Ring-buffer sink for tests and the /repl-style debug surface."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.records: list[dict] = []

    def __call__(self, record: dict) -> None:
        self.records.append(record)
        if len(self.records) > self.capacity:
            del self.records[: len(self.records) - self.capacity]

    def of(self, event: str) -> list[dict]:
        return [r for r in self.records if r["event"] == event]


class PerformanceEvent:
    """Scoped timing (ref: PerformanceEvent logger.ts:434): emits
    ``<event>_end`` with duration_ms on success, ``<event>_cancel`` with
    the error on exception."""

    def __init__(self, logger: TelemetryLogger, event: str, fields: dict):
        self._logger = logger
        self._event = event
        self._fields = fields
        self._t0 = 0.0

    def __enter__(self) -> "PerformanceEvent":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        ms = (time.perf_counter() - self._t0) * 1e3
        if exc_type is None:
            self._logger.send("performance", f"{self._event}_end",
                              duration_ms=ms, **self._fields)
        else:
            self._logger.send("performance", f"{self._event}_cancel",
                              duration_ms=ms, error=str(exc), **self._fields)


class Counters:
    """Named monotonic counters + value observations (metricClient role).

    Value series are bounded: each keeps a ``max_samples`` reservoir
    (uniform reservoir sampling, seeded so snapshots are reproducible)
    plus the true observation count — a long-running service observing
    per-op latencies must not grow a list per op forever. ``count`` in
    the snapshot is always the TRUE number of observations, not the
    reservoir size.
    """

    def __init__(self, max_samples: int = 4096):
        self._counts: dict[str, int] = defaultdict(int)
        self._values: dict[str, list[float]] = defaultdict(list)
        self._observed: dict[str, int] = defaultdict(int)
        self._max_samples = max_samples
        self._rng = random.Random(0)

    def inc(self, name: str, by: int = 1) -> None:
        self._counts[name] += by

    def observe(self, name: str, value: float) -> None:
        n = self._observed[name] = self._observed[name] + 1
        vals = self._values[name]
        if len(vals) < self._max_samples:
            vals.append(value)
        else:
            j = self._rng.randrange(n)
            if j < self._max_samples:
                vals[j] = value

    def snapshot(self) -> dict:
        out: dict[str, Any] = dict(self._counts)
        for name, vals in self._values.items():
            s = sorted(vals)
            series: dict[str, Any] = {
                "count": self._observed[name],
                "p50": round(percentile(s, 0.5), 3),
                "p99": round(percentile(s, 0.99), 3),
            }
            if name in self._counts:
                # a counter and a value series share the name: surface
                # both under the key instead of the series silently
                # clobbering the counter (or vice versa)
                series["counter"] = self._counts[name]
            out[name] = series
        return out


class TraceAggregator:
    """Consume wire trace hops into an ordered hop-pair breakdown.

    Each tier stamps its hop from the :data:`HOPS` taxonomy (client/
    submit, gateway/relay, frontend/admit, deli/sequence, broadcast/
    fanout); the ack observer calls ``record(msg)`` when its own op
    comes back. Every leg between consecutive PRESENT hops becomes a
    ``{a}_to_{b}`` latency series — partial stamping (only client+deli)
    reproduces the legacy submit→deli / deli→ack split exactly.
    """

    def __init__(self):
        self._hops: dict[str, list[float]] = defaultdict(list)
        #: hops dropped for an id outside the taxonomy — a
        #: version-skewed stamper; surfaced in ``report()`` (and by
        #: service consumers as ``obs.trace.unknown_hops``) instead of
        #: vanishing silently.
        self.unknown_hops = 0

    def record(self, msg, ack_time: Optional[float] = None) -> None:
        hops = []
        for hop in msg.traces:
            i = HOP_ID.get((hop.service, hop.action))
            if i is not None:
                hops.append((i, hop.timestamp))
            else:
                self.unknown_hops += 1
        self.record_hops(
            hops, ack_time if ack_time is not None else time.time())

    def record_hops(self, hops, ack_time: Optional[float] = None) -> None:
        """Fold an ordered [(hop_id, timestamp), ...] list (the wire
        hoptail shape) into the breakdown.

        ``ack_time`` contributes the client/ack hop — but only when the
        op was actually sequenced (a deli-or-later hop is present): an
        op that never reached the sequencer has no ack latency to
        attribute, so a lone client/submit stamp records nothing.
        """
        known = [(i, ts) for i, ts in hops if 0 <= i < len(HOPS)]
        self.unknown_hops += len(hops) - len(known)
        # "actually sequenced" means deli-or-later in PIPELINE order —
        # appended ids like frontend/shed are numerically past deli but
        # sit before it on the path, so numeric comparison would lie
        deli_pos = HOP_ORDER[HOP_DELI]
        if (ack_time is not None
                and all(i != HOP_ACK for i, _ in known)
                and any(HOP_ORDER[i] >= deli_pos for i, _ in known)):
            known.append((HOP_ACK, ack_time))
        for name, ms in hop_pairs(known):
            self._hops[name].append(ms)

    def merge_raw(self, hops: dict[str, list[float]]) -> None:
        for name, vals in hops.items():
            self._hops[name].extend(vals)

    @property
    def raw(self) -> dict[str, list[float]]:
        return dict(self._hops)

    def report(self) -> dict:
        out = {}
        for name, vals in self._hops.items():
            s = sorted(vals)
            out[name] = {"count": len(s),
                         "p50_ms": round(percentile(s, 0.5), 3),
                         "p99_ms": round(percentile(s, 0.99), 3)}
        if self.unknown_hops:
            out["unknown_hops"] = {"count": self.unknown_hops}
        return out


# ------------------------------------------------------------------ spans
#
# The in-process span recorder. A site costs one call of ``tracing()``
# while it is off: no clock read, no allocation, no ``record_function``.
# It is on while a ``torch.profiler`` session runs (the profiler keeps
# ``torch.autograd.profiler._is_profiler_enabled`` for exactly this
# check), so a profiled window gets the program's spans with no switch of
# its own, and while ``record(True)`` holds it on in a process that runs
# no profiler. Spans share ``time.perf_counter`` with the callers' own host
# timers.


class _ProfilerUnbound:
    """Stands in for ``torch.autograd.profiler`` until torch is imported:
    no profiler can run before, and the first check after binds the real
    module, so later checks are one attribute load."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None or not hasattr(mod, "_is_profiler_enabled"):
            return False
        _profiler = mod
        return mod._is_profiler_enabled


_profiler = _ProfilerUnbound()

#: Whether this process's recorder was started by ``record(True)`` (the
#: core's ``admin_spans`` RPC): a process that maps no libtorch runs no
#: profiler, so this is how its spans are switched on.
_recording = False


def tracing() -> bool:
    """Whether span sites record: a ``torch.profiler`` session is
    active, or the recorder was started with ``record(True)``."""
    return _recording or _profiler._is_profiler_enabled


def record(on: bool) -> None:
    """Start (after a ``SPANS.reset()``) or stop recording spans without
    a profiler."""
    global _recording
    if on:
        SPANS.reset()
    _recording = on


def span_of(callback: Callable) -> Optional[str]:
    """The span a callback's deliveries run under: the ``SPAN`` class
    attribute of a bound method's object, else None (no span)."""
    return getattr(type(getattr(callback, "__self__", None)), "SPAN", None)


# An open span is a list (cheaper to make than an object), indexed so
# (_STATE: its thread's _ThreadState):
(_NAME, _ID, _PARENT, _START, _RESUMED, _BUSY, _CHILD, _REQUEST, _PREV,
 _STATE) = range(10)
# A kept row is five ints (id, parent id or 0, name id, request id,
# calls) and two floats (start, start + busy time), packed into one
# per-thread bytearray: one C call a row, 56 bytes.
_ROW = struct.Struct("=5q2d")
_ROW_FIELDS = ("id", "parent", "name", "request", "calls", "start", "end")


class _ThreadState:
    """One thread's open spans, current request id, totals and kept rows
    (a plain object: an attribute of a ``threading.local`` subclass
    costs several times more to read). Only its thread writes it, so the
    totals need no lock."""

    __slots__ = ("stack", "request", "totals", "rows", "dropped")

    def __init__(self, names: int):
        self.stack: list = []
        self.request = 0
        # name id → [seconds, self seconds, calls]
        self.totals = [[0.0, 0.0, 0] for _ in range(names)]
        self.rows = bytearray()
        self.dropped = 0


class SpanRecorder:
    """Host spans by name, with their parent span and request id.

    A span is ``begin``/``end`` around the work (``end`` in a
    ``finally``). A span may be paused and resumed instead (the sessions
    of one broadcast share one row): ``close`` books it with the calls
    it stands for, its busy time being the sum of its running
    stretches.

    Totals per name (seconds; self seconds, less the time of its child
    spans; calls) and the plain counters of ``count`` are read by
    ``snapshot()``. Each span is also kept as a
    packed row in a bounded per-thread buffer, no lock on the way; past
    ``capacity`` rows only the totals go on and ``dropped`` counts the
    rest.

    A request id is a process counter: ``begin(..., request=True)`` takes
    a new one for the span and everything it causes, ``new_request()``
    one for what the thread does next (a wave). Spans inherit the
    thread's current id. A span begun directly inside one of the same
    name is folded into it (``begin`` returns None).
    """

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self._counts: dict = defaultdict(float)
        self._names: list = []
        self._ids: dict = {}
        self._threads: list = []  # (native id, _ThreadState) a thread
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def _state(self) -> _ThreadState:
        """This thread's state, made at its first span."""
        try:
            return self._local.state
        except AttributeError:
            with self._lock:
                ts = self._local.state = _ThreadState(len(self._names))
                self._threads.append((threading.get_native_id(), ts))
            return ts

    def reset(self) -> None:
        """Forget every span and total (names stay registered)."""
        with self._lock:
            self._span_ids = itertools.count(1)
            self._requests = itertools.count(1)
            self._row_numbers = itertools.count()
            for _tid, ts in self._threads:
                del ts.rows[:]
                ts.dropped = 0
                for total in ts.totals:
                    total[:] = (0.0, 0.0, 0)
            self._counts.clear()

    @property
    def dropped(self) -> int:
        return sum(ts.dropped for _tid, ts in self._threads)

    def name_id(self, name: str) -> int:
        """The id a site passes to ``begin``; resolve it once, at import
        or subscription."""
        with self._lock:
            nid = self._ids.get(name)
            if nid is None:
                nid = self._ids[name] = len(self._names)
                self._names.append(name)
                for _tid, ts in self._threads:
                    ts.totals.append([0.0, 0.0, 0])
        return nid

    def new_request(self) -> int:
        """A fresh request id, current on this thread from now on."""
        rid = self._state().request = next(self._requests)
        return rid

    def begin(self, name: int, t: float = None, request: bool = False):
        """Open span ``name`` (an id of ``name_id``) on this thread, at
        ``t`` when the site read the clock itself; None when it folds
        into a running span of that name."""
        try:
            ts = self._local.state
        except AttributeError:
            ts = self._state()
        stack = ts.stack
        parent = stack[-1] if stack else None
        if parent is not None and parent[_NAME] == name:
            return None
        if t is None:
            t = time.perf_counter()
        rid = ts.request
        prev = None
        if request:
            prev = rid
            rid = ts.request = next(self._requests)
        frame = [name, next(self._span_ids), parent, t, t, 0.0, 0.0, rid,
                 prev, ts]
        stack.append(frame)
        return frame

    def pause(self, frame: list) -> None:
        frame[_BUSY] += time.perf_counter() - frame[_RESUMED]
        frame[_STATE].stack.pop()

    def resume(self, frame: list) -> None:
        frame[_RESUMED] = time.perf_counter()
        frame[_STATE].stack.append(frame)

    def end(self, frame: list, t: float = None) -> None:
        """Close ``frame`` (at ``t`` when the site read the clock
        itself)."""
        frame[_BUSY] += (time.perf_counter() if t is None else t) \
            - frame[_RESUMED]
        frame[_STATE].stack.pop()
        self.close(frame, 1)

    def close(self, frame: list, calls: int) -> None:
        """Book a paused frame as ``calls`` calls: totals, its parent's
        child time, a row whose end is its start plus its busy time."""
        busy = frame[_BUSY]
        parent = frame[_PARENT]
        ts = frame[_STATE]
        if parent is not None:
            parent[_CHILD] += busy
        if frame[_PREV] is not None:
            ts.request = frame[_PREV]
        total = ts.totals[frame[_NAME]]
        total[0] += busy
        total[1] += busy - frame[_CHILD]
        total[2] += calls
        if next(self._row_numbers) >= self.capacity:
            ts.dropped += 1
            return
        ts.rows += _ROW.pack(
            frame[_ID], 0 if parent is None else parent[_ID], frame[_NAME],
            frame[_REQUEST], calls, frame[_START], frame[_START] + busy)

    def count(self, name: str, by: float = 1) -> None:
        self._counts[name] += by

    # ------------------------------------------------------------ readers

    def snapshot(self) -> dict:
        """``{"spans": {name: {"seconds", "self_seconds", "calls"}},
        "counters": {name: value}, "rows": n, "dropped": n}``; a name
        with no finished span is left out."""
        with self._lock:
            threads = [ts for _tid, ts in self._threads]
            names = list(self._names)
        spans = {}
        for nid, name in enumerate(names):
            sec, self_sec, calls = (
                sum(ts.totals[nid][k] for ts in threads) for k in range(3))
            if calls:
                spans[name] = {"seconds": sec, "self_seconds": self_sec,
                               "calls": calls}
        return {"spans": spans, "counters": dict(self._counts),
                "rows": sum(len(ts.rows) for ts in threads) // _ROW.size,
                "dropped": self.dropped}

    def rows(self) -> dict:
        """The kept rows as numpy columns, thread by thread: ``id``,
        ``parent`` (0 for a top-level span), ``name`` (ids into
        ``names``), ``request``, ``calls``, ``tid``, ``start``, ``end``."""
        import numpy as np

        dtype = np.dtype([(f, "=i8") for f in _ROW_FIELDS[:5]]
                         + [(f, "=f8") for f in _ROW_FIELDS[5:]])
        with self._lock:
            parts = [(tid, np.frombuffer(bytes(ts.rows), dtype))
                     for tid, ts in self._threads]
        parts.append((0, np.zeros(0, dtype)))  # so that there is one part
        table = np.concatenate([p[1] for p in parts])
        out = {f: table[f] for f in _ROW_FIELDS}
        out["tid"] = np.concatenate([np.full(len(p[1]), p[0], np.int64)
                                     for p in parts])
        out["names"] = list(self._names)
        return out

    def arrays(self) -> dict:
        """``{name: (starts, ends)}`` in ``perf_counter`` seconds, by
        start: the shape of a benchmark harness's host spans."""
        import numpy as np

        rows = self.rows()
        out = {}
        for nid in np.unique(rows["name"]):
            pick = rows["name"] == nid
            order = np.argsort(rows["start"][pick], kind="stable")
            out[rows["names"][int(nid)]] = (rows["start"][pick][order],
                                            rows["end"][pick][order])
        return out

    def export_chrome_trace(self, path: str) -> int:
        """Write the kept rows as a Chrome trace (one complete ``X``
        event a span, microseconds on ``perf_counter``); returns the
        event count."""
        rows = self.rows()
        pid = os.getpid()
        names = rows["names"]
        events = [
            {"name": names[int(n)], "cat": "span", "ph": "X",
             "ts": s * 1e6, "dur": (e - s) * 1e6, "pid": pid,
             "tid": int(tid), "args": {"request": int(r),
                                       "calls": int(c)}}
            for n, s, e, tid, r, c in zip(
                rows["name"], rows["start"], rows["end"], rows["tid"],
                rows["request"], rows["calls"])]
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
        return len(events)


#: The process's span recorder.
SPANS = SpanRecorder()
