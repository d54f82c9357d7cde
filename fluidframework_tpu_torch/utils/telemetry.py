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
"""

from __future__ import annotations

import random
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
