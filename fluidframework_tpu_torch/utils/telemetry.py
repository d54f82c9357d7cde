"""Telemetry: namespaced logger + perf events + metrics + trace hops.

JAX counterpart: ``fluidframework_tpu/utils/telemetry.py``; the port's copy,
imports rebased to this package.

Ref: packages/utils/telemetry-utils/src/logger.ts — ChildLogger
namespacing (:239), MultiSinkLogger (:283), PerformanceEvent scoped
timing (:434); server metric counters (services/src/metricClient.ts:7);
wire-level trace hops consumed for per-hop latency
(protocol-definitions/src/protocol.ts:59, deli stamping).

Sinks are plain callables (no transport baked in). The JAX package's
trace consumer (``TraceAggregator`` and the hop-pair breakdown) waits for
the port of ``run_network``, the only path that reads the hops back.
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
