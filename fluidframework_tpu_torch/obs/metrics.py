"""Process-wide metrics registry with labels and a Prometheus scrape.

JAX counterpart: ``fluidframework_tpu/obs/metrics.py``; the port's copy,
imports rebased to this package.

Ref: services/src/metricClient.ts ships counters to an external
telegraf; SURVEY §telemetry prescribes labeled series. Tiers each hold a
private :class:`~..utils.telemetry.Counters`; this module is the
process-wide aggregation point:

- ``tier_counters(tier)`` hands a tier a FRESH ``Counters`` instance
  (hot paths keep their lock-free dict increments — nothing on the op
  path touches the registry) and registers it, weakly, under the tier
  label; the scrape sums same-named counters across live instances.
- ``inc``/``set_gauge``/``observe`` are the labeled direct API
  (``tenant``/``doc``/``pair``/``tier`` label keys) for the few cold
  call sites that want per-entity series.
- Label-set cardinality is BOUNDED per metric name: past ``max_series``
  distinct label sets, samples land in a single overflow bucket
  (``overflow="true"``) and ``obs.series.dropped`` counts the spills —
  a hostile tenant-id stream cannot grow the scrape without bound.
- ``scrape()`` renders Prometheus text exposition (counters as
  ``counter``, gauges as ``gauge``, observations as ``summary`` with
  p50/p99 quantile labels); :func:`parse_prometheus` is the matching
  reader.

Dotted metric names (``tier.noun.verb``) map to Prometheus by ``.`` →
``_`` with a ``fluid_`` prefix.
"""

from __future__ import annotations

import math
import random
import threading
import time
import weakref
from typing import Optional

from ..utils.affinity import holds_lock
from ..utils.telemetry import Counters, percentile

#: Distinct label sets allowed per metric name before overflow.
DEFAULT_MAX_SERIES = 256

#: Windowed-series defaults: ten one-second buckets per series.
DEFAULT_WINDOW_S = 10.0
DEFAULT_WINDOW_BUCKETS = 10

#: History-ring defaults: ~15 min retained at 10 s resolution. Memory
#: is bounded per series at horizon/resolution slots of 4 numbers.
DEFAULT_HISTORY_S = 900.0
DEFAULT_HISTORY_RES_S = 10.0

_PREFIX = "fluid_"


def _prom_name(name: str) -> str:
    return _PREFIX + name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: tuple) -> str:
    if not labels:
        return ""
    # exposition-spec label escaping: backslash, double quote, and
    # newline (a raw \n would split the sample across two lines and
    # corrupt the whole line-oriented scrape)
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
        for k, v in labels)
    return "{" + inner + "}"


class _Series:
    """One observation series: true count + bounded uniform reservoir
    (seeded, same scheme as ``Counters.observe``) — lifetime quantiles
    keep representing the whole stream instead of the first 4096
    warmup samples."""

    __slots__ = ("count", "samples", "_rng")

    def __init__(self):
        self.count = 0
        self.samples: list[float] = []
        self._rng = random.Random(0)

    def add(self, value: float, max_samples: int = 4096) -> None:
        self.count += 1
        if len(self.samples) < max_samples:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < max_samples:
                self.samples[j] = value


class WindowedSeries:
    """Epoch-ring windowed observations: ``buckets`` fixed-width time
    buckets spanning the trailing ``window_s`` seconds.

    ``observe`` is O(1): a value lands in the bucket indexed by its
    epoch (``now // width``) modulo the ring size, and a bucket whose
    stored epoch went stale is reset in place — that lazy reset IS the
    rotation, so an idle series costs nothing. Reads merge the samples
    of every bucket still inside the window, so quantiles reflect the
    last window, not process lifetime (the cumulative ``_Series``
    keeps that role). Per-bucket samples are a seeded reservoir with
    the true count kept separately.

    History ring: a bucket expiring out of the live window is
    RETIRED — its (count, sum, max) folds into a coarse history slot
    (``history_res_s`` wide, default 10 s) retained for ``history_s``
    (default ~15 min), so a blip's before/after survives long past the
    live window at bounded memory (no samples are retained — count/
    sum/max only). ``history()`` merges retained slots with the live
    buckets, so the newest points appear immediately."""

    __slots__ = ("width", "buckets", "max_per_bucket", "_epochs",
                 "_counts", "_sums", "_maxs", "_samples", "_rng",
                 "history_res", "_hist_slots", "_history")

    def __init__(self, window_s: float = DEFAULT_WINDOW_S,
                 buckets: int = DEFAULT_WINDOW_BUCKETS,
                 max_per_bucket: int = 512,
                 history_s: float = DEFAULT_HISTORY_S,
                 history_res_s: float = DEFAULT_HISTORY_RES_S):
        self.width = window_s / buckets
        self.buckets = buckets
        self.max_per_bucket = max_per_bucket
        self._epochs = [-1] * buckets
        self._counts = [0] * buckets
        self._sums = [0.0] * buckets
        self._maxs = [0.0] * buckets
        self._samples: list[list[float]] = [[] for _ in range(buckets)]
        self._rng = random.Random(0)
        self.history_res = max(history_res_s, self.width)
        self._hist_slots = max(1, int(history_s / self.history_res))
        # slot index (monotonic // history_res) → [count, sum, max];
        # a dict (not a deque) because lazy retirement delivers buckets
        # out of order by up to a ring span
        self._history: dict[int, list[float]] = {}

    def _retire(self, epoch: int, count: int, vsum: float,
                vmax: float) -> None:
        """Fold an expiring live bucket into its history slot and
        prune slots past the horizon — bounded memory by construction."""
        slot = int(epoch * self.width / self.history_res)
        h = self._history.get(slot)
        if h is None:
            self._history[slot] = [count, vsum, vmax]
            if len(self._history) > self._hist_slots:
                lo = slot - self._hist_slots
                for s in [s for s in self._history if s <= lo]:
                    del self._history[s]
        else:
            h[0] += count
            h[1] += vsum
            if vmax > h[2]:
                h[2] = vmax

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        e = int(now / self.width)
        i = e % self.buckets
        if self._epochs[i] != e:
            if self._counts[i]:
                self._retire(self._epochs[i], self._counts[i],
                             self._sums[i], self._maxs[i])
            self._epochs[i] = e
            self._counts[i] = 0
            self._sums[i] = 0.0
            self._maxs[i] = 0.0
            self._samples[i] = []
        self._sums[i] += value
        if value > self._maxs[i]:
            self._maxs[i] = value
        n = self._counts[i] = self._counts[i] + 1
        s = self._samples[i]
        if len(s) < self.max_per_bucket:
            s.append(value)
        else:
            j = self._rng.randrange(n)
            if j < self.max_per_bucket:
                s[j] = value

    def history(self, now: Optional[float] = None) -> list[dict]:
        """Retained + live points, oldest first, one per history slot:
        ``{"t": slot start (monotonic s), "count", "sum", "max"}``.
        Live buckets (not yet retired) merge in on read, so the series
        is current without waiting for expiry."""
        now = time.monotonic() if now is None else now
        lo = int(now / self.history_res) - self._hist_slots
        merged: dict[int, list[float]] = {
            s: list(v) for s, v in self._history.items() if s > lo}
        for i in range(self.buckets):
            if self._epochs[i] < 0 or not self._counts[i]:
                continue
            slot = int(self._epochs[i] * self.width / self.history_res)
            if slot <= lo:
                continue
            h = merged.get(slot)
            if h is None:
                merged[slot] = [self._counts[i], self._sums[i],
                                self._maxs[i]]
            else:
                h[0] += self._counts[i]
                h[1] += self._sums[i]
                if self._maxs[i] > h[2]:
                    h[2] = self._maxs[i]
        return [{"t": slot * self.history_res, "count": int(c),
                 "sum": s, "max": m}
                for slot, (c, s, m) in sorted(merged.items())]

    def stats(self, now: Optional[float] = None,
              window_s: Optional[float] = None) -> tuple[int, list]:
        """(true count, merged samples) over the live window — or over
        the trailing ``window_s`` seconds when narrower than the ring."""
        now = time.monotonic() if now is None else now
        e = int(now / self.width)
        span = self.buckets
        if window_s is not None:
            span = max(1, min(span, math.ceil(window_s / self.width)))
        lo = e - span + 1
        count = 0
        merged: list[float] = []
        for i in range(self.buckets):
            if self._epochs[i] >= lo:
                count += self._counts[i]
                merged.extend(self._samples[i])
        return count, merged

    def sum(self, now: Optional[float] = None,
            window_s: Optional[float] = None) -> float:
        """EXACT sum of every value observed inside the window. The
        quantile reads above ride a bounded reservoir, but each bucket
        also keeps a running sum, so rate reads (the placement heat
        planner's ops/s and bytes/s) never lose mass to sampling."""
        now = time.monotonic() if now is None else now
        e = int(now / self.width)
        span = self.buckets
        if window_s is not None:
            span = max(1, min(span, math.ceil(window_s / self.width)))
        lo = e - span + 1
        return sum(self._sums[i] for i in range(self.buckets)
                   if self._epochs[i] >= lo)

    def quantile(self, p: float, now: Optional[float] = None) -> float:
        _, merged = self.stats(now)
        return percentile(sorted(merged), p)


class MetricsRegistry:
    """The process-wide labeled metric store (see module docstring)."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES):
        self._lock = threading.Lock()
        self._max_series = max_series
        # name -> {sorted-label-tuple -> value}
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._observations: dict[str, dict[tuple, _Series]] = {}
        self._windows: dict[str, dict[tuple, WindowedSeries]] = {}
        # (tier, weakref-to-Counters) — scrape aggregates the live ones
        self._tiers: list[tuple[str, weakref.ref]] = []
        self.series_dropped = 0

    # ------------------------------------------------------------ write API

    @holds_lock("MetricsRegistry._lock")
    def _labelset(self, table: dict, name: str, labels: dict) -> tuple:
        """The bounded label key for (name, labels) — the overflow
        bucket once the name's cardinality budget is spent. Caller must
        hold ``self._lock`` (every public writer does)."""
        key = tuple(sorted(labels.items()))
        series = table.setdefault(name, {})
        if key not in series and len(series) >= self._max_series:
            self.series_dropped += 1
            return (("overflow", "true"),)
        return key

    def inc(self, name: str, by: float = 1, **labels) -> None:
        with self._lock:
            key = self._labelset(self._counters, name, labels)
            table = self._counters[name]
            table[key] = table.get(key, 0) + by

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = self._labelset(self._gauges, name, labels)
            self._gauges[name][key] = value

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = self._labelset(self._observations, name, labels)
            series = self._observations[name].setdefault(key, _Series())
            series.add(value)

    def observe_windowed(self, name: str, value: float,
                         now: Optional[float] = None, **labels) -> None:
        """Record into the windowed twin of a summary series.

        Called per sampled boxcar / batch, never per op — the registry
        lock stays off the op hot path. ``now`` (monotonic seconds) is
        injectable so SLO tests can drive a frozen clock."""
        with self._lock:
            key = self._labelset(self._windows, name, labels)
            series = self._windows[name].setdefault(key, WindowedSeries())
            series.observe(value, now)

    def window_stats(self, name: str, now: Optional[float] = None,
                     window_s: Optional[float] = None,
                     quantiles: tuple = (0.5, 0.99),
                     **labels) -> tuple[int, dict]:
        """(count, {q: value}) over the live window, merged across every
        label set matching the (subset) filter — e.g. ``pair=...`` alone
        merges all tenants of that pair."""
        want = [(k, str(v)) for k, v in labels.items()]
        with self._lock:
            table = self._windows.get(name, {})
            matched = [ws for key, ws in table.items()
                       if all(kv in key for kv in want)]
        count = 0
        merged: list[float] = []
        for ws in matched:
            c, s = ws.stats(now, window_s)
            count += c
            merged.extend(s)
        merged.sort()
        return count, {q: percentile(merged, q) for q in quantiles}

    def window_sum(self, name: str, now: Optional[float] = None,
                   window_s: Optional[float] = None, **labels) -> float:
        """Exact windowed sum merged across every label set matching
        the (subset) filter — the rate read behind the per-partition
        heat signal (``window_stats`` answers "how slow", this answers
        "how much")."""
        want = [(k, str(v)) for k, v in labels.items()]
        with self._lock:
            table = self._windows.get(name, {})
            matched = [ws for key, ws in table.items()
                       if all(kv in key for kv in want)]
        return sum(ws.sum(now, window_s) for ws in matched)

    def register_tier(self, tier: str, counters: Counters) -> None:
        """Track a tier's Counters weakly: the hot path keeps writing
        its private instance, the scrape reads whatever is still
        alive."""
        with self._lock:
            self._tiers = [(t, r) for t, r in self._tiers
                           if r() is not None]
            self._tiers.append((tier, weakref.ref(counters)))

    # ------------------------------------------------------------- read API

    def _tier_snapshot(self) -> tuple[dict, dict]:
        """Aggregate registered tier Counters → (counts, observations),
        both keyed (name, (("tier", t),))."""
        counts: dict[tuple, float] = {}
        obs: dict[tuple, _Series] = {}
        with self._lock:
            live = [(t, r()) for t, r in self._tiers]
        for tier, c in live:
            if c is None:
                continue
            key = (("tier", tier),)
            # list() the views: the owning tier keeps mutating its
            # instance while we read
            for name, v in list(c._counts.items()):
                counts[(name, key)] = counts.get((name, key), 0) + v
            for name, vals in list(c._values.items()):
                s = obs.setdefault((name, key), _Series())
                s.count += c._observed[name]
                s.samples.extend(list(vals))
        return counts, obs

    def scrape(self) -> str:
        """Prometheus text exposition of everything the process knows."""
        tier_counts, tier_obs = self._tier_snapshot()
        with self._lock:
            counters = {n: dict(t) for n, t in self._counters.items()}
            gauges = {n: dict(t) for n, t in self._gauges.items()}
            observations = {n: dict(t)
                            for n, t in self._observations.items()}
            # snapshot windowed stats under the lock: (count, samples)
            # per live window, rendered as summaries below
            windows = {
                n: {key: ws.stats() for key, ws in t.items()}
                for n, t in self._windows.items()}
            dropped = self.series_dropped
        for (name, key), v in tier_counts.items():
            counters.setdefault(name, {})
            counters[name][key] = counters[name].get(key, 0) + v
        for (name, key), s in tier_obs.items():
            observations.setdefault(name, {})
            have = observations[name].setdefault(key, _Series())
            have.count += s.count
            have.samples.extend(s.samples)
        counters.setdefault("obs.series.dropped", {})[()] = (
            counters.get("obs.series.dropped", {}).get((), 0) + dropped)

        lines: list[str] = []
        for name in sorted(counters):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            for key in sorted(counters[name]):
                lines.append(
                    f"{pn}{_prom_labels(key)} {counters[name][key]:g}")
        for name in sorted(gauges):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            for key in sorted(gauges[name]):
                lines.append(
                    f"{pn}{_prom_labels(key)} {gauges[name][key]:g}")
        for name in sorted(observations):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} summary")
            for key in sorted(observations[name]):
                s = observations[name][key]
                vals = sorted(s.samples)
                for q in (0.5, 0.99):
                    lines.append(
                        f"{pn}{_prom_labels(key + (('quantile', q),))} "
                        f"{percentile(vals, q):g}")
                lines.append(
                    f"{pn}_count{_prom_labels(key)} {s.count:g}")
                lines.append(
                    f"{pn}_sum{_prom_labels(key)} {sum(s.samples):g}")
        for name in sorted(windows):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} summary")
            for key in sorted(windows[name]):
                count, samples = windows[name][key]
                vals = sorted(samples)
                for q in (0.5, 0.99):
                    lines.append(
                        f"{pn}{_prom_labels(key + (('quantile', q),))} "
                        f"{percentile(vals, q):g}")
                lines.append(f"{pn}_count{_prom_labels(key)} {count:g}")
                lines.append(
                    f"{pn}_sum{_prom_labels(key)} {sum(samples):g}")
        return "\n".join(lines) + "\n"


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (lazily constructed singleton)."""
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def reset_registry() -> None:
    """Drop the singleton (test isolation only)."""
    global _registry
    with _registry_lock:
        _registry = None


def tier_counters(tier: str) -> Counters:
    """A fresh per-instance ``Counters`` registered under ``tier``.

    THE way production code obtains a Counters (the fluidlint
    ``metric-name`` pass bans bare ``Counters()`` construction outside
    this module): call sites keep their instance semantics and their
    lock-free hot path, and the process scrape sees every live
    instance, summed per (name, tier).
    """
    c = Counters()
    get_registry().register_tier(tier, c)
    return c


def tier_snapshot(tier: str) -> dict:
    """Summed counter snapshot across every live Counters instance
    registered under ``tier`` (``tier_counters`` hands out per-instance
    objects; this is the process-wide read the admin plane and the
    chaos verdicts use)."""
    counts, _ = get_registry()._tier_snapshot()
    key = (("tier", tier),)
    return {name: v for (name, k), v in counts.items() if k == key}


def parse_prometheus(text: str) -> dict:
    """Parse text exposition → {name: {label-tuple: value}}.

    The reader half of :meth:`MetricsRegistry.scrape` (quantile labels
    included verbatim), used by tools/net_smoke.py and bench.py to
    consume ``admin_metrics_scrape`` output without a client library.
    """
    out: dict[str, dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            metric, sval = line.rsplit(None, 1)
            value = float(sval)
        except ValueError:
            raise ValueError(f"unparseable prometheus sample: {line!r}")
        if "{" in metric:
            name, rest = metric.split("{", 1)
            if not rest.endswith("}"):
                raise ValueError(f"unterminated label set: {line!r}")
            labels = []
            body = rest[:-1]
            while body:
                k, body = body.split("=", 1)
                if not body.startswith('"'):
                    raise ValueError(f"unquoted label value: {line!r}")
                # find the closing quote, honoring backslash escapes
                i, esc, out_chars = 1, False, []
                while i < len(body):
                    ch = body[i]
                    if esc:
                        # exposition escapes: \\ \" and \n (the writer
                        # half in _prom_labels emits exactly these)
                        out_chars.append("\n" if ch == "n" else ch)
                        esc = False
                    elif ch == "\\":
                        esc = True
                    elif ch == '"':
                        break
                    else:
                        out_chars.append(ch)
                    i += 1
                labels.append((k, "".join(out_chars)))
                body = body[i + 1:].lstrip(",")
            key = tuple(labels)
        else:
            name, key = metric, ()
        out.setdefault(name, {})[key] = value
    return out
