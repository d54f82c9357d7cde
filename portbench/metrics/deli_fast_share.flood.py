"""deli_fast_share.flood: the share of array boxcars that deli ticketed
on its array fast lane, against those it sent to the scalar lane: the
program's counters ``deli.array.fast`` and ``deli.array.fallback``,
counted while tracing. A program without the counters leaves the metric
silent."""

from portbench.yardstick.program import snapshot

LAYER = "ordering pipeline"
MOVES = "ack_p95_ms"


def read(run):
    snap = snapshot()
    if snap is None or "acked_ops" not in run.counts:
        return None
    fast = snap["counters"].get("deli.array.fast", 0)
    fallback = snap["counters"].get("deli.array.fallback", 0)
    if not fast + fallback:
        return None
    return 100.0 * fast / (fast + fallback)
