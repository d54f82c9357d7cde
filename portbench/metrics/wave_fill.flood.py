"""wave_fill.flood: the share of a wave's [D, K] op rows that carry an
op, over every wave of the window: the program's counters
``applier.wave.rows`` over ``applier.wave.slots``, counted where each
wave is staged."""

from portbench.yardstick.program import snapshot

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "acked_ops" not in run.counts:
        return None
    slots = snap["counters"].get("applier.wave.slots")
    if not slots:
        return None
    return 100.0 * snap["counters"]["applier.wave.rows"] / slots
