"""wave_fill.net_paced: the share of the applier stage's wave op rows
that carry an op, over every wave of the window: the program's counters
``applier.wave.rows`` over ``applier.wave.slots``."""

from portbench.yardstick.program import snapshot

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "core_spans" not in run.counts:
        return None
    slots = snap["counters"].get("applier.wave.slots")
    if not slots:
        return None
    return 100.0 * snap["counters"]["applier.wave.rows"] / slots
