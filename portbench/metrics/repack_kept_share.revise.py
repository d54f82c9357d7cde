"""repack_kept_share.revise: the slots the farm's repacks of the window
left, as a share of the slots they took in (the program's counters
``applier.repack.slots_out`` over ``applier.repack.slots_in``). A program
without the repack, or a window without one, leaves the metric silent."""

from portbench.yardstick.program import snapshot

LAYER = "applier repack"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "acked_ops" not in run.counts:
        return None
    slots_in = snap["counters"].get("applier.repack.slots_in", 0)
    if not slots_in:
        return None
    return 100.0 * snap["counters"].get("applier.repack.slots_out", 0) \
        / slots_in
