"""checkpoint_write_share.net_paced: the share of the applier stage's
checkpoint time spent compressing and writing the farm's file: the
program's counter ``stage.checkpoint.write_s`` over its span
``stage.checkpoint``."""

from portbench.yardstick.program import snapshot

LAYER = "applier stage"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "core_spans" not in run.counts:
        return None
    seconds = snap["spans"].get("stage.checkpoint", {}).get("seconds")
    if not seconds:
        return None
    return 100.0 * snap["counters"].get("stage.checkpoint.write_s", 0.0) \
        / seconds
