"""checkpoint_readback_share.net_paced: the share of the applier stage's
checkpoint time spent reading the farm back from the card: the program's
counter ``stage.checkpoint.readback_s`` over its span
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
    return 100.0 * snap["counters"].get("stage.checkpoint.readback_s",
                                        0.0) / seconds
