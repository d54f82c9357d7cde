"""checkpoint_share.net_paced: the share of the window the applier stage
spends checkpointing its farm (flush, finalize, the whole farm's
readback and compressed write, every second and once in the closing
drain): the program's span ``stage.checkpoint`` over the window."""

from portbench.yardstick.program import snapshot

LAYER = "applier stage"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if (snap is None or not run.window_s or "core_spans" not in run.counts
            or "stage.checkpoint" not in snap["spans"]):
        return None
    return 100.0 * snap["spans"]["stage.checkpoint"]["seconds"] \
        / run.window_s
