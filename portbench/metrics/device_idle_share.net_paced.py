"""device_idle_share.net_paced: the share of the window in which no
kernel or copy ran on the card the stage's farm holds, from
torch.profiler's device intervals in the harness's process."""

LAYER = "device"
MOVES = "ops_per_s"


def read(run):
    if run.trace is None or "core_spans" not in run.counts:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
