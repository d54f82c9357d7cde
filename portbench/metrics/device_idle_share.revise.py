"""device_idle_share.revise: the share of the window in which no kernel
or copy ran on the card, from torch.profiler's device intervals."""

LAYER = "device"
MOVES = "ops_per_s"


def read(run):
    if run.trace is None or "acked_ops" not in run.counts:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
