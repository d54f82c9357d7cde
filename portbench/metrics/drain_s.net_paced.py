"""drain_s.net_paced: seconds from the end of the traffic's schedule to
the end of the window: the last acks, then the stage's drain to every
doc's last acked seq and its checkpoint."""

LAYER = "applier stage"
MOVES = "ops_per_s"


def read(run):
    if "core_spans" not in run.counts:
        return None
    return run.counts["drain_s"]
