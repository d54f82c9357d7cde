"""escalated_docs.revise: docs the farm sent to the host replica, in the
history and the window (the program's counter ``host_escalations``)."""

LAYER = "escalation"
MOVES = "ops_per_s"


def read(run):
    if "acked_ops" not in run.counts:
        return None
    return run.counts["host_escalations"]
