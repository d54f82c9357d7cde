"""escalated_docs.net_paced: docs the applier stage's farm sent to the
host replica by the window's end (the program's counter
``host_escalations``; the set-up applies no edit, so every escalation is
the window's)."""

LAYER = "escalation"
MOVES = "ops_per_s"


def read(run):
    if "core_spans" not in run.counts:
        return None
    return run.counts["host_escalations"]
