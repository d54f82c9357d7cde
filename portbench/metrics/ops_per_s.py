"""ops_per_s: ops sequenced by deli, acked to their submitter by their own
broadcast and applied by the card's farm within the window, over the
window's seconds (the farm's drain is inside the window)."""

LAYER = "end to end"


def read(run):
    acked = run.counts.get("acked_ops")
    if not acked or not run.window_s:
        return None
    return acked / run.window_s
