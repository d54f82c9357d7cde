"""checkpoint_bytes.net_paced: bytes the applier stage writes a
checkpoint of its farm (the compressed file): the program's counter
``stage.checkpoint.bytes`` over its span ``stage.checkpoint``'s
calls."""

from portbench.yardstick.program import snapshot

LAYER = "applier stage"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "core_spans" not in run.counts:
        return None
    calls = snap["spans"].get("stage.checkpoint", {}).get("calls")
    if not calls:
        return None
    return snap["counters"].get("stage.checkpoint.bytes", 0) / calls
