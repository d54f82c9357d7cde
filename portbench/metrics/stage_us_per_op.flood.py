"""stage_us_per_op.flood: host microseconds an op spends in the farm's
stage half (pack, scatter into pinned buffers, ``non_blocking`` copy),
a part of each flush: the program's counters ``stage_seconds`` over
``ops_applied``."""

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    ops = run.counts.get("ops_applied")
    if not ops or "acked_ops" not in run.counts:
        return None
    return run.counts["stage_seconds"] / ops * 1e6
