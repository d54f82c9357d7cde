"""dispatch_us_per_op.flood: host microseconds an op spends in the farm's
dispatch on the service's thread: the harness's spans around each
``flush`` (the waves' stage and execute halves, the overflow poll) and
the closing ``finalize``."""

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    ops = run.counts.get("acked_ops")
    if not ops or "flush" not in run.spans:
        return None
    return run.counts["dispatch_s"] / ops * 1e6
