"""ingest_us_per_op.flood: host microseconds an op spends in the farm's
``ingest_array_batch`` on the caller's thread (the harness's span around
each call)."""

LAYER = "applier ingest"
MOVES = "ops_per_s"


def read(run):
    ops = run.counts.get("acked_ops")
    if not ops or "ingest" not in run.spans:
        return None
    return run.counts["ingest_s"] / ops * 1e6
