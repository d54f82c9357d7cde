"""pipeline_us_per_op.flood: host microseconds an op spends in the
ordering pipeline (deli, scriptorium, scribe, the broadcaster and the
clients' callbacks): the harness's spans around each ``submit_array``
call, less the farm's ingest spans nested in them."""

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    ops = run.counts.get("acked_ops")
    if not ops or "submit" not in run.spans:
        return None
    return (run.counts["submit_s"] - run.counts["ingest_s"]) / ops * 1e6
