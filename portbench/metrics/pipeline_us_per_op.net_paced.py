"""pipeline_us_per_op.net_paced: host microseconds an op
spends in the core's ordering pipeline: the core's span ``server.submit``
(entry, deli, scriptorium, scribe, the broadcaster and the sessions'
deliveries nested), from the core's recorder over the window."""

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    snap = run.counts.get("core_spans")
    ops = run.counts.get("acked_ops")
    if not snap or not ops or "server.submit" not in snap["spans"]:
        return None
    return snap["spans"]["server.submit"]["seconds"] / ops * 1e6
