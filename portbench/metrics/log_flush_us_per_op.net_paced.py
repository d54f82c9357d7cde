"""log_flush_us_per_op.net_paced: host microseconds an op
spends in the durable log's flush that gates every ingress batch's acks
(ROADMAP C12): the core's span ``log.flush`` around ``_flush_dirty``."""

LAYER = "durable log"
MOVES = "ops_per_s"


def read(run):
    snap = run.counts.get("core_spans")
    ops = run.counts.get("acked_ops")
    if not snap or not ops or "log.flush" not in snap["spans"]:
        return None
    return snap["spans"]["log.flush"]["seconds"] / ops * 1e6
