"""ingress_us_per_op.net_paced: host microseconds an op
spends in the core's ingress batches less what they nest: the self time
of the core's span ``net.ingress`` (frame reads and decode, the
sessions' submit handling), from the core's recorder over the window
(``admin_spans``); ``server.submit``, the log flush and the egress
nest in it."""

LAYER = "socket tier"
MOVES = "ops_per_s"


def read(run):
    snap = run.counts.get("core_spans")
    ops = run.counts.get("acked_ops")
    if not snap or not ops or "net.ingress" not in snap["spans"]:
        return None
    return snap["spans"]["net.ingress"]["self_seconds"] / ops * 1e6
