"""egress_us_per_op.net_paced: host microseconds an op
spends writing the frames an ingress batch held for its flush (acks and
the fan-out to the doc's other sockets): the core's span ``net.egress``
around ``_release_held``."""

LAYER = "socket tier"
MOVES = "ops_per_s"


def read(run):
    snap = run.counts.get("core_spans")
    ops = run.counts.get("acked_ops")
    if not snap or not ops or "net.egress" not in snap["spans"]:
        return None
    return snap["spans"]["net.egress"]["seconds"] / ops * 1e6
