"""fanout_us_per_op.flood: host microseconds an op spends in the
broadcaster's own work: the self time of the program's span
``broadcaster`` (its handler and the publish loop), less the sessions'
deliveries and the farm's ingest inside it."""

from portbench.yardstick.program import us_per_op

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("broadcaster", "self_seconds"))
