"""launch_us_per_op.flood: host microseconds an op spends launching
the farm's waves: the program's span ``applier.execute`` (unpack, the
apply kernel and zamboni's launches, the completion markers)."""

from portbench.yardstick.program import us_per_op

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("applier.execute", "seconds"))
