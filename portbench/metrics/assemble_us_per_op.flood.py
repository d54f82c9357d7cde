"""assemble_us_per_op.flood: host microseconds an op spends
assembling the farm's waves: the program's span ``applier.take``, the
loop over staged docs that takes up to K rows of each."""

from portbench.yardstick.program import us_per_op

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("applier.take", "seconds"))
