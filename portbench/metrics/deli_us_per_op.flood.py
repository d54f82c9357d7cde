"""deli_us_per_op.flood: host microseconds an op spends in deli's
ticketing: the program's span ``deli``, one a boxcar, around deli's
handler at the ordered log's delivery seam."""

from portbench.yardstick.program import us_per_op

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("deli", "seconds"))
