"""sessions_us_per_op.flood: host microseconds an op spends in the
sessions' op callbacks: the program's span ``session`` around each
``ServerConnection._deliver_ops`` a publish makes (in this cell the
in-process clients' own code)."""

from portbench.yardstick.program import us_per_op

LAYER = "client delivery"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("session", "seconds"))
