"""card_wait_us_per_op.flood: host microseconds an op spends
blocked on the card: the program's span ``applier.sync`` at every wait
(the staging set's rotation fence, the overflow poll, the closing
drain), nested in a stage or not."""

from portbench.yardstick.program import us_per_op

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("applier.sync", "seconds"))
