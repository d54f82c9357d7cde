"""entry_us_per_op.flood: host microseconds an op spends in the
server's own part of a submit: the self time of the program's span
``server.submit`` (the entry checks, the flight event, the orderer's
append and the log's drain loop): its time less the spans inside it."""

from portbench.yardstick.program import us_per_op

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("server.submit", "self_seconds"))
