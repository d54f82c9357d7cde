"""launch_us_per_op.net_paced: host microseconds an op spends launching
the applier stage's waves: the program's span ``applier.execute``
(unpack, the apply kernel and zamboni's launches, the completion
markers)."""

from portbench.yardstick.program import us_per_op

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    if "core_spans" not in run.counts:
        return None
    return us_per_op(run, ("applier.execute", "seconds"))
