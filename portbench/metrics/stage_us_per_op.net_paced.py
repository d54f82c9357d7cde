"""stage_us_per_op.net_paced: host microseconds an op spends in the
applier stage's farm staging its waves (pack, scatter into pinned
buffers, ``non_blocking`` copy): the program's span ``applier.stage``,
in the harness's process, which runs the stage."""

from portbench.yardstick.program import us_per_op

LAYER = "applier dispatch"
MOVES = "ops_per_s"


def read(run):
    if "core_spans" not in run.counts:
        return None
    return us_per_op(run, ("applier.stage", "seconds"))
