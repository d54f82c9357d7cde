"""repack_us_per_op.revise: host microseconds an acked op of the window
spends in the farm's repack (the program's span ``applier.repack``: the
gather of the rows over the watermark, zamboni's merge of their settled
runs, the rebuilt text arenas and the rows written back). A program
without the repack leaves the metric silent."""

from portbench.yardstick.program import us_per_op

LAYER = "applier repack"
MOVES = "ops_per_s"


def read(run):
    if "acked_ops" not in run.counts:
        return None
    return us_per_op(run, ("applier.repack", "seconds"))
