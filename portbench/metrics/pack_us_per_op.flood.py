"""pack_us_per_op.flood: host microseconds an op spends in the farm's
columnar pack, a part of each flush, which turns the array boxcars
recorded at ingest into op rows: the program's span ``applier.pack``. A
program that packs each boxcar at ingest has no such span, and the
metric stays silent there."""

from portbench.yardstick.program import snapshot, us_per_op

LAYER = "applier ingest"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "applier.pack" not in snap["spans"]:
        return None
    return us_per_op(run, ("applier.pack", "seconds"))
