"""store_us_per_op.flood: host microseconds an op spends storing the
sequenced stream: the program's spans ``scriptorium`` and ``scribe``, one
a boxcar each, at the ordered log's delivery seam."""

from portbench.yardstick.program import us_per_op

LAYER = "ordering pipeline"
MOVES = "ops_per_s"


def read(run):
    return us_per_op(run, ("scriptorium", "seconds"),
                     ("scribe", "seconds"))
