"""packed_share.flood: the share of the farm's staged op rows that took
the flush's columnar pack, against those staged op by op (the dict lane,
and array boxcars that fall back to it): the program's counters
``applier.ingest.packed_rows`` and ``applier.ingest.direct_rows``. A
program without the counters leaves the metric silent."""

from portbench.yardstick.program import snapshot

LAYER = "applier ingest"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "acked_ops" not in run.counts:
        return None
    packed = snap["counters"].get("applier.ingest.packed_rows", 0)
    direct = snap["counters"].get("applier.ingest.direct_rows", 0)
    if not packed + direct:
        return None
    return 100.0 * packed / (packed + direct)
