"""packed_share.net_paced: the share of the applier stage's staged op
rows that took the flush's columnar pack, against those staged op by op:
the program's counters ``applier.ingest.packed_rows`` and
``applier.ingest.direct_rows``. The stage's tail delivers the log's
columnar records through ``ingest_array_batch``."""

from portbench.yardstick.program import snapshot

LAYER = "applier ingest"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    if snap is None or "core_spans" not in run.counts:
        return None
    packed = snap["counters"].get("applier.ingest.packed_rows", 0)
    direct = snap["counters"].get("applier.ingest.direct_rows", 0)
    if not packed + direct:
        return None
    return 100.0 * packed / (packed + direct)
