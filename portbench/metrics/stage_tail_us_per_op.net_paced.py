"""stage_tail_us_per_op.net_paced: host microseconds an op spends in the
applier stage's tail of the durable log: the program's spans
``stage.poll`` (the log's poll) and ``stage.drain`` (delivery into the
farm, ``applier.ingest`` nested), in the harness's process, which runs
the stage."""

from portbench.yardstick.program import snapshot

LAYER = "applier stage"
MOVES = "ops_per_s"


def read(run):
    snap = snapshot()
    ops = run.counts.get("acked_ops")
    if (snap is None or not ops or "core_spans" not in run.counts
            or "stage.poll" not in snap["spans"]):
        return None
    spans = snap["spans"]
    seconds = sum(spans.get(name, {}).get("seconds", 0.0)
                  for name in ("stage.poll", "stage.drain"))
    return seconds / ops * 1e6
