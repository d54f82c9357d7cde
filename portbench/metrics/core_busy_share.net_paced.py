"""core_busy_share.net_paced: the core process's CPU seconds (user and
system, from ``/proc/<pid>/stat``) over the window's seconds, in percent:
near 100 the core's one event loop is saturated."""

LAYER = "socket tier"
MOVES = "ops_per_s"


def read(run):
    cpu = run.counts.get("core_cpu_s")
    if cpu is None or not run.window_s or "core_spans" not in run.counts:
        return None
    return 100.0 * cpu / run.window_s
