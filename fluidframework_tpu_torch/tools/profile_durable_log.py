"""Where the durable log's time goes at the service geometry (host only).

    python3 -m fluidframework_tpu_torch.tools.profile_durable_log \
        [--dir DIR] [--caps 2048,0] [--stage DEVICE] [--profile]

Writes ``chip_smoke.py``'s service run (1024 docs × 2 clients × 48 ops,
boxcars of 24, array lane, seed 3, no applier) into a ``DurableLog`` under
``DIR`` (the system's temporary directory by default) once for each
native handle cap in ``--caps`` (``FLUID_LOG_FD_CAP``; 0 = no cap), and
reads each directory back the way a stage process does (a readonly
``DurableLog``, every deltas topic subscribed, one drain). Prints one
JSON line per cap: the core's ops/s, the read-back drain's seconds, the
files the log made and the handles left open. ``--stage DEVICE`` also
drains each log with an ``ApplierStage`` at the service geometry
(``run_once`` until drained, its logs under the same cap) on that device.
``--profile`` adds the 15 costliest functions (``cProfile``, by own time)
of every core run and stage drain, whose times it inflates. Apart from
the stage's waves the work is the host's.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import tempfile
import time

from ..service import durable_log
from ..service.durable_log import DurableLog
from ..service.load_gen import run_inproc
from ..service.stage_runner import ApplierStage

RUN = dict(n_docs=1024, clients_per_doc=2, ops_per_client=48, batch_size=24,
           flush_every=4096, seed=3, array_lane=True)


def _top(profile: cProfile.Profile, n: int = 15) -> list:
    stats = pstats.Stats(profile)
    rows = sorted(stats.stats.items(), key=lambda kv: kv[1][2],
                  reverse=True)[:n]
    return [{"function": f"{os.path.basename(f)}:{line}:{name}",
             "calls": nc, "own_seconds": tt, "cum_seconds": ct}
            for (f, line, name), (_cc, nc, tt, ct, _) in rows]


def _profiled(profile: bool, fn):
    """``fn()``'s result and, with ``profile``, its costliest functions."""
    if not profile:
        return fn(), None
    prof = cProfile.Profile()
    prof.enable()
    try:
        out = fn()
    finally:
        prof.disable()
    return out, _top(prof)


def measure(directory: str, cap: int, profile: bool,
            stage_device=None) -> dict:
    log_dir = os.path.join(directory, f"log-cap{cap}")
    os.makedirs(log_dir)
    log = DurableLog(log_dir, fd_cap=cap)
    stats, top = _profiled(profile, lambda: run_inproc(log=log, **RUN))
    t0 = time.perf_counter()
    log.flush()
    flush_seconds = time.perf_counter() - t0
    open_files = log._log.open_files()
    log.close()

    reader = DurableLog(log_dir, readonly=True, fd_cap=cap)
    delivered = [0]

    def count(_message):
        delivered[0] += 1

    t0 = time.perf_counter()
    for topic in reader.list_topics("deltas/"):
        reader.subscribe(topic, count)
    reader.poll()
    reader.drain()
    read_seconds = time.perf_counter() - t0
    reader.close()
    row = {"fd_cap": cap, "dir": directory,
           "core_ops_per_sec": stats.ops_per_sec,
           "core_seconds": stats.seconds,
           "p99_ack_ms": stats.latency_ms(0.99),
           "flush_seconds": flush_seconds,
           "read_back_seconds": read_seconds,
           "records_read": delivered[0],
           "files": len(os.listdir(log_dir)), "open_files": open_files}
    if top is not None:
        row["top"] = top
    if stage_device is not None:
        # the stage opens its logs with the module's cap, as a stage
        # process under FLUID_LOG_FD_CAP would
        durable_log.LOG_FD_CAP = cap
        t0 = time.perf_counter()
        stage = ApplierStage(log_dir, os.path.join(directory,
                                                   f"state-cap{cap}"),
                             max_docs=RUN["n_docs"], max_slots=256,
                             device=stage_device)
        row["stage_open_seconds"] = time.perf_counter() - t0

        def drain():
            while stage.run_once():
                pass

        t0 = time.perf_counter()
        _, stage_top = _profiled(profile, drain)
        row["stage_drain_seconds"] = time.perf_counter() - t0
        row["stage_dispatches"] = stage.applier.dispatches
        row["stage_last_save"] = stage.last_save
        if stage_top is not None:
            row["stage_top"] = stage_top
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dir", default=None,
                        help="parent directory of the logs (default: the "
                             "system's temporary directory)")
    parser.add_argument("--caps", default="2048,0",
                        help="comma-separated native handle caps")
    parser.add_argument("--stage", default=None, metavar="DEVICE",
                        help="also drain each log with an ApplierStage on "
                             "DEVICE")
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    caps = [int(c) for c in args.caps.split(",")]
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        for cap in caps:
            print(json.dumps(measure(tmp, cap, args.profile, args.stage)),
                  flush=True)


if __name__ == "__main__":
    main()
