"""Where the service path's time goes on one card: a torch.profiler trace.

    python3 -m fluidframework_tpu_torch.tools.profile_service \
        [--switch-interval SECONDS]

Runs ``service/load_gen.run_inproc`` at ``chip_smoke.py``'s service
geometry (1024 docs × 2 clients × 48 ops, boxcars of 24, array lane, the
async applier with ``min_wave_ops=32768``) once to warm up and once under
``torch.profiler`` (CPU and CUDA activities). Prints one JSON line: the
run's wall seconds, the card's busy time (the union of every kernel and
copy interval the profiler saw on the card) and idle share, the device
time of the 12 costliest kernels, and the applier's stage/execute split;
then the card's name and power limit. ``--switch-interval`` sets the
interpreter's thread switch interval first (``sys.setswitchinterval``),
to show whether the worker's wall time moves with how often the GIL
changes hands. Fails when the profiler sees no device activity.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import cuda_apply
from ..service.gpu_applier import GpuDocumentApplier
from ..service.load_gen import run_inproc

RUN = dict(n_docs=1024, clients_per_doc=2, ops_per_client=48, batch_size=24,
           flush_every=4096, seed=3, array_lane=True)
APPLIER = dict(max_docs=1024, max_slots=256, ops_per_dispatch=32,
               async_dispatch=True, min_wave_ops=32768)


def _device_time_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, name):
            return float(getattr(avg, name))
    return 0.0


def _busy_us(events) -> float:
    """Length of the union of the device intervals (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def run_once(**applier):
    app = GpuDocumentApplier(device="cuda", **{**APPLIER, **applier})
    try:
        stats = run_inproc(applier=app, **RUN)
    finally:
        app.close()
    return stats, app


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--switch-interval", type=float)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_service: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    cuda_apply.build()
    run_once()  # warm-up: context, kernel library, pinned buffers
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats, app = run_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s = _busy_us(prof.events()) / 1e6
    if busy_s <= 0:
        raise SystemExit("profile_service: the profiler saw no device "
                         "activity")
    kernels = sorted(
        ((a.key, _device_time_us(a) / 1e3, a.count)
         for a in prof.key_averages() if _device_time_us(a) > 0),
        key=lambda k: -k[1])
    print(json.dumps({
        "wall_seconds": wall, "run_seconds": stats.seconds,
        "ops_per_sec": stats.ops_per_sec,
        "device_busy_seconds": busy_s,
        "device_idle_share": 1 - busy_s / wall,
        "kernels_ms": [{"name": k, "ms": ms, "count": n}
                       for k, ms, n in kernels[:12]],
        "dispatches": app.dispatches, "stage_seconds": app.stage_seconds,
        "exec_seconds": app.exec_seconds,
        "exec_device_seconds": app.exec_device_seconds,
        "stage_overlap_ratio": app.stage_overlap_ratio(),
        "switch_interval": sys.getswitchinterval(), "card": card}),
        flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
