"""Runs one cell of the port's benchmark once and prints its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control at_least_once]

From the root of a checkout. The cell's configuration, traffic mix and
metrics are found by the names in ``BENCHMARK.json`` (``portbench/spec.py``).
The run makes its inputs from ``--seed``, sets up and warms the system
under test (``fluidframework_tpu_torch``), measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics, or with ``--trace 1`` the per-layer ones under
``torch.profiler``), ``device``, ``breakdown`` (traced runs) and last
``checks``, each compared number beside its limit. The same numbers end
standard error.

It needs a CUDA card: without one, or with fewer than the cell asks for,
it exits 2 and prints no result. It exits 3 without a result when an
import fails (a checkout without the program) or when JAX or the JAX
package is loaded once the window has closed.

``--control at_least_once`` runs the cell's control, which breaks the
exactly-once delivery into the farm (one boxcar in every
``control_every`` of the configuration is ingested twice), and must come
out not correct. The benchmark's own runs never
pass it.
"""

from __future__ import annotations

import portbench

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidframework_tpu")
CONTROLS = ("at_least_once",)


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the kernel library already builds into ``build/torch_kernels/``);
    one thread for the math libraries."""
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, setup_s: float):
        self.setup_s = setup_s
        self.window_s = 0.0
        self.counts: dict = {}
        self.samples: dict = {}
        self.spans: dict = {}
        self.trace = None  # yardstick.trace.analyse's dict, traced runs


class HostWatch:
    """The process's CPU seconds and the garbage collector's pauses
    through the window, for standard error."""

    def __init__(self):
        self.gc_pause = 0.0
        self.gc_runs = [0, 0, 0]
        self._t = 0.0
        self.cpu0 = time.process_time()
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_pause += time.perf_counter() - self._t
            self.gc_runs[info["generation"]] += 1

    def stop(self) -> dict:
        gc.callbacks.remove(self._gc)
        return {
            "window_cpu_s": round(time.process_time() - self.cpu0, 3),
            "window_gc": (f"{self.gc_pause:.3f} s in {self.gc_runs} "
                          "collections by generation"),
        }


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: str = None) -> dict:
    """Set up, measure and check one run of cell ``name``; returns the
    result line's object. ``device="cpu"`` drives the same path on the
    CPU at whatever size the configuration gives (tests only)."""
    from portbench import spec
    from portbench.yardstick.trace import Profiled, analyse

    bench = spec.load_benchmark(root)
    cell = spec.workload(bench, name)
    cfg = spec.config(root, bench, cell["config"])
    mix = spec.traffic(root, cell["traffic"])
    t = time.perf_counter()
    drv = spec.driver(root, mix["driver"]).Driver(
        cfg, mix, seed, device, trace, control)
    drv.notes["setup_before_driver_s"] = round(t - portbench.T0, 3)
    gc.collect()
    gc.freeze()
    host = HostWatch()
    run = Run(setup_s=None)
    if trace and device == "cuda":
        with Profiled() as prof:
            run.setup_s = time.perf_counter() - portbench.T0
            drv.window(seconds)
        events = prof.device_events()
    else:
        run.setup_s = time.perf_counter() - portbench.T0
        drv.window(seconds)
        events = None
    gc.unfreeze()
    drv.notes.update(host.stop())
    run.window_s = drv.window_s
    run.counts = drv.counts()
    run.samples = drv.samples
    run.spans = drv.span_arrays()
    run.trace = (analyse(events, drv.w0, drv.w1, run.spans, drv.NESTED)
                 if events is not None else None)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    if device == "cuda":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded once the window closed: {found}")
    checks = drv.check()  # frees the program's state, then the reference
    metrics = {}
    for entry in spec.cell_metrics(bench, name, trace):
        value = spec.reader(root, entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": drv.attempted, "failed": drv.failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["notes"] = drv.notes
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS)
    args = ap.parse_args(argv)
    pin_caches(ROOT)
    import torch

    from portbench import spec

    chips = spec.workload(spec.load_benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), control=args.control)
    except ImportError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    out["device"]["power_limit"] = card_power_limit()
    for key, val in out.pop("notes").items():
        print(f"portbench: {key}: {val}", file=sys.stderr)
    for key, c in out["checks"].items():
        print(f"portbench: check {key} = {c['value']} (limit "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
