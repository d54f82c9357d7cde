"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its ``configs`` entry names;
- a traffic mix: ``portbench/traffic/<traffic>.json``, which names the
  general driver that reads it (``portbench/drivers/<driver>.py``);
- a metric: ``portbench/metrics/<name>.py``, a reader with ``read(run)``.

A later cell, mix or metric is a new file and a new entry: nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    return json.loads(
        (Path(root) / "portbench" / "traffic" / f"{name}.json").read_text())


def _load(path: Path):
    mod_name = "portbench_" + re.sub(r"\W", "_", str(path))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(root: Path, name: str):
    """The general driver module ``portbench/drivers/<name>.py``."""
    return _load(Path(root) / "portbench" / "drivers" / f"{name}.py")


def reader(root: Path, name: str):
    """The reader module of metric ``name``."""
    return _load(Path(root) / "portbench" / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics with ``trace`` off, its per-layer metrics with it on. An
    entry without ``workloads`` belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]
