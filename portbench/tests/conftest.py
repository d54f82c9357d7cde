"""Shared fixtures of the benchmark's own tests.

Run from the root of the repository: ``python -m pytest portbench/tests``.
Tests marked ``card`` need a CUDA card; they decide inside the test
whether one is there, and skip without it.

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``portbench/``) in a temporary directory whose configurations and traffic
are shrunk to sizes the CPU runs in seconds, with the same keys.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {
    "loadtest_1k": {"docs": 4, "clients_per_doc": 3, "warmup_docs": 2,
                    "warmup_rounds": 1, "flush_every": 96,
                    "applier": {"max_docs": 4, "max_slots": 1024},
                    "check": {"sample_docs": 3, "control_every": 5}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def shrink(root: Path) -> None:
    """Shrink the configurations of the benchmark at ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        for key, val in TINY.get(entry["name"], {}).items():
            if isinstance(val, dict):
                cfg[key] = {**cfg[key], **val}
            else:
                cfg[key] = val
        path.write_text(json.dumps(cfg))


def copy_benchmark(dest: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_benchmark(tmp_path)
    shrink(root)
    return root


@pytest.fixture
def one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
