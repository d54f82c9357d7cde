"""BENCHMARK.json's shape, the pieces it names found by name, and a cell
added as files only."""

from __future__ import annotations

import ast
import hashlib
import json
import re
from pathlib import Path

import pytest

from portbench import spec
from portbench.run import run_cell

from .conftest import REPO

BENCH = spec.load_benchmark(REPO)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_whys():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    w = spec.workload(BENCH, cell)
    assert w["chips"] == 1
    cfg = spec.config(REPO, BENCH, w["config"])
    assert cfg["name"] == w["config"]
    mix = spec.traffic(REPO, w["traffic"])
    drv = spec.driver(REPO, mix["driver"])
    assert hasattr(drv, "Driver")
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, cell, False)]
    layer = spec.cell_metrics(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_matches_its_entry(entry):
    mod = spec.reader(REPO, entry["name"])
    assert callable(mod.read)
    if "layer" in entry:
        assert mod.LAYER == entry["layer"]
        assert mod.MOVES == entry["moves"]


def test_configs_are_files_of_their_own_used_by_a_cell():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert c["name"] in used
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["guarantees"] and cfg["assumed"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax",
                                  "fluidframework_tpu"}
        assert not found, (path, found)


def test_the_plain_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__"}, path


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(root.rglob("*")) if p.is_file()}


DUMMY_READER = '''"""dummy_boxcars_per_s: boxcars acked a second in a later cell."""

LAYER = "ordering pipeline"
MOVES = "dummy_ops_per_s"


def read(run):
    n = run.counts.get("acked_ops")
    return None if not n else n / 6 / run.window_s
'''
DUMMY_E2E = '''"""dummy_ops_per_s: a later cell's own end-to-end metric."""

LAYER = "end to end"


def read(run):
    n = run.counts.get("acked_ops")
    return None if not n else n / run.window_s
'''


def test_a_cell_is_added_as_files_only(tiny_root, one_thread):
    """A later PR's cell: a new configuration file, traffic file and
    metric readers, and new entries in BENCHMARK.json. No file the
    benchmark has is edited, and the new cell runs."""
    before = _digests(tiny_root / "portbench")
    pb = tiny_root / "portbench"
    cfg = json.loads((pb / "configs" / "loadtest_1k.json").read_text())
    cfg.update(name="dummy", docs=3, clients_per_doc=2)
    cfg["applier"]["max_docs"] = 3
    (pb / "configs" / "dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "flood.json").read_text())
    mix.update(boxcar=6, remove_fraction=0.2, annotate_fraction=0.3)
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "dummy_boxcars_per_s.py").write_text(DUMMY_READER)
    (pb / "metrics" / "dummy_ops_per_s.py").write_text(DUMMY_E2E)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org",
                             "file": "portbench/configs/dummy.json",
                             "reduced": [], "why": "a test's cell"})
    bench["workloads"].append({"name": "dummy.mix", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test's cell"})
    bench["end_to_end"].append({"name": "dummy_ops_per_s", "unit": "ops/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.mix"]})
    bench["per_layer"].append({"name": "dummy_boxcars_per_s",
                               "unit": "boxcars/s", "better": "higher",
                               "source": "host_clock",
                               "layer": "ordering pipeline",
                               "moves": "dummy_ops_per_s",
                               "workloads": ["dummy.mix"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before
    out = run_cell(tiny_root, "dummy.mix", 77, 0.3, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"dummy_ops_per_s", "setup_s"}
    out = run_cell(tiny_root, "dummy.mix", 78, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    assert "dummy_boxcars_per_s" in out["metrics"]
