"""The benchmark's in-process loop cells at a tiny size on the CPU:
``longlived_1k.revise`` (docs aged through the submit path in set-up, then
a closed loop) and ``loadtest_1k.paced`` (Poisson boxcars, the ack timed
from the due instant), both through ``portbench/drivers/inproc_loop.py``.

A sound run of each is correct with every check at 0, and the aged docs
repack in the window instead of escalating; the control, which ingests a
boxcar twice, is caught; a traced run reads the repack, escalation and
device readers; and a program whose farm has no repack counters fails the
aged cell at once with a message naming them, while it still runs the
paced cell.
"""

from __future__ import annotations

import json
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from torch.profiler import ProfilerActivity, profile

from portbench import run, spec
from portbench.tests.conftest import copy_benchmark

REVISE, PACED = "longlived_1k.revise", "loadtest_1k.paced"
SECONDS = 1.5
TINY = {"docs": 4, "clients_per_doc": 3, "warmup_docs": 2,
        "warmup_rounds": 1, "flush_every": 96,
        "check": {"sample_docs": 3, "control_every": 5}}
#: the aged docs at the tiny size: S=256, K=8 (watermark 240), histories
#: that carry each doc past its slots unmerged
AGED = {"history_ops": [500, 700], "history_boxcar": 24}
READERS = ("repack_us_per_op.revise", "repack_kept_share.revise",
           "escalated_docs.revise")


@pytest.fixture
def loop_root(tmp_path, monkeypatch):
    """A copy of the benchmark with both configurations cut to the tiny
    size and the paced rate cut to what the CPU farm takes."""
    root = copy_benchmark(tmp_path)
    for name, extra in (("loadtest_1k", {}), ("longlived_1k", AGED)):
        path = root / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(TINY, **extra)
        cfg["applier"] = {**cfg["applier"], "max_docs": TINY["docs"],
                          "max_slots": 256, "ops_per_dispatch": 8}
        path.write_text(json.dumps(cfg))
    path = root / "portbench" / "traffic" / "paced.json"
    mix = json.loads(path.read_text())
    mix["rate"] = 1500.0
    path.write_text(json.dumps(mix))
    # this test process has JAX loaded (tests/conftest.py); the run's own
    # check that the program loads none is the benchmark's tests' to make
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    return root


def _patch_driver(monkeypatch, change):
    """Have ``run_cell`` load the cell's driver through ``change(module)``."""
    load = spec.driver

    def driver(root, name):
        mod = load(root, name)
        change(mod)
        return mod

    monkeypatch.setattr(spec, "driver", driver)


def _failed(out) -> set:
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("cell", [REVISE, PACED])
def test_a_sound_run_is_correct(loop_root, monkeypatch, cell):
    notes = {}

    def change(mod):
        base = mod.Driver

        class Driver(base):
            def check(self):
                out = super().check()
                notes.update(self.notes, repacked=self.svc.applier
                             .doc_repacks.sum())
                return out
        mod.Driver = Driver

    _patch_driver(monkeypatch, change)
    out = run.run_cell(loop_root, cell, 2**40 + 3, SECONDS, False,
                       device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ops_per_s", "setup_s"}
    assert {"ack_count_error", "client_order_errors", "seq_gaps",
            "logged_minus_acked_ops", "unapplied_ops", "over_applied_ops",
            "docs_differing"} == set(out["checks"])
    assert notes["escalated_docs"].startswith("0 ")
    if cell == REVISE:
        assert notes["docs_repacked_in_window"] > 0
        assert notes["repacked"] > 0
        assert "history_ops" in notes
    else:
        assert "boxcars of 24 due in" in notes["offered"]


@pytest.mark.parametrize("cell", [REVISE, PACED])
def test_the_control_is_not_correct(loop_root, cell):
    out = run.run_cell(loop_root, cell, 7, SECONDS, False, device="cpu",
                       control="at_least_once")
    assert not out["correct"]
    failed = _failed(out)
    assert "over_applied_ops" in failed
    assert failed <= {"unapplied_ops", "over_applied_ops", "docs_differing"}


def test_a_traced_run_reads_the_repack_readers(loop_root, monkeypatch):
    """With a CPU profiler around the window (as a traced run on the card
    has), the repack and escalation readers read numbers; the device's
    idle share reads the card's trace, which a CPU run has not."""
    from fluidframework_tpu_torch.utils.telemetry import SPANS

    def change(mod):
        base = mod.Driver

        class Driver(base):
            def window(self, seconds):
                with profile(activities=[ProfilerActivity.CPU]):
                    super().window(seconds)
        mod.Driver = Driver

    _patch_driver(monkeypatch, change)
    SPANS.reset()
    try:
        out = run.run_cell(loop_root, REVISE, 2**33 + 5, 2.5, True,
                           device="cpu")
    finally:
        SPANS.reset()
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) == set(got)
    assert got["repack_us_per_op.revise"] > 0
    assert 0 < got["repack_kept_share.revise"] < 100
    assert got["escalated_docs.revise"] == 0
    idle = spec.reader(loop_root, "device_idle_share.revise")
    traced = run.Run(setup_s=1.0)
    traced.counts = {"acked_ops": 1}
    traced.trace = {"busy_s": 0.25, "window_s": 1.0}
    assert idle.read(traced) == 75.0
    traced.trace = None
    assert idle.read(traced) is None


def _without_repack(monkeypatch):
    """The farm as a program without the repack has it: no counters."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    init = GpuDocumentApplier.__init__

    def bare(self, *args, **kwargs):
        init(self, *args, **kwargs)
        for name in ("doc_repacks", "repack_slots_in", "repack_slots_out",
                     "repack_escalations", "host_ops_applied"):
            delattr(self, name)

    monkeypatch.setattr(GpuDocumentApplier, "__init__", bare)


def test_a_farm_without_the_repack_fails_the_aged_cell_at_once(
        loop_root, monkeypatch):
    _without_repack(monkeypatch)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="no repack counters"):
        run.run_cell(loop_root, REVISE, 5, SECONDS, False, device="cpu")
    assert time.perf_counter() - t < 10


def test_a_farm_without_the_repack_runs_the_paced_cell(loop_root,
                                                      monkeypatch):
    _without_repack(monkeypatch)
    out = run.run_cell(loop_root, PACED, 11, SECONDS, False, device="cpu")
    assert out["correct"], out["checks"]
