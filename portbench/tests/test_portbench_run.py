"""Whole runs of each cell at a tiny size on the CPU: correct when the
program is sound, not correct under the control and under each fault
planted in the timed path; the import check; a run with no card, and
one with no program, print no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.run import forbidden_modules, run_cell

from .conftest import REPO, copy_benchmark

CELLS = ["loadtest_1k.flood"]
# long enough at the tiny size for a few flushes, a doubled boxcar under
# the control, and a second ack to a client whose ack was lost
SECONDS = 2.0


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, one_thread, cell):
    out = run_cell(tiny_root, cell, 2**31 + 99, SECONDS, False,
                   device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ops_per_s", "ack_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(c["limit"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_span_metrics(tiny_root, one_thread, cell):
    out = run_cell(tiny_root, cell, 5, SECONDS, True, device="cpu")
    assert out["correct"], out["checks"]
    want = {"loadtest_1k.flood": {"pipeline_us_per_op.flood",
                                  "ingest_us_per_op.flood",
                                  "dispatch_us_per_op.flood",
                                  "stage_us_per_op.flood",
                                  "escalated_docs.flood"}}[cell]
    assert want <= set(out["metrics"])
    # the device's metrics need a card's trace: silent here, never 0
    assert not any(k.startswith("device_idle") for k in out["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny_root, one_thread, cell):
    out = run_cell(tiny_root, cell, 3, SECONDS, False, device="cpu",
                   control="at_least_once")
    assert not out["correct"]
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed <= {"unapplied_ops", "over_applied_ops", "docs_differing"}


def _unchanged(real):
    return lambda state, ops: state


def _half_left_out(real):
    """Every other doc of each wave keeps its old state."""
    from fluidframework_tpu_torch.ops.doc_state import FIELDS, DocState

    def apply(state, ops):
        out = real(state, ops)
        parts = {}
        for f in FIELDS:
            t = getattr(out, f).clone()
            t[1::2] = getattr(state, f)[1::2]
            parts[f] = t
        return DocState(**parts)
    return apply


def _altered(real):
    """Each wave's first slot of every doc points one character on."""
    def apply(state, ops):
        out = real(state, ops)
        out.text_start[:, 0] += 1
        return out
    return apply


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, one_thread,
                                                  monkeypatch, cell, fault):
    from fluidframework_tpu_torch.ops import cuda_apply

    monkeypatch.setattr(cuda_apply, "apply_ops_batch",
                        fault(cuda_apply.apply_ops_batch))
    out = run_cell(tiny_root, cell, 11, SECONDS, False, device="cpu")
    assert not out["correct"]
    assert out["checks"]["docs_differing"]["value"] > 0


def _own_ack(action):
    """Every 7th broadcast of a client's own boxcar back to it is lost
    or comes twice."""
    from fluidframework_tpu_torch.service.local_server import (
        ServerConnection,
    )

    real = ServerConnection._deliver_ops
    seen = [0]

    def deliver(self, batch):
        if type(batch) is list or batch.boxcar.client_id != self.client_id:
            return real(self, batch)
        seen[0] += 1
        if seen[0] % 7:
            return real(self, batch)
        if action == "duplicate":
            real(self, batch)
            real(self, batch)
    return ServerConnection, deliver


@pytest.mark.parametrize("action", ["lose", "duplicate"])
def test_a_sequencing_fault_is_not_correct(tiny_root, one_thread,
                                           monkeypatch, action):
    cls, deliver = _own_ack(action)
    monkeypatch.setattr(cls, "_deliver_ops", deliver)
    out = run_cell(tiny_root, "loadtest_1k.flood", 13, SECONDS, False,
                   device="cpu")
    assert not out["correct"]
    checks = out["checks"]
    assert checks["ack_count_error"]["value"] > 0
    assert checks["client_order_errors"]["value"] > 0
    assert checks["seq_gaps"]["value"] > 0
    assert checks["logged_minus_acked_ops"]["value"] > 0


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    fake = type(sys)("fake")
    monkeypatch.setitem(sys.modules, "fluidframework_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "jaxtyping", fake)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fluidframework_tpu.ops", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert forbidden_modules() == ["fluidframework_tpu", "jax"]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_a_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the files under paths
    fails, card or no card."""
    root = copy_benchmark(tmp_path)
    shutil.rmtree(root / "portbench" / "__pycache__", ignore_errors=True)
    code = ("import json, sys; from pathlib import Path; "
            "from portbench.run import run_cell; "
            "print(json.dumps(run_cell(Path('.'), 'loadtest_1k.flood', 1, "
            "0.1, False, device='cpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "fluidframework_tpu_torch" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_and_its_control_on_the_card(cell):
    """On a card: a short run of each cell at its own size is correct,
    and its control is not."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for control, want in ((None, True), ("at_least_once", False)):
        args = [sys.executable, "-m", "portbench.run", "--workload", cell,
                "--seed", "2147483917", "--seconds", "10", "--trace", "0"]
        if control:
            args += ["--control", control]
        proc = subprocess.run(args, cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["correct"] is want, out["checks"]
        assert out["device"]["platform"] == "gpu"
