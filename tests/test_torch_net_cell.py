"""The benchmark's socket cell, ``net_1k.paced``, at a tiny size on the CPU:
a core process over a durable log, the stage's farm on the CPU in the
harness's process, one load process of 8 docs x 3 clients, a few seconds.

A sound run is correct; the control, which ingests a boxcar twice, is
not; an acked op missing from the restarted core's read-back is caught; a
traced run reads every core, stage and farm metric; and a core without the
``admin_spans`` door fails the run quickly, leaving no child behind.
"""

from __future__ import annotations

import json
import os
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from torch.profiler import ProfilerActivity, profile

from portbench import run, spec
from portbench.tests.conftest import copy_benchmark

CELL = "net_1k.paced"
SECONDS = 2.5
TINY = {"docs": 8, "clients_per_doc": 3, "warmup_docs": 2,
        "warmup_seconds": 1.0, "settle_s": 0.5,
        "check": {"sample_docs": 4, "control_every": 5}}
CORE_METRICS = {"ingress_us_per_op.net_paced", "pipeline_us_per_op.net_paced",
                "log_flush_us_per_op.net_paced", "egress_us_per_op.net_paced",
                "core_busy_share.net_paced"}
STAGE_METRICS = {"stage_tail_us_per_op.net_paced",
                 "checkpoint_share.net_paced", "drain_s.net_paced"}
#: the stage's farm and its checkpoint, from the harness's own recorder
FARM_METRICS = {"escalated_docs.net_paced", "stage_us_per_op.net_paced",
                "launch_us_per_op.net_paced", "wave_fill.net_paced",
                "packed_share.net_paced",
                "checkpoint_write_share.net_paced",
                "checkpoint_readback_share.net_paced",
                "checkpoint_bytes.net_paced"}


@pytest.fixture
def net_root(tmp_path, monkeypatch):
    """A copy of the benchmark with the cell cut to the tiny size (the
    farm as wide as the docs, one load process)."""
    root = copy_benchmark(tmp_path)
    path = root / "portbench" / "configs" / "net_1k.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY, applier={**cfg["applier"], "max_docs": TINY["docs"]})
    path.write_text(json.dumps(cfg))
    path = root / "portbench" / "traffic" / "net_paced.json"
    mix = json.loads(path.read_text())
    mix.update(workers=1, rate=120.0)
    path.write_text(json.dumps(mix))
    # this test process has JAX loaded (tests/conftest.py); the run's own
    # check that the program loads none is the benchmark's tests' to make
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    return root


def _children_of(root) -> list:
    """Live processes whose command line names the copy ``root``."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if str(root) in cmd:
            found.append((int(pid), cmd.replace("\0", " ")[:200]))
    return found


def _patch_driver(monkeypatch, change):
    """Have ``run_cell`` load the cell's driver through ``change(module)``."""
    load = spec.driver

    def driver(root, name):
        mod = load(root, name)
        change(mod)
        return mod

    monkeypatch.setattr(spec, "driver", driver)


def test_a_sound_run_is_correct(net_root):
    out = run.run_cell(net_root, CELL, 2**40 + 11, SECONDS, False,
                       device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"ops_per_s", "setup_s"}
    assert all(c["limit"] == 0 for c in out["checks"].values())
    assert {"ack_count_error", "client_order_errors", "seq_gaps",
            "unapplied_ops", "over_applied_ops", "lost_after_restart",
            "docs_differing"} == set(out["checks"])
    assert not _children_of(net_root)


def test_the_control_is_not_correct(net_root):
    out = run.run_cell(net_root, CELL, 3, SECONDS, False, device="cpu",
                       control="at_least_once")
    assert not out["correct"]
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert "over_applied_ops" in failed
    assert failed <= {"unapplied_ops", "over_applied_ops", "docs_differing"}


def test_a_lost_op_is_caught_after_the_restart(net_root, monkeypatch):
    """One acked op dropped from what the restarted core reads back."""

    def change(mod):
        read_back = mod.read_back

        def dropping(port, tenant, docs):
            logs = read_back(port, tenant, docs)
            for doc in sorted(logs):
                msgs = logs[doc]
                ops = [i for i, m in enumerate(msgs)
                       if m.type == "op" and m.client_id is not None]
                if ops:
                    del msgs[ops[-1]]
                    break
            return logs
        mod.read_back = dropping

    _patch_driver(monkeypatch, change)
    out = run.run_cell(net_root, CELL, 17, SECONDS, False, device="cpu")
    checks = out["checks"]
    assert not out["correct"]
    assert checks["lost_after_restart"]["value"] > 0
    assert checks["ack_count_error"]["value"] == 0


def test_a_traced_run_reads_the_core_and_stage_metrics(net_root,
                                                       monkeypatch):
    """With a CPU profiler around the window (as a traced run on the card
    has), every core and stage metric reads a number; the device's idle
    share needs a card's trace and stays silent."""
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
        out = run.run_cell(net_root, CELL, 2**33 + 5, SECONDS, True,
                           device="cpu")
    finally:
        SPANS.reset()
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert CORE_METRICS | STAGE_METRICS | FARM_METRICS == set(got)
    assert all(isinstance(got[k], float) and got[k] >= 0
               for k in CORE_METRICS | STAGE_METRICS)
    assert 0 < got["core_busy_share.net_paced"] < 100
    assert 0 < got["checkpoint_share.net_paced"] < 100
    assert got["escalated_docs.net_paced"] >= 0
    for name in ("stage_us_per_op.net_paced", "launch_us_per_op.net_paced",
                 "checkpoint_bytes.net_paced"):
        assert got[name] > 0, name
    for name in ("wave_fill.net_paced", "packed_share.net_paced",
                 "checkpoint_write_share.net_paced",
                 "checkpoint_readback_share.net_paced"):
        assert 0 < got[name] <= 100, name
    # the two parts of the checkpoint leave room for its flush and records
    assert got["checkpoint_write_share.net_paced"] \
        + got["checkpoint_readback_share.net_paced"] < 100


def test_a_core_without_admin_spans_fails_fast(net_root, monkeypatch,
                                               tmp_path):
    """The parent commit's core has no ``admin_spans``: the run raises at
    set-up, within a minute, and kills every child it started."""
    old = tmp_path / "old_core"
    old.mkdir()
    (old / "old_core.py").write_text(
        "from fluidframework_tpu_torch.service import front_end\n"
        "handle = front_end._ClientSession._handle_admin\n"
        "def _handle_admin(self, t, frame, rid):\n"
        "    if t == 'admin_spans':\n"
        "        raise ValueError(f'unknown frame type {t!r}')\n"
        "    return handle(self, t, frame, rid)\n"
        "front_end._ClientSession._handle_admin = _handle_admin\n"
        "front_end.main()\n")
    monkeypatch.setenv("PYTHONPATH", str(old))
    _patch_driver(monkeypatch, lambda mod: setattr(mod, "CORE", "old_core"))
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="unknown frame type"):
        run.run_cell(net_root, CELL, 5, SECONDS, False, device="cpu")
    assert time.perf_counter() - t < 60
    assert not _children_of(net_root)
    # the run's directory is gone; the children's standard error stays
    assert [p.name for p in (net_root / "build" / "portbench" / "net")
            .iterdir()] == ["last_stderr.txt"]
