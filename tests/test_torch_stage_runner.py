"""The port's stage processes (``service/stage_runner.py``) against the
JAX package's, on the CPU.

``doc_partition`` must agree with the JAX one on every name (stage
processes of either package split one doc space). ``ApplierStage`` with
``device="cpu"`` and the JAX ``ApplierStage``, each tailing a durable log
its own package wrote on the same seed, must end with equal texts and
equal backchannel ``applied`` records; ``ScribeStage``'s checkpoint
records must agree too (client ids mapped by first appearance). A crash at
either checkpoint window (``stage.pre_checkpoint``: ops consumed, nothing
saved; ``stage.post_checkpoint``: the farm saved, the offsets not) and a
new stage over the same directories must end where an uncrashed stage
ends, applying no op twice. The command line is killed with ``-9`` and
restarted, and must catch up.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from fluidframework_tpu.service.durable_log import DurableLog as JaxLog
from fluidframework_tpu.service.load_gen import run_inproc as jax_run_inproc
from fluidframework_tpu.service.stage_runner import (
    ApplierStage as JaxApplierStage,
)
from fluidframework_tpu.service.stage_runner import (
    ScribeStage as JaxScribeStage,
)
from fluidframework_tpu.service.stage_runner import (
    doc_partition as jax_doc_partition,
)
from fluidframework_tpu_torch.service.durable_log import DurableLog
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    load_applier_checkpoint,
)
from fluidframework_tpu_torch.service.load_gen import run_inproc
from fluidframework_tpu_torch.service.stage_runner import (
    BACKCHANNEL_TOPIC,
    ApplierStage,
    ScribeStage,
    doc_partition,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = dict(n_docs=6, clients_per_doc=2, ops_per_client=24, batch_size=8,
           flush_every=64)
DOCS = [f"doc{d}" for d in range(RUN["n_docs"])]
#: the stages' farm geometry: room for RUN's docs, small enough to keep the
#: JAX stage's compile and the plain PyTorch waves cheap
FARM = dict(max_docs=8, max_slots=256)


class SimulatedCrash(Exception):
    """What a fault plane raises to stand for a kill at a seam."""


@pytest.mark.parametrize("n", [1, 3, 8, 61])
def test_doc_partition_matches_jax(n):
    rng = random.Random(n)
    names = [("".join(rng.choice("abc.-_/é0") for _ in range(
        rng.randrange(1, 12))), f"doc{i}") for i in range(3000)]
    assert [doc_partition(t, d, n) for t, d in names] == \
        [jax_doc_partition(t, d, n) for t, d in names]


def _write_log(pkg: str, directory: str, seed: int, array_lane: bool,
               applier=None) -> None:
    os.makedirs(directory)
    log = (DurableLog if pkg == "port" else JaxLog)(directory)
    run = run_inproc if pkg == "port" else jax_run_inproc
    run(seed=seed, array_lane=array_lane, log=log, applier=applier, **RUN)
    log.flush()
    log.close()


def _drain(stage) -> None:
    while stage.run_once():
        pass


def _backchannel(stage) -> list:
    log = stage.state
    out = []
    for i in range(log.length(BACKCHANNEL_TOPIC)):
        rec = dict(log.read(BACKCHANNEL_TOPIC, i))
        rec.pop("wave_hops", None)  # wall-clock stamps
        out.append(rec)
    return out


def _id_map(log) -> dict:
    """Client ids of the log's deltas streams by first appearance."""
    ids: dict = {}
    for doc in DOCS:
        topic = f"deltas/bench/{doc}"
        for i in range(log.length(topic)):
            rec = log.read(topic, i)
            msgs = (rec["abatch"].messages() if "abatch" in rec
                    else rec.get("boxcar") or [rec["message"]])
            for m in msgs:
                if m.client_id is not None:
                    ids.setdefault(m.client_id, f"client{len(ids)}")
    return ids


def _mapped(value, ids: dict):
    if isinstance(value, dict):
        return {ids.get(k, k): _mapped(v, ids) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mapped(v, ids) for v in value]
    if isinstance(value, str):
        return ids.get(value, value)
    return value


@pytest.mark.parametrize("array_lane", [True, False])
def test_applier_stage_matches_jax(tmp_path, array_lane):
    stages = {}
    for pkg in ("port", "jax"):
        _write_log(pkg, str(tmp_path / pkg / "log"), 3, array_lane)
        log_dir, state_dir = (str(tmp_path / pkg / "log"),
                              str(tmp_path / pkg / "state"))
        stages[pkg] = (ApplierStage(log_dir, state_dir, device="cpu",
                                    **FARM)
                       if pkg == "port" else
                       JaxApplierStage(log_dir, state_dir, **FARM))
        _drain(stages[pkg])
    port, jax = stages["port"], stages["jax"]
    for doc in DOCS:
        assert port.applier.get_text("bench", doc) == \
            jax.applier.get_text("bench", doc), doc
    assert any(port.applier.get_text("bench", doc) for doc in DOCS)
    assert port.applier.host_escalations == 0
    records = _backchannel(port)
    assert records == _backchannel(jax)
    newest = {r["doc"]: r["applied_seq"] for r in records}
    assert sorted(newest) == DOCS
    for doc in DOCS:
        assert newest[doc] == port.applier.applied_seq("bench", doc)
    assert port.last_save["npz_bytes"] > 0


def test_scribe_stage_checkpoints_match_jax(tmp_path):
    cps = {}
    for pkg in ("port", "jax"):
        log_dir = str(tmp_path / pkg / "log")
        _write_log(pkg, log_dir, 9, True)
        cls = ScribeStage if pkg == "port" else JaxScribeStage
        stage = cls(log_dir, str(tmp_path / pkg / "state"))
        _drain(stage)
        ids = _id_map(stage.shared)
        cps[pkg] = {doc: _mapped(stage.load_checkpoint("bench", doc), ids)
                    for doc in DOCS}
        assert _backchannel(stage) == []  # no summaries: nothing to emit
    assert cps["port"] == cps["jax"]
    for cp in cps["port"].values():
        assert cp["deltas_offset"] > 0 and cp["scribe"]["protocol"]


@pytest.mark.parametrize("array_lane", [True, False])
@pytest.mark.parametrize("point", ["stage.pre_checkpoint",
                                   "stage.post_checkpoint"])
def test_crash_at_checkpoint_window_recovers(tmp_path, point, array_lane):
    log_dir = str(tmp_path / "log")
    _write_log("port", log_dir, 5, array_lane)
    reference = ApplierStage(log_dir, str(tmp_path / "reference"),
                             device="cpu", **FARM)
    _drain(reference)
    total = reference.applier.ops_applied

    state_dir = str(tmp_path / "state")
    first = ApplierStage(log_dir, state_dir, device="cpu", **FARM)
    first.discover()
    first.shared.poll()
    for topic in list(first.shared._order)[:3]:  # consume part of the log
        for _ in range(6):  # two joins, then op batches
            first.shared.step(topic)
    first.checkpoint()
    first.state.flush()
    at_clean = first.applier.ops_applied
    assert 0 < at_clean < total

    def plane(seam, **ctx):
        if seam == point:
            raise SimulatedCrash(seam)

    first.fault_plane = plane
    with pytest.raises(SimulatedCrash):
        first.run_once()
    first.shared.close()
    first.state.close()

    second = ApplierStage(log_dir, state_dir, device="cpu", **FARM)
    _drain(second)
    # the window is replayed and skipped by sequence number: only ops the
    # last saved farm lacks are applied again
    saved = total if point == "stage.post_checkpoint" else at_clean
    assert second.applier.ops_applied == total - saved
    assert second.applier.host_escalations == 0
    for doc in DOCS:
        assert second.applier.get_text("bench", doc) == \
            reference.applier.get_text("bench", doc), doc
        assert second.applier.applied_seq("bench", doc) == \
            reference.applier.applied_seq("bench", doc)
    newest = {r["doc"]: r["applied_seq"] for r in _backchannel(second)}
    assert newest == {r["doc"]: r["applied_seq"]
                      for r in _backchannel(reference)}


def _spawn(log_dir: str, state_dir: str) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service."
         "stage_runner", "--stage", "applier", "--device", "cpu",
         "--log-dir", log_dir, "--state-dir", state_dir],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(120)
    if not lines or lines[0].strip() != "READY":
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"the stage process printed {lines}")
    return proc


def _wait_applied(state_dir: str, want: dict, timeout: float = 120.0):
    """Newest backchannel ``applied`` seq per doc, once it reaches
    ``want`` (any record at all when ``want`` is empty)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        newest = {}
        if os.path.isdir(state_dir):
            log = DurableLog(state_dir, readonly=True)
            for i in range(log.refresh_topic(BACKCHANNEL_TOPIC)):
                rec = log.read(BACKCHANNEL_TOPIC, i)
                newest[rec["doc"]] = rec["applied_seq"]
            log.close()
        if newest and all(newest.get(d) == s for d, s in want.items()):
            return newest
        time.sleep(0.05)
    raise AssertionError(f"stage did not catch up: {newest} vs {want}")


def test_stage_process_killed_and_restarted_catches_up(tmp_path):
    log_dir, state_dir = str(tmp_path / "log"), str(tmp_path / "state")
    cpu = GpuDocumentApplier(device="cpu", max_docs=RUN["n_docs"],
                             max_slots=256)
    _write_log("port", log_dir, 6, True, applier=cpu)
    want = {doc: cpu.applied_seq("bench", doc) for doc in DOCS}
    proc = _spawn(log_dir, state_dir)
    try:
        _wait_applied(state_dir, {})
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        proc = _spawn(log_dir, state_dir)
        assert _wait_applied(state_dir, want) == want
    finally:
        proc.kill()
        proc.wait(timeout=30)
    farm = load_applier_checkpoint(os.path.join(state_dir, "applier"),
                                   device="cpu")
    for doc in DOCS:
        assert farm.get_text("bench", doc) == cpu.get_text("bench", doc)
    assert farm.host_escalations == 0


def test_applier_stage_without_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ApplierStage(str(tmp_path / "log"), str(tmp_path / "state"))
    assert not os.path.exists(tmp_path / "state")
