"""The split service over the network: the port's core process
(``front_end --log-dir L --consume-backchannel S``) and the port's applier
stage process (``stage_runner --stage applier --device cpu``) tailing its
durable log, twin of ``tests/test_split_service.py::
test_applier_stage_catches_up_and_survives_kill`` with the applier stage
only (the external scribe and the chunk store are ROADMAP A9).

A client over sockets writes a doc; the stage reports applied seqs on its
backchannel, which the core consumes: the core's status RPC shows
``applierSeq`` at the doc's tail. After SIGKILL and a restart over the
same directories the stage resumes from its farm checkpoint and catches
up again, and its checkpoint's text equals the client's and that of the
JAX package's ``ApplierStage`` run on the CPU over the same log.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.stage_runner import (
    ApplierStage as JaxApplierStage,
)
from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
    _Transport,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.service.gpu_applier import (
    load_applier_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent


def wait_for(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _spawn(args, ready):
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    line = proc.stdout.readline().strip()
    assert line.startswith(ready), line
    return proc, line


def _stage(log_dir, state_dir):
    return _spawn(["fluidframework_tpu_torch.service.stage_runner",
                   "--stage", "applier", "--log-dir", str(log_dir),
                   "--state-dir", str(state_dir), "--device", "cpu"],
                  "READY")[0]


def test_applier_stage_catches_up_and_survives_kill(tmp_path):
    log_dir, state_dir = tmp_path / "log", tmp_path / "applier-state"
    procs = {"applier": _stage(log_dir, state_dir)}
    try:
        procs["core"], line = _spawn(
            ["fluidframework_tpu_torch.service.front_end", "--port", "0",
             "--log-dir", str(log_dir),
             "--consume-backchannel", str(state_dir)], "LISTENING")
        port = int(line.rsplit(":", 1)[1])
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c1 = loader.resolve("t", "doc")
        s = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        for i in range(20):
            s.insert_text(0, "ab")
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        tail = c1.delta_manager.last_processed_seq
        status = _Transport("127.0.0.1", port, timeout=10.0)

        def applier_seq():
            return status.request({"t": "admin_status", "tenant": "t",
                                   "doc": "doc"})["status"]["applierSeq"]

        assert wait_for(lambda: (applier_seq() or 0) >= tail, timeout=120)

        os.kill(procs["applier"].pid, signal.SIGKILL)
        procs["applier"].wait(timeout=10)
        for i in range(10):
            s.insert_text(0, "cd")
        s.remove_text(3, 9)
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        tail2 = c1.delta_manager.last_processed_seq
        assert tail2 > tail

        procs["applier"] = _stage(log_dir, state_dir)
        assert wait_for(lambda: applier_seq() == tail2, timeout=120)
        status.close()
        procs["applier"].terminate()
        procs["applier"].wait(timeout=10)
        farm = load_applier_checkpoint(str(state_dir / "applier"),
                                       device="cpu")
        assert not farm.host_escalations
        assert farm.get_text("t", "doc") == s.get_text()
        assert len(s.get_text()) == 54
        # the JAX stage, tailing the same durable log from its start,
        # lands on the port stage's text
        jax = JaxApplierStage(str(log_dir), str(tmp_path / "jax-state"),
                              max_docs=8, max_slots=256)
        while jax.run_once():
            pass
        assert jax.applier.get_text("t", "doc") == farm.get_text("t", "doc")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=10)
