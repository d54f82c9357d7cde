"""The port's split service (``service/stage_runner.py`` stages as
processes tailing the core's ``DurableLog``), twin of the three cases of
``tests/test_split_service.py`` that ``test_torch_external_scribe.py``
and ``test_torch_split_network.py`` do not hold: the scribe stage killed
and restarted mid-stream, doc-partitioned applier stages with a
rebalance, and the scribe stage stepped one record at a time.

What crosses processes is timed by the operating system, not fixed by a
seed: each test asserts its JAX twin's properties on the port alone. One
fleet of the port's processes serves the file: the core (``front_end
--log-dir --external-scribe --consume-backchannel``), the scribe stage,
started paused (its ``ctl.json``), and two applier stages on the CPU
(``--device cpu --partition 0/2`` and ``1/2``). The tests run in file
order on it: the stepping test first, while the scribe has seen nothing;
the kill test then lets the scribe run and kills it; the rebalance test
restarts the applier stages with swapped partitions. Tolerance: exact.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.runtime.summarizer import SummaryManager
from fluidframework_tpu_torch.service.durable_log import DurableLog
from fluidframework_tpu_torch.service.stage_runner import (
    BACKCHANNEL_TOPIC,
    doc_partition,
)

ROOT = Path(__file__).resolve().parent.parent
STAGE = "fluidframework_tpu_torch.service.stage_runner"


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


def _set_ctl(state_dir, mode: str, steps: int) -> None:
    os.makedirs(state_dir, exist_ok=True)
    tmp = str(state_dir) + ".ctltmp"
    with open(tmp, "w") as f:
        json.dump({"mode": mode, "steps": steps}, f)
    os.replace(tmp, os.path.join(state_dir, "ctl.json"))


def _applied_seq(state_dir, tenant, doc):
    """Newest applied seq an applier stage reported for ``doc``."""
    try:
        log = DurableLog(str(state_dir), readonly=True)
    except OSError:
        return 0
    try:
        n = log.refresh_topic(BACKCHANNEL_TOPIC)
        best = 0
        for i in range(n):
            rec = log.read(BACKCHANNEL_TOPIC, i)
            if rec.get("kind") == "applied" and rec["tenant"] == tenant \
                    and rec["doc"] == doc:
                best = max(best, rec["applied_seq"])
        return best
    finally:
        log.close()


class Fleet:
    """The file's processes and directories."""

    def __init__(self, root: Path):
        self.log_dir = root / "log"
        self.scribe_state = root / "scribe-state"
        self.applier_states = [root / "a0", root / "a1"]
        self.procs = {}
        self.port = None

    def scribe(self):
        self.procs["scribe"], _ = _spawn(
            [STAGE, "--stage", "scribe", "--log-dir", str(self.log_dir),
             "--state-dir", str(self.scribe_state)], "READY")

    def applier(self, i: int, part: str):
        self.procs[f"applier{i}"], _ = _spawn(
            [STAGE, "--stage", "applier", "--log-dir", str(self.log_dir),
             "--state-dir", str(self.applier_states[i]), "--partition",
             part, "--device", "cpu"], "READY")

    def stop(self, name: str, sig=signal.SIGTERM):
        proc = self.procs.pop(name)
        proc.send_signal(sig)
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    f = Fleet(tmp_path_factory.mktemp("split"))
    _set_ctl(f.scribe_state, "pause", 0)
    try:
        f.scribe()
        f.applier(0, "0/2")
        f.applier(1, "1/2")
        core, line = _spawn(
            ["fluidframework_tpu_torch.service.front_end", "--port", "0",
             "--log-dir", str(f.log_dir), "--external-scribe",
             "--consume-backchannel", str(f.scribe_state)], "LISTENING")
        f.procs["core"] = core
        f.port = int(line.rsplit(":", 1)[1])
        yield f
    finally:
        for proc in f.procs.values():
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=10)


def test_cross_process_deterministic_stepping(fleet):
    """With the scribe stage paused the summary is never acked; stepping
    releases one log record a step, and the ack appears at one step
    boundary past the first."""
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", fleet.port))
    c1 = loader.resolve("t", "doc")
    sm = SummaryManager(c1, max_ops=3)
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "abcdef")
    s.remove_text(0, 2)
    assert wait_for(lambda: sm._pending_handle is not None)
    time.sleep(2.0)
    assert sm.summaries_acked == 0
    state_view = DurableLog(str(fleet.scribe_state), readonly=True)
    try:
        last_cp = state_view.refresh_topic("cp/t/doc")
        last_bc = state_view.refresh_topic("backchannel")
        acked_at = None
        for step in range(1, 200):
            _set_ctl(fleet.scribe_state, "pause", step)
            t0 = time.time()
            while time.time() - t0 < 10.0 and sm.summaries_acked == 0:
                cp = state_view.refresh_topic("cp/t/doc")
                if cp > last_cp:
                    last_cp = cp
                    break
                time.sleep(0.02)
            bc = state_view.refresh_topic("backchannel")
            if bc > last_bc:
                last_bc = bc
                t1 = time.time()
                while time.time() - t1 < 10.0 and sm.summaries_acked == 0:
                    time.sleep(0.02)
            if sm.summaries_acked >= 1:
                acked_at = step
                break
    finally:
        state_view.close()
    assert acked_at is not None, "stepping never released the ack"
    shared = DurableLog(str(fleet.log_dir), readonly=True)
    try:
        n_deltas = shared.refresh_topic("deltas/t/doc")
    finally:
        shared.close()
    assert acked_at > 1
    assert n_deltas >= acked_at - 1


def test_scribe_stage_killed_and_restarted_mid_stream(fleet):
    """SIGKILL the scribe stage while a summary is in flight: no ack while
    it is down; a restart over the same state dir replays from its
    checkpoint and the ack lands."""
    _set_ctl(fleet.scribe_state, "run", 0)
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", fleet.port))
    c1 = loader.resolve("t", "killdoc")
    sm = SummaryManager(c1, max_ops=3)
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "first")
    assert wait_for(lambda: sm.summaries_acked >= 1)
    fleet.stop("scribe", signal.SIGKILL)
    for i in range(4):
        s.insert_text(0, f"{i}")
    time.sleep(1.0)
    assert sm.summaries_acked == 1
    fleet.scribe()
    assert wait_for(lambda: sm.summaries_acked >= 2)


def test_doc_partitioned_appliers_and_rebalance(fleet):
    """Two applier stages split the doc space by the stable doc hash; a
    redeploy with swapped partitions moves every doc to the other
    process, which catches up to the stream tail."""
    states = fleet.applier_states
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", fleet.port))
    docs = [f"pdoc{i}" for i in range(4)]
    strings, tails = {}, {}
    for d in docs:
        c = loader.resolve("t", d)
        s = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        for _ in range(6):
            s.insert_text(0, "ab")
        strings[d] = (c, s)
        tails[d] = c.delta_manager.last_processed_seq
    owner = {d: doc_partition("t", d, 2) for d in docs}
    assert set(owner.values()) == {0, 1}
    for d in docs:
        k = owner[d]
        assert wait_for(lambda d=d, k=k: _applied_seq(states[k], "t", d)
                        >= tails[d], timeout=150)
        assert _applied_seq(states[1 - k], "t", d) == 0
    fleet.stop("applier0")
    fleet.stop("applier1")
    for d in docs:
        c, s = strings[d]
        s.insert_text(0, "z")
        tails[d] = c.delta_manager.last_processed_seq
    fleet.applier(0, "1/2")
    fleet.applier(1, "0/2")
    for d in docs:
        new_state = states[0] if owner[d] == 1 else states[1]
        assert wait_for(lambda d=d, st=new_state: _applied_seq(st, "t", d)
                        >= tails[d], timeout=90)
