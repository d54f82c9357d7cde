"""The port's chaos plane, invariant monitor, seams and soak phase A on
the CPU, and against the JAX package's.

The plane, monitor, seam, install and torn/dup/rewind tests of
``tests/test_chaos.py`` (without the sharded core's partition seam and
the socket transport's hook, which the port does not have), run on the
port; the quick phase-A soak and its two self-tests with the device
stage's applier on the CPU; and the port's seed-0 quick soak against the
JAX package's: the same coverage, observed and redelivered counts, chaos
counters and final fingerprints of every replica, exactly, with the
stage's farm dense and over a 2-shard mesh.
"""

import json

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
import torch

from fluidframework_tpu_torch.chaos import (
    FaultPlane,
    InvariantMonitor,
    InvariantViolation,
    SimulatedCrash,
    doc_fingerprint,
)
from fluidframework_tpu_torch.chaos.hooks import install
from fluidframework_tpu_torch.chaos.soak import run_soak
from fluidframework_tpu_torch.protocol.messages import (
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.utils import Counters

pytestmark = pytest.mark.chaos


# ------------------------------------------------------------ fault plane


def _count_fires(seed, n=200):
    plane = FaultPlane(seed)
    plane.rule("net.send", "drop", p=0.1)
    plane.rule("log.append", "torn", every=7, times=3)
    fired = []
    for i in range(n):
        fired.append((plane("net.send", size=i), plane("log.append")))
    return fired, plane.injected


def test_plane_same_seed_same_schedule():
    a_fired, a_ledger = _count_fires(123)
    b_fired, b_ledger = _count_fires(123)
    assert a_fired == b_fired
    assert a_ledger == b_ledger
    c_fired, _ = _count_fires(124)
    assert a_fired != c_fired  # the seed actually matters


def test_plane_rule_budget_and_at():
    plane = FaultPlane(0)
    plane.rule("x", "boom", at=3)  # times defaults to 1
    hits = [plane("x") for _ in range(10)]
    assert hits == [None, None, "boom"] + [None] * 7


def test_plane_when_predicate_filters_context():
    plane = FaultPlane(0)
    plane.rule("net.send", "drop", every=1,
               when=lambda ctx: ctx.get("kind") == "submit")
    assert plane("net.send", kind="ping") is None
    assert plane("net.send", kind="submit") == "drop"


def test_plane_crash_directive_raises():
    plane = FaultPlane(0)
    plane.rule("stage.pre_checkpoint", "crash", at=1)
    with pytest.raises(SimulatedCrash):
        plane("stage.pre_checkpoint")


def test_plane_disarm_is_total():
    plane = FaultPlane(0)
    plane.rule("x", "boom", every=1)
    plane.disarm()
    assert all(plane("x") is None for _ in range(5))
    plane.arm()
    assert plane("x") == "boom"


def test_plane_ledger_classifies_boundaries():
    plane = FaultPlane(0)
    plane.rule("net.send", "drop", at=1)
    plane.rule("log.append", "torn", at=1)
    plane.rule("applier.ingest", "escalate_host", at=1)
    plane("net.send")
    plane("log.append")
    plane("applier.ingest")
    by_class = plane.injected_by_class()
    assert by_class == {"network": 1, "log": 1, "device": 1}


# -------------------------------------------------------------- monitor


def _seq(seq, msn=0, cid="c1", cseq=1, mtype=MessageType.OPERATION,
         contents=None):
    if contents is None:
        contents = ({"clientId": cid}
                    if mtype in (MessageType.CLIENT_JOIN,
                                 MessageType.CLIENT_LEAVE) else {})
    return SequencedDocumentMessage(
        client_id=cid, sequence_number=seq, minimum_sequence_number=msn,
        client_sequence_number=cseq, reference_sequence_number=0,
        type=mtype, contents=contents)


def test_monitor_catches_msn_regression():
    mon = InvariantMonitor()
    mon.observe(_seq(1, msn=0, mtype=MessageType.CLIENT_JOIN))
    mon.observe(_seq(2, msn=1))
    mon.observe(_seq(3, msn=0, cseq=2))  # msn went backwards
    with pytest.raises(InvariantViolation, match="msn decreased"):
        mon.check()


def test_monitor_catches_msn_above_seq():
    mon = InvariantMonitor()
    mon.observe(_seq(1, msn=5, mtype=MessageType.CLIENT_JOIN))
    with pytest.raises(InvariantViolation, match="msn 5 > seq 1"):
        mon.check()


def test_monitor_dedupes_replayed_seq_but_flags_when_broken():
    strict = InvariantMonitor(dedupe=False)
    lax = InvariantMonitor()
    for m in (_seq(1, mtype=MessageType.CLIENT_JOIN), _seq(2),
              _seq(2), _seq(3, cseq=2)):
        strict.observe(m)
        lax.observe(m)
    lax.check()  # redelivery absorbed
    assert lax.redelivered == 1
    with pytest.raises(InvariantViolation,
                       match="seq not strictly increasing"):
        strict.check()


def test_monitor_catches_clientseq_gap_without_nack():
    mon = InvariantMonitor()
    mon.observe(_seq(1, mtype=MessageType.CLIENT_JOIN))
    mon.observe(_seq(2, cseq=1))
    mon.observe(_seq(3, cseq=4))  # skipped 2 and 3, never nacked
    with pytest.raises(InvariantViolation, match="clientSeq gap"):
        mon.check()


def test_monitor_catches_op_from_unjoined_client():
    mon = InvariantMonitor()
    mon.observe(_seq(1, cid="ghost"))
    with pytest.raises(InvariantViolation, match="non-joined"):
        mon.check()


def test_monitor_catches_duplicate_join():
    mon = InvariantMonitor()
    mon.observe(_seq(1, mtype=MessageType.CLIENT_JOIN))
    mon.observe(_seq(2, mtype=MessageType.CLIENT_JOIN))
    with pytest.raises(InvariantViolation, match="duplicate join"):
        mon.check()


def test_monitor_submit_lifecycle_and_quiescence():
    mon = InvariantMonitor()
    mon.note_submit("c1", 1)
    mon.note_submit("c1", 2)
    mon.observe(_seq(1, mtype=MessageType.CLIENT_JOIN))
    mon.observe(_seq(2, cseq=1))
    # cseq 2 neither acked nor nacked → quiescence must fail
    with pytest.raises(InvariantViolation, match="neither acked"):
        mon.check_quiescent({"a": "f1", "b": "f1"})


def test_monitor_quiescence_catches_divergent_fingerprints():
    mon = InvariantMonitor()
    with pytest.raises(InvariantViolation, match="diverged"):
        mon.check_quiescent({"a": doc_fingerprint("ab", [{}, {}]),
                             "b": doc_fingerprint("ba", [{}, {}])})


def test_doc_fingerprint_covers_props():
    assert doc_fingerprint("ab", [{}, {}]) \
        != doc_fingerprint("ab", [{"k": 1}, {}])


# ----------------------------------------------------- seams (disarmed)


def test_seams_disarmed_by_default():
    """No chaos import, no chaos behavior: every seam class attr is None
    until hooks.install arms it."""
    from fluidframework_tpu_torch.service.broadcaster import (
        BroadcasterLambda,
    )
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.service.history_plane import HistoryPlane
    from fluidframework_tpu_torch.service.local_log import OrderedLogBase
    from fluidframework_tpu_torch.service.service_summarizer import (
        ServiceSummarizer,
    )
    from fluidframework_tpu_torch.service.stage_runner import (
        _StageHostBase,
    )

    assert OrderedLogBase.fault_plane is None
    assert BroadcasterLambda.fault_plane is None
    assert GpuDocumentApplier.fault_plane is None
    assert _StageHostBase.fault_plane is None
    assert ServiceSummarizer.fault_plane is None
    assert HistoryPlane.fault_plane is None


def test_install_arms_and_uninstall_restores():
    from fluidframework_tpu_torch.service.broadcaster import (
        BroadcasterLambda,
    )
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.service.history_plane import HistoryPlane
    from fluidframework_tpu_torch.service.local_server import LocalServer

    server = LocalServer()
    app = GpuDocumentApplier(max_docs=2, max_slots=8, device="cpu")
    plane = FaultPlane(0)
    uninstall = install(plane, server=server, appliers=[app])
    assert server.log.fault_plane is plane
    assert BroadcasterLambda.fault_plane is plane
    assert HistoryPlane.fault_plane is plane
    assert app.fault_plane is plane
    uninstall()
    assert server.log.fault_plane is None
    assert BroadcasterLambda.fault_plane is None
    assert HistoryPlane.fault_plane is None
    assert "fault_plane" not in vars(app)


def test_torn_append_drops_the_record():
    from fluidframework_tpu_torch.service.local_log import LocalLog

    log = LocalLog()
    plane = FaultPlane(0, Counters())
    plane.rule("log.append", "torn", at=2)
    log.fault_plane = plane
    seen = []
    log.subscribe("t", lambda m: seen.append(m.value))
    log.append("t", "a")
    log.append("t", "b")  # torn: never stored
    log.append("t", "c")
    log.drain()
    assert seen == ["a", "c"]


def test_duplicate_append_stores_twice():
    from fluidframework_tpu_torch.service.local_log import LocalLog

    log = LocalLog()
    plane = FaultPlane(0)
    plane.rule("log.append", "dup", at=1)
    log.fault_plane = plane
    log.append("t", "a")
    assert log.length("t") == 2


def test_rewind_redelivers_to_subscribers():
    from fluidframework_tpu_torch.service.local_log import LocalLog

    log = LocalLog()
    seen = []
    log.subscribe("t", lambda m: seen.append(m.value))
    log.append("t", "a")
    log.drain()
    log.rewind_subscribers("t", 1)
    log.drain()
    assert seen == ["a", "a"]


def test_simulated_crash_on_the_worker_surfaces_at_finalize():
    """A crash directive at an overlap seam of an async applier fires on
    its worker thread; it must surface at the caller's next sync point,
    never vanish."""
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.mergetree.ops import op_to_wire
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    writer = MergeTreeClient("w")
    pairs = []
    for seq in range(1, 9):
        op = op_to_wire(writer.insert_text_local(0, f"x{seq}"))
        writer.tree.current_seq = seq
        pairs.append((SequencedDocumentMessage(
            client_id="w", sequence_number=seq, minimum_sequence_number=0,
            client_sequence_number=seq, reference_sequence_number=seq - 1,
            type=MessageType.OPERATION, contents=op), op))
    app = GpuDocumentApplier(max_docs=2, max_slots=64, ops_per_dispatch=4,
                             device="cpu", async_dispatch=True,
                             min_wave_ops=1)
    plane = FaultPlane(0, Counters())
    plane.rule("applier.stage.staged", "crash", at=1)
    install(plane, appliers=[app])
    try:
        app.ingest_batch("t", "d", pairs)
        with pytest.raises(SimulatedCrash, match="applier.stage.staged"):
            app.finalize()
    finally:
        app.close()
    assert plane.injected_by_class() == {"device": 1}


# ------------------------------------------------------------- the soak


def test_soak_quick_phase_a_holds_invariants():
    out = run_soak(seed=0, quick=True, phases="a", device="cpu")
    assert out["observed"] > 10
    assert out["coverage"]  # at least one boundary class hit
    assert out["counters"]["chaos.faults.injected"] >= 5
    # the injected orderer crash must have dumped the flight recorder,
    # and the dump's tail must carry pre-crash telemetry
    assert out["flight_dump"] is not None
    with open(out["flight_dump"], encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert json.loads(lines[0])["flight"] == "orderer_crash"
    kinds = {json.loads(ln).get("kind") for ln in lines[1:]}
    assert "event" in kinds


def test_soak_fails_when_monitor_dedupe_broken():
    with pytest.raises(InvariantViolation):
        run_soak(seed=0, quick=True, phases="a", break_dedupe=True,
                 device="cpu")


def test_soak_fails_when_recovery_disabled():
    with pytest.raises(InvariantViolation):
        run_soak(seed=0, quick=True, phases="a", no_recover=True,
                 device="cpu")


def test_soak_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="A8"):
        run_soak(seed=0, quick=True, phases="ab", device="cpu")
    # the device stage runs on the card unless told otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_soak(seed=0, quick=True)


def _soak(pkg: str, seed: int, monkeypatch, mesh_shards: int = 0) -> dict:
    """One quick phase-A soak of ``pkg``, with the fingerprints every
    replica reached at quiescence (captured at the monitor's final
    gate)."""
    from importlib import import_module

    root = {"jax": "fluidframework_tpu",
            "torch": "fluidframework_tpu_torch"}[pkg]
    monitor = import_module(root + ".chaos.monitor")
    soak = import_module(root + ".chaos.soak")
    fps = {}
    gate = monitor.InvariantMonitor.check_quiescent

    def capture(self, fingerprints):
        fps.update(fingerprints)
        return gate(self, fingerprints)

    monkeypatch.setattr(monitor.InvariantMonitor, "check_quiescent",
                        capture)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    out = soak.run_soak(seed=seed, quick=True, phases="a",
                        mesh_shards=mesh_shards, **kw)
    return {"coverage": out["coverage"], "observed": out["observed"],
            "redelivered": out["redelivered"],
            "counters": out["counters"], "fingerprints": fps}


def test_soak_seed0_equals_jax(monkeypatch):
    got = _soak("torch", 0, monkeypatch)
    want = _soak("jax", 0, monkeypatch)
    assert got == want
    assert set(got["coverage"]) == {"log", "fanout", "stage", "device",
                                    "history"}
    assert len(set(got["fingerprints"].values())) == 1
    assert set(got["fingerprints"]) == {"client0", "client1", "client2",
                                        "device", "oracle"}


def test_soak_mesh_equals_jax(monkeypatch):
    """The stage's farm over a 2-shard mesh (both shards on the CPU)
    against the JAX soak's over 2 virtual devices: the same coverage,
    counts, counters and fingerprints."""
    got = _soak("torch", 0, monkeypatch, mesh_shards=2)
    want = _soak("jax", 0, monkeypatch, mesh_shards=2)
    assert got == want
    assert set(got["coverage"]) == {"log", "fanout", "stage", "device",
                                    "history"}
    assert len(set(got["fingerprints"].values())) == 1
    # and a mesh of cards is refused on a machine without them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        run_soak(seed=0, quick=True, mesh_shards=2)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [7, 42])
def test_soak_other_seeds(seed):
    out = run_soak(seed=seed, quick=True, phases="a", device="cpu")
    assert out["observed"] > 10
