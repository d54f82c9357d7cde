"""Health-plane twin: the port's streaming doctor (``obs/health.py`` over
its own ``obs/doctor_rules.py``), canary isolation and the fleet health
gate against the JAX package, on the CPU.

The cases of ``tests/test_health_plane.py``:

* one incident bundle read by the JAX offline doctor
  (``tools/doctor.py::diagnose``) and by the port's ``HealthEngine``
  over live-shaped sources gives the same 13 anomalies and the same
  ``slo_burn`` rows, and the JAX engine fed the same sources gives the
  same status;
* the port's engine and the JAX engine, fed the same probe, placement
  and peer rows, give the same verdicts, component states, reasons and
  journaled transitions tick by tick;
* the canary tenant is never charged by the port's admission gate and
  never lands in its hop windows;
* one in-process port fleet with ``spec.health`` armed answers
  ``wait_healthy`` probe-backed and ``ok``, fleet-wide through
  ``admin_health``, with no canary trace in heat, hop windows, buckets
  or the scrape; an unarmed port fleet times out.

Comparisons are exact.
"""

from __future__ import annotations

import json
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from tests.test_health_plane import (
    _entry,
    _incident_bundle,
    _probe_status,
)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]
    return SimpleNamespace(
        health=import_module(f"{root}.obs.health"),
        journal=import_module(f"{root}.obs.journal"),
        metrics=import_module(f"{root}.obs.metrics"),
        probe=import_module(f"{root}.obs.probe"))


PKGS = {name: _pkg(name) for name in ROOTS}
PORT, JAX = PKGS["torch"], PKGS["jax"]


def _engine(P, **sources):
    sources.setdefault("recorder", SimpleNamespace(
        dump=lambda *a, **k: "dump"))
    return P.health.HealthEngine(registry=P.metrics.MetricsRegistry(),
                                 **sources)


# ------------------------------------------------ offline/live equivalence


def _incident_sources(art):
    return dict(
        core="core0",
        scrape_fn=lambda: art["scrape"],
        journal_fn=lambda: list(art["journal"]),
        placement_fn=lambda: art["placement"],
        cores_fn=lambda: dict(art["manifest"]["cores"]),
        slo_fn=lambda: art["slo"],
        boot_fn=lambda: art["boot"],
        lint_fn=lambda: {"clean": False,
                         "violations": [{"pass": "layers",
                                         "message": "bad import",
                                         "path": "x.py", "line": 3}]},
        self_row_fn=lambda: art["manifest"]["cores"]["core0"])


def test_offline_live_equivalence(tmp_path):
    """The same incident through the JAX offline doctor (bundle) and
    the port's HealthEngine (live sources): the identical 13 anomalies
    and SLO burn rows; the JAX engine's status equals the port's."""
    from tools.doctor import diagnose

    bundle, art = _incident_bundle(tmp_path)
    report = diagnose(str(bundle))
    status = {}
    for name, P in PKGS.items():
        eng = _engine(P, **_incident_sources(art))
        eng.evaluate()
        status[name] = (sorted(eng.anomalies()), eng.slo_burn,
                        eng.status())
        if name == "torch":
            assert sorted(eng.anomalies()) == sorted(report["anomalies"])
            assert len(report["anomalies"]) == 13
            assert eng.slo_burn == report["slo_burn"]
            assert eng.slo_burn[0]["core"] == "core0"
            assert eng.verdict() == "critical"
            assert eng.status()["components"]["placement"]["state"] \
                == "critical"
    assert status["torch"] == status["jax"]


def test_equivalence_on_healthy_fixture(tmp_path):
    from tools.doctor import diagnose

    bundle = tmp_path / "bundle"
    c0 = bundle / "cores" / "core0"
    c0.mkdir(parents=True)
    (bundle / "manifest.json").write_text(json.dumps({"cores": {
        "core0": {"addr": "127.0.0.1:7000", "journal_armed": True}}}))
    journal = [_entry(1, 100.0, "lease.claim", part="0")]
    (c0 / "journal.jsonl").write_text(
        "\n".join(json.dumps(e) for e in journal) + "\n")
    (c0 / "scrape.prom").write_text("fluid_net_frames_total 5\n")
    assert diagnose(str(bundle))["anomalies"] == []
    status = {}
    for name, P in PKGS.items():
        eng = _engine(P, core="core0",
                      scrape_fn=lambda: "fluid_net_frames_total 5\n",
                      journal_fn=lambda: list(journal),
                      self_row_fn=lambda: {"journal_armed": True})
        eng.evaluate()
        status[name] = eng.status()
        assert eng.anomalies() == [] and eng.verdict() == "ok"
    assert status["torch"] == status["jax"]


def test_doctor_rules_copy_equals_tools():
    """The port's rule module is a copy of ``tools/doctor_rules.py``:
    every public rule and constant, with the same source."""
    import inspect

    from fluidframework_tpu_torch.obs import doctor_rules as port
    from tools import doctor_rules as ref

    names = sorted(n for n in vars(ref) if not n.startswith("__")
                   and n != "annotations")
    assert names == sorted(n for n in vars(port) if not n.startswith("__")
                           and n != "annotations")
    for n in names:
        a, b = getattr(ref, n), getattr(port, n)
        if callable(a):
            assert inspect.getsource(a) == inspect.getsource(b), n
        elif not inspect.ismodule(a):
            assert a == b, n


# --------------------------------------------------------- state machine


def _streak_run(P, tmp_path) -> dict:
    path = str(tmp_path / P.health.__name__ / "c0.jsonl")
    P.journal.arm_journal(path, core="c0")
    try:
        dumps = []

        def dump(reason, **fields):
            dumps.append((reason, fields))
            return f"/flight/{len(dumps)}.jsonl"

        state = {"failures": 0}
        eng = _engine(P, core="c0",
                      probe_fn=lambda: _probe_status(state["failures"]),
                      recorder=SimpleNamespace(dump=dump),
                      critical_ticks=3, probe_fail_critical=99)
        ticks = []
        for failures in (0, 1, 2, 3, 0):
            state["failures"] = failures
            eng.evaluate()
            ticks.append((eng.verdict(), eng.status()))
        entries = P.journal.read_journal(path)
        trans = [(e["labels"]["prev"], e["labels"]["state"],
                  e["cause"] is not None)
                 for e in entries if e["kind"] == "health.state"]
        dump_entries = [e for e in entries if e["kind"] == "flight.dump"]
        crit = [e for e in entries if e["kind"] == "health.state"][1]
        linked = crit["cause"] == dump_entries[0]["id"]
        return {"ticks": ticks, "trans": trans, "dumps": dumps,
                "n_dump_entries": len(dump_entries), "linked": linked,
                "dump_reason": dump_entries[0]["labels"]["reason"]}
    finally:
        P.journal.reset_journal()
        # the singleton keeps the registry its first emit found; a later
        # test's reset_registry would leave it counting into a dropped one
        P.journal.get_journal()._registry = None


def test_engine_streak_escalation_and_recovery(tmp_path):
    """ok → degraded → critical after ``critical_ticks`` → ok: the
    port's verdicts, component rows, journaled transitions and the
    critical one's link to its flight dump equal the JAX engine's."""
    got = _streak_run(PORT, tmp_path)
    assert [v for v, _ in got["ticks"]] == ["ok", "degraded", "degraded",
                                           "critical", "ok"]
    assert got["ticks"][1][1]["components"]["probe"]["state"] \
        == "degraded"
    assert [t[:2] for t in got["trans"]] == [
        ("ok", "degraded"), ("degraded", "critical"), ("critical", "ok")]
    assert got["dumps"][0][1]["component"] == "probe"
    assert got["n_dump_entries"] == 1 and got["linked"]
    assert got["dump_reason"] == "health_critical"
    assert got == _streak_run(JAX, tmp_path)


def test_engine_hard_probe_signal_skips_streak():
    def case(P):
        eng = _engine(P, core="c0", probe_fn=lambda: _probe_status(3),
                      critical_ticks=100, probe_fail_critical=3)
        eng.evaluate()
        return eng.verdict(), eng.status()

    verdict, status = case(PORT)
    assert verdict == "critical"
    assert any("canary probe connect failing (3 consecutive)" in r
               for r in status["components"]["probe"]["reasons"])
    assert (verdict, status) == case(JAX)
    assert PORT.health.STATE_OK < PORT.health.STATE_DEGRADED \
        < PORT.health.STATE_CRITICAL


def test_engine_unreachable_peer_rows_are_hard():
    placement = {"parts": {}, "cores": {
        "c0": {"addr": "127.0.0.1:1", "state": "active", "host": "h0"},
        "c1": {"addr": "10.0.0.2:1", "state": "active", "host": "h1"},
        "c2": {"addr": "10.0.0.2:2", "state": "active", "host": "h1"},
    }}
    rows = {"c1": {"addr": "10.0.0.2:1", "error": "refused"},
            "c2": {"addr": "10.0.0.2:2", "error": "timeout"}}

    def case(P):
        eng = _engine(P, core="c0", placement_fn=lambda: placement,
                      cores_fn=lambda: rows, critical_ticks=100)
        eng.evaluate()
        return eng.verdict(), eng.anomalies(), eng.status()

    verdict, anomalies, status = case(PORT)
    assert verdict == "critical"
    assert any("host group h1" in r for r in anomalies)
    assert (verdict, anomalies, status) == case(JAX)


# ------------------------------------------------------- canary isolation


def test_admission_never_charges_canary():
    """The port's admission gate, built by ``enable_admission``, never
    charges or sheds the canary tenant, and sheds a real one, as the
    JAX gate does."""
    from fluidframework_tpu_torch.service.admission import (
        AdmissionController,
    )
    from fluidframework_tpu.service.admission import (
        AdmissionController as JaxAdmission,
    )

    def case(cls, canary):
        adm = cls(lambda t: (0.001, 1.0),
                  registry=PORT.metrics.MetricsRegistry())
        adm.engine = SimpleNamespace(shed_signal="violated")
        conn = SimpleNamespace(tenant_id=canary)
        waits = [adm.check(conn, 100, c, now=0.0) for c in (1, 2, 3)]
        real = SimpleNamespace(tenant_id="acme")
        waits += [adm.check(real, 100, 1, now=0.0),
                  adm.check(real, 100, 2, now=0.0) > 0.0]
        return waits, sorted(adm._buckets)

    got = case(AdmissionController, PORT.probe.CANARY_TENANT)
    assert got == ([0.0, 0.0, 0.0, 0.0, True], ["acme"])
    assert got == case(JaxAdmission, JAX.probe.CANARY_TENANT)
    assert PORT.probe.CANARY_TENANT == JAX.probe.CANARY_TENANT


def test_stamp_abatch_skips_canary_hops(monkeypatch):
    import fluidframework_tpu_torch.service.front_end as fe
    from fluidframework_tpu_torch.utils.telemetry import (
        HOP_ADMIT,
        HOP_SUBMIT,
    )

    canary = PORT.probe.CANARY_TENANT
    monkeypatch.setattr(fe.binwire, "stamp_cols_ops", lambda *a, **k: b"")
    PORT.metrics.reset_registry()
    try:
        reg = PORT.metrics.get_registry()

        def batch(topic):
            box = SimpleNamespace(
                wire_cols=b"\x00", client_id="c",
                hops=[(HOP_SUBMIT, 1.0), (HOP_ADMIT, 1.002)])
            return SimpleNamespace(boxcar=box, base_seq=1, msns=None,
                                   timestamp=0.0), topic

        fe._stamp_abatch(*batch(f"{canary}/__probe__0"))
        assert reg.window_sum("obs.hop.window_ms") == 0.0
        fe._stamp_abatch(*batch("acme/doc"))
        assert reg.window_sum("obs.hop.window_ms", tenant="acme") > 0.0
        assert reg.window_sum("obs.hop.window_ms", tenant=canary) == 0.0
    finally:
        PORT.metrics.reset_registry()


# ------------------------------------------------- the fleet health gate


def test_fleet_wait_healthy_probe_backed_and_isolated(tmp_path):
    """An in-process port fleet with ``spec.health``: every core arms
    its prober and engine; ``wait_healthy`` returns only once canaries
    walked every door; fleet ``admin_health`` aggregates to ok; the
    canary left no trace in heat, hop windows, buckets or the scrape."""
    from fluidframework_tpu_torch.service.placement_plane import admin_rpc
    from fluidframework_tpu_torch.service.rebalancer import HEAT_OPS
    from fluidframework_tpu_torch.service.topology import (
        Fleet,
        default_spec,
    )

    canary = PORT.probe.CANARY_TENANT
    PORT.metrics.reset_registry()
    spec = default_spec(str(tmp_path / "fleet"), n_cores=2,
                        n_partitions=4, lease_ttl=2.0,
                        health={"probe_tick_s": 0.2, "tick_s": 0.2})
    fl = Fleet(spec).start()
    try:
        fl.wait_claimed()
        for front in fl.fronts.values():
            assert front.prober is not None
            assert front.health_engine is not None
        verdicts = fl.wait_healthy(timeout=30.0)
        assert sorted(verdicts) == ["core0", "core1"]
        for h in verdicts.values():
            assert h["verdict"] == "ok"
            for door in ("connect", "submit", "history", "route"):
                assert h["probes"]["doors"][door]["probes"] > 0
                assert h["probes"]["doors"][door]["ok"]
        fleet_h = admin_rpc(*fl.core_addr(0),
                            {"t": "admin_health", "fleet": 1},
                            timeout=15.0)["health"]
        assert fleet_h["fleet"] is True and fleet_h["verdict"] == "ok"
        assert len(fleet_h["cores"]) == 2
        reg = PORT.metrics.get_registry()
        assert reg.window_sum(HEAT_OPS) == 0.0
        assert reg.window_sum("obs.hop.window_ms", tenant=canary) == 0.0
        assert canary not in reg.scrape()
        for front in fl.fronts.values():
            adm = front.admission
            assert adm is None or canary not in adm._buckets
        assert reg.window_sum("health.probe.ms", door="connect") > 0.0
    finally:
        fl.stop()
        PORT.metrics.reset_registry()
    for front in fl.fronts.values():
        assert front.prober is None and front.health_engine is None


def test_wait_healthy_times_out_on_unarmed_fleet(tmp_path):
    from fluidframework_tpu_torch.service.topology import (
        Fleet,
        default_spec,
    )

    spec = default_spec(str(tmp_path / "fleet"), n_cores=1,
                        n_partitions=2, lease_ttl=2.0)
    fl = Fleet(spec).start()
    try:
        fl.wait_claimed()
        with pytest.raises(TimeoutError) as ei:
            fl.wait_healthy(timeout=1.5)
        assert "unknown" in str(ei.value)
    finally:
        fl.stop()
