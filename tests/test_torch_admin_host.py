"""The port's operator and developer surface against
``tests/test_admin_host.py``: the admin CLI (``fluidframework_tpu_torch/
admin.py``), the dev host (``host.py``), the seven example apps
(``fluidframework_tpu_torch/examples/``) and the offline doctor
(``tools/doctor.py`` of the port).

The twins of the JAX file's seven tests (ten cases): the admin tests run
the port's core in this process (on a background thread); the demos run
each app's ``run_clients`` against one such core (the apps' actors are
processes of their own, as the apps make them); the two dev-host tests
run ``python -m fluidframework_tpu_torch.host`` on its ``gateway`` and
``sharded`` topologies, the one place this file starts a fleet of
processes. Beside them, held against the JAX package on one port core
(a process of its own for the bundle, whose boot counters are the
process's):
the JAX admin CLI and the port's print the same ``status``, ``docs``,
``tenants`` and ``monitor`` lines (RTT masked); ``monitor`` over a CPU
``ApplierStage`` shows ``applier_lag 0`` for every doc in both; the
port's ``bundle`` holds the JAX bundle's files less ``lint.json``; the
JAX doctor and the port's give the same report on one bundle.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.service import NetworkFrontEnd
from fluidframework_tpu_torch.service.local_server import LocalServer

ROOT = Path(__file__).resolve().parent.parent
APPS = ("shared_text", "clicker", "table_doc", "todo", "canvas", "sudoku",
        "album")


def _core(admin_secret=None, tenants=None, log=None,
          backchannel=None) -> NetworkFrontEnd:
    """The port's core in this process (``front_end --admin-secret S
    --tenant id:secret --log-dir L --consume-backchannel B``)."""
    manager = None
    if tenants:
        from fluidframework_tpu_torch.service.tenants import TenantManager

        manager = TenantManager()
        for tid, secret in tenants.items():
            manager.register(tid, secret)
    server = (LocalServer(tenants=manager, log=log)
              if manager is not None or log is not None else None)
    front = NetworkFrontEnd(server=server, admin_secret=admin_secret)
    if backchannel is not None:
        front.attach_backchannel(backchannel)
    return front.start_background()


def _stop(front: NetworkFrontEnd, log=None) -> None:
    front.stop()
    if log is not None:
        log.close()


def _admin(port, *argv):
    from fluidframework_tpu_torch import admin

    return admin.main(["--port", str(port), *argv])


def _jax_admin(port, *argv):
    from fluidframework_tpu import admin

    return admin.main(["--port", str(port), *argv])


def _edit(port: int, doc: str, text: str):
    """One port client's container with a string holding ``text``, every
    op acked."""
    c = Loader(NetworkDocumentServiceFactory("127.0.0.1", port)).resolve(
        "t", doc)
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, text)
    t0 = time.time()
    while c.runtime.pending.count > 0 and time.time() - t0 < 10:
        time.sleep(0.02)
    assert c.runtime.pending.count == 0
    return c


def _run(argv, timeout=240):
    return subprocess.run([sys.executable, "-m", *argv],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))


# ------------------------------------------- twins of test_admin_host.py


def test_admin_status_docs_and_tenant_crud(capsys):
    front = _core(admin_secret="s3s4m3")
    try:
        port = front.port
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c = _edit(port, "admindoc", "hello")

        args = ("--admin-secret", "s3s4m3")
        assert _admin(port, *args, "status", "t", "admindoc") == 0
        status = json.loads(capsys.readouterr().out)
        assert status["seq"] >= 2  # join + at least the insert
        assert status["clients"] and \
            status["clients"][0]["clientId"] == c.client_id
        assert status["msn"] <= status["seq"]

        assert _admin(port, *args, "docs") == 0
        assert "t/admindoc" in capsys.readouterr().out

        # a wrong secret is refused
        with pytest.raises(RuntimeError):
            _admin(port, "--admin-secret", "wrong", "docs")

        # tenant CRUD round-trip
        assert _admin(port, *args, "tenant-add", "acme", "shh") == 0
        capsys.readouterr()
        assert _admin(port, *args, "tenants") == 0
        assert "acme" in capsys.readouterr().out
        # tenancy is now enforcing: an unsigned connect is refused
        from fluidframework_tpu_torch.service.tenants import sign_token

        with pytest.raises(RuntimeError):
            loader.resolve("acme", "secured")
        signed = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", port,
            token_provider=lambda t, d: sign_token(t, d, "shh")))
        c2 = signed.resolve("acme", "secured")
        assert c2.connected
        assert _admin(port, *args, "tenant-rm", "acme") == 0
        assert _admin(port, *args, "tenant-rm", "acme") == 1
    finally:
        _stop(front)


def test_admin_requires_secret_on_secured_deployment():
    front = _core(tenants={"acme": "shh"})
    try:
        with pytest.raises(RuntimeError):
            _admin(front.port, "docs")
    finally:
        _stop(front)


def test_mutating_admin_calls_refused_without_secret(capsys):
    """On a secret-less deployment with no tenants registered, reads stay
    open but tenant CRUD is refused (no open bootstrap)."""
    front = _core()
    try:
        port = front.port
        assert _admin(port, "docs") == 0
        capsys.readouterr()
        with pytest.raises(RuntimeError):
            _admin(port, "tenant-add", "acme", "shh")
        with pytest.raises(RuntimeError):
            _admin(port, "tenant-rm", "acme")
        # the refusal really kept tenancy open: unsigned connects work
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c = loader.resolve("t", "stillopen")
        assert c.client_id
    finally:
        _stop(front)


@pytest.fixture(scope="module")
def demo_core():
    front = _core()
    try:
        yield front.port
    finally:
        _stop(front)


@pytest.mark.parametrize("app", ["todo", "canvas", "sudoku", "album"])
def test_example_demo_converges(app, demo_core, capfd):
    mod = import_module(f"fluidframework_tpu_torch.examples.{app}")
    assert mod.run_clients(demo_core) == 0
    assert "CONVERGED" in capfd.readouterr().out


def test_dev_host_runs_app_on_gateway_topology():
    out = _run(["fluidframework_tpu_torch.host", "todo", "-t", "gateway"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CONVERGED" in out.stdout


def test_dev_host_runs_app_on_sharded_topology():
    out = _run(["fluidframework_tpu_torch.host", "canvas", "-t", "sharded"])
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CONVERGED" in out.stdout


def test_admin_monitor_ticks_live_status(capsys):
    """``admin monitor`` prints ping RTT and one line per live doc with
    its seq, msn, client count and applier lag."""
    front = _core()
    try:
        _edit(front.port, "mondoc", "watch me")
        assert _admin(front.port, "monitor", "--interval", "0.2",
                      "--count", "2") == 0
        out = capsys.readouterr().out
        assert out.count("tick ") == 2
        assert "t/mondoc: seq " in out
        assert "clients 1" in out
        assert "applier_lag -" in out  # no applier stage attached
    finally:
        _stop(front)


# ------------------------------------------------ the apps and the host


@pytest.mark.parametrize("app", APPS)
def test_run_demo_serves_the_ports_front_end(app, monkeypatch):
    """``run_demo()`` starts the port's core as a process and drives the
    app's clients against it: every app answers ``run_clients`` on the
    port its core printed, and leaves no core running."""
    mod = import_module(f"fluidframework_tpu_torch.examples.{app}")
    seen = []

    def run_clients(port, *args):
        with socket_to(port):
            seen.append(port)
        return 0

    monkeypatch.setattr(mod, "run_clients", run_clients)
    started = []
    popen = subprocess.Popen

    def spy(argv, *a, **kw):
        started.append(argv)
        return popen(argv, *a, **kw)

    monkeypatch.setattr(mod.subprocess, "Popen", spy)
    monkeypatch.chdir(ROOT)
    assert mod.run_demo() == 0
    assert len(seen) == 1 and seen[0] > 0
    (argv,) = started
    assert argv[1:3] == ["-m", "fluidframework_tpu_torch.service.front_end"]


def socket_to(port: int):
    import socket

    return socket.create_connection(("127.0.0.1", port), timeout=10)


def test_dev_host_loads_the_ports_apps_and_topologies(monkeypatch):
    """Each topology spawns the port's modules; ``main`` imports the
    port's app by name, and refuses ``-t`` other than ``single`` for an
    app with no ``run_clients``."""
    import types

    from fluidframework_tpu_torch import host

    spawned = []

    def fake_spawn(args, ready="LISTENING"):
        spawned.append(args[0])
        return types.SimpleNamespace(poll=lambda: 0), 1

    monkeypatch.setattr(host, "_spawn", fake_spawn)
    for kind in ("single", "gateway", "split", "sharded"):
        with host.topology(kind) as port:
            assert port == 1
    assert set(spawned) == {
        "fluidframework_tpu_torch.service.front_end",
        "fluidframework_tpu_torch.service.gateway",
        "fluidframework_tpu_torch.service.storage_server",
        "fluidframework_tpu_torch.service.stage_runner"}
    with pytest.raises(ValueError):
        with host.topology("mesh"):
            pass

    legacy = types.ModuleType("fluidframework_tpu_torch.examples.legacy")
    legacy.run_demo = lambda: 0
    monkeypatch.setitem(sys.modules, legacy.__name__, legacy)
    monkeypatch.setattr(sys, "argv", ["host", "legacy", "-t", "gateway"])
    with pytest.raises(SystemExit) as exit_info:
        host.main()
    assert exit_info.value.code == 2
    monkeypatch.setattr(sys, "argv", ["host", "legacy"])
    with pytest.raises(SystemExit) as exit_info:
        host.main()
    assert exit_info.value.code == 0


# ------------------------------------------- parity with the JAX package


def _mask(text: str) -> str:
    return re.sub(r"rtt [0-9.]+ms", "rtt Xms", text)


def test_admin_cli_prints_what_the_jax_cli_prints(capsys):
    """The JAX admin CLI and the port's, against one port core after the
    same edits, print the same ``status``, ``docs``, ``tenants`` and
    ``monitor`` lines (RTT masked)."""
    front = _core(admin_secret="adm")
    try:
        port = front.port
        held = [_edit(port, f"par{i}", f"doc {i}") for i in range(3)]
        secret = ("--admin-secret", "adm")
        assert _admin(port, *secret, "tenant-add", "acme", "shh") == 0
        capsys.readouterr()
        for argv in (("status", "t", "par1"), ("status", "t", "nodoc"),
                     ("docs",), ("tenants",),
                     ("monitor", "--interval", "0.05", "--count", "2")):
            rc_port = _admin(port, *secret, *argv)
            out_port = capsys.readouterr().out
            rc_jax = _jax_admin(port, *secret, *argv)
            out_jax = capsys.readouterr().out
            assert (rc_port, _mask(out_port)) == (rc_jax, _mask(out_jax)), \
                argv
            assert out_port
        assert "t/par2: seq " in out_port and "applier_lag -" in out_port
        assert len(held) == 3
    finally:
        _stop(front)


def test_monitor_shows_zero_applier_lag_over_a_cpu_stage(tmp_path, capsys):
    """``monitor`` over a core whose applier stage (``ApplierStage`` on
    the CPU, the stage child's loop body) drained the core's durable log:
    every doc shows ``applier_lag 0``, in the port's CLI and the JAX
    one."""
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.stage_runner import ApplierStage

    from fluidframework_tpu_torch.service.placement_plane import admin_rpc

    log_dir, state_dir = tmp_path / "log", tmp_path / "state"
    stage = ApplierStage(str(log_dir), str(state_dir), max_docs=8,
                         max_slots=64, device="cpu")
    log = DurableLog(str(log_dir))
    front = _core(log=log, backchannel=str(state_dir))
    docs = [f"lag{i}" for i in range(4)]
    held = []
    try:
        held += [_edit(front.port, d, f"text of {d}") for d in docs]

        def lags():
            out = {}
            for d in docs:
                st = admin_rpc("127.0.0.1", front.port, {
                    "t": "admin_status", "tenant": "t", "doc": d})["status"]
                out[d] = st["seq"] - (st["applierSeq"] or 0)
            return out

        deadline = time.time() + 30
        while any(lags().values()):
            assert time.time() < deadline, lags()
            stage.run_once()
            time.sleep(0.05)
        for cli in (_admin, _jax_admin):
            assert cli(front.port, "monitor", "--interval", "0.05",
                       "--count", "1") == 0
            out = capsys.readouterr().out
            rows = [ln for ln in out.splitlines() if ln.startswith("  t/")]
            assert len(rows) == len(docs), out
            assert all(ln.endswith("applier_lag 0") for ln in rows), out
    finally:
        for c in held:
            c.close()
        stage.shared.close()
        _stop(front, log)


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")
            if p.is_file()}


def test_bundle_holds_the_jax_bundles_files_less_lint(tmp_path, capsys):
    """One core bundled by both CLIs: the same files, but the port's
    has no ``lint.json`` and says why in its manifest; the JAX doctor
    and the port's give the same report on the port's bundle, the
    static-contract line aside. The core is a process of its own: a
    bundle carries its process's boot counters, which other tests in
    this process would have moved."""
    from fluidframework_tpu_torch import admin
    from fluidframework_tpu_torch.tools import doctor as port_doctor
    from tools import doctor as jax_doctor

    core = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT))
    try:
        line = core.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        port = int(line.rsplit(":", 1)[1])
        _edit(port, "bdoc", "bundled").close()
        assert _admin(port, "flight", "dump", "--reason", "t") == 0
        port_out, jax_out = tmp_path / "port", tmp_path / "jax"
        assert _admin(port, "bundle", "--out", str(port_out)) == 0
        said = capsys.readouterr().out
        assert ("python -m fluidframework_tpu_torch.tools.doctor "
                f"{port_out}") in said
        assert _jax_admin(port, "bundle", "--out", str(jax_out)) == 0
    finally:
        core.terminate()
        core.wait(timeout=10)
    assert _files(port_out) == _files(jax_out) - {"lint.json"}
    assert "lint.json" in _files(jax_out)
    manifest = json.loads((port_out / "manifest.json").read_text())
    assert manifest["lint"] == admin.LINT_NOT_CAPTURED
    assert "lint_clean" not in manifest
    assert set(manifest["cores"]) == {"local"}

    report = port_doctor.diagnose(str(port_out))
    assert report == jax_doctor.diagnose(str(port_out))
    # a single core arms its journal only with --journal
    assert report["lint"] is None and report["anomalies"] == [
        "core local: journal disarmed — no audit trail from this core"]
    capsys.readouterr()
    assert port_doctor.main([str(port_out)]) == 1
    port_text = capsys.readouterr().out
    assert jax_doctor.main([str(port_out)]) == 1
    jax_text = capsys.readouterr().out
    assert "(no lint.json in bundle — not captured)" in port_text
    assert port_text.replace(
        "(no lint.json in bundle — not captured)",
        "(no lint.json in bundle — captured without the repo)") == jax_text


def test_doctors_agree_on_an_incident_bundle(tmp_path, capsys):
    """The JAX doctor and the port's read a bundle dirty across every
    rule family alike: the same report, the same printed triage, the
    same exit code."""
    from fluidframework_tpu_torch.tools import doctor as port_doctor
    from tests.test_health_plane import _incident_bundle
    from tools import doctor as jax_doctor

    bundle = str(_incident_bundle(tmp_path)[0])
    report = port_doctor.diagnose(bundle)
    assert report == jax_doctor.diagnose(bundle)
    assert len(report["anomalies"]) >= 10
    capsys.readouterr()
    assert port_doctor.main([bundle]) == jax_doctor.main([bundle]) == 1
    port_text, jax_text = capsys.readouterr().out.split("== fleet ==")[1:]
    assert port_text == jax_text
    assert port_doctor.main([]) == 2
    assert port_doctor.main([str(tmp_path / "missing")]) == 2


def test_doctor_runs_as_a_module(tmp_path):
    """``python -m fluidframework_tpu_torch.tools.doctor BUNDLE`` is the
    command the port's ``bundle`` names."""
    from tests.test_health_plane import _incident_bundle

    bundle = str(_incident_bundle(tmp_path)[0])
    out = _run(["fluidframework_tpu_torch.tools.doctor", bundle],
               timeout=60)
    assert out.returncode == 1, out.stderr
    assert "== anomalies ==" in out.stdout
    assert "not captured" not in out.stdout
    assert os.path.isdir(bundle)
