"""The port's relay tier (``service/gateway.py`` and the native relay built
from ``csrc/gateway.cpp``) against ``tests/test_gateway.py``.

One module-scoped topology: the port's front end in this process (on a
background thread) and three gateway processes of the port in front of
it, two native (the default: g++ builds ``csrc/gateway.cpp`` into
``build/torch_kernels/`` at first use) and one started with ``--python``.
The twins of the JAX topology tests run on it, and the three example
demos of that file (``shared_text``, ``clicker``, ``table_doc``) as the
port's own apps (``fluidframework_tpu_torch/examples/``), their editor
processes dialing the first native gateway (not the secured topology,
whose tenancy is ROADMAP A10), plus a JAX client through the port's native
relay, the native relay's library, the refusal to fall back to the
Python relay, and the sharded routing options, which take the Python
relay as in the JAX package.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
    _Transport,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.native import build as native_build
from fluidframework_tpu_torch.service import NetworkFrontEnd
from fluidframework_tpu_torch.service.local_server import LocalServer

ROOT = Path(__file__).resolve().parent.parent


def _spawn(args):
    proc = subprocess.Popen(
        [sys.executable, "-m"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING"), line
    return proc, int(line.rsplit(":", 1)[1])


def wait_for(cond, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if cond():
                return True
        except (KeyError, IndexError):
            pass
        time.sleep(0.02)
    return False


@pytest.fixture(scope="module")
def topology():
    """The port's core in process, two native gateways and one Python
    gateway as processes: yields (core port, native 1, native 2, python,
    the gateway processes)."""
    fe = NetworkFrontEnd(LocalServer()).start_background()
    gw = "fluidframework_tpu_torch.service.gateway"
    procs = []
    try:
        ports = []
        for extra in ([], [], ["--python"]):
            proc, port = _spawn([gw, "--core-port", str(fe.port), *extra])
            procs.append(proc)
            ports.append(port)
        yield (fe.port, *ports, procs)
    finally:
        for proc in procs:
            proc.terminate()
            proc.wait(timeout=10)
        fe.stop()


def _text(container, name="text"):
    ds = container.runtime.data_stores.get("default")
    if ds is None or name not in ds.channels:
        return None
    return ds.get_channel(name).get_text()


@pytest.mark.parametrize("relays", [(1, 2), (1, 3)],
                         ids=["native-native", "native-python"])
def test_clients_on_different_gateways_converge(topology, relays):
    p1, p2 = topology[relays[0]], topology[relays[1]]
    doc = f"gwdoc-{relays[1]}"
    l1 = Loader(NetworkDocumentServiceFactory("127.0.0.1", p1))
    l2 = Loader(NetworkDocumentServiceFactory("127.0.0.1", p2))
    c1 = l1.resolve("t", doc)
    c2 = l2.resolve("t", doc)
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "across gateways")
    assert wait_for(lambda: _text(c2) == "across gateways")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(0, ">> ")
    s1.insert_text(len(s1.get_text()), " <<")
    assert wait_for(
        lambda: s1.get_text() == s2.get_text() == ">> across gateways <<")


def test_gateway_client_and_direct_core_client_interoperate(topology):
    core_port, p1 = topology[0], topology[1]
    lg = Loader(NetworkDocumentServiceFactory("127.0.0.1", p1))
    lc = Loader(NetworkDocumentServiceFactory("127.0.0.1", core_port))
    c1 = lg.resolve("t", "mixdoc")
    c2 = lc.resolve("t", "mixdoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    s1.set("from", "gateway")
    assert wait_for(lambda: c2.runtime.get_data_store("default")
                    .get_channel("kv").get("from") == "gateway")
    c2.runtime.get_data_store("default").get_channel("kv").set("back", "core")
    assert wait_for(lambda: s1.get("back") == "core")


def test_storage_rpcs_pass_through_gateway(topology):
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", topology[1]))
    c1 = loader.resolve("t", "sumdoc")
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "summarize me")
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    sm = SummaryManager(c1, max_ops=10**9)
    sm.summarize_now()
    assert wait_for(lambda: sm.summaries_acked == 1)
    c2 = loader.resolve("t", "sumdoc")
    assert c2._base_snapshot is not None
    assert wait_for(lambda: _text(c2) == "summarize me")


def test_signals_relay_across_gateways(topology):
    l1 = Loader(NetworkDocumentServiceFactory("127.0.0.1", topology[1]))
    l2 = Loader(NetworkDocumentServiceFactory("127.0.0.1", topology[2]))
    c1 = l1.resolve("t", "sigdoc")
    c2 = l2.resolve("t", "sigdoc")
    got = []
    c2.on_signal = lambda sig: got.append(sig.content)
    c1.submit_signal({"ping": 1})
    assert wait_for(lambda: got == [{"ping": 1}])


def _send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj).encode()
    sock.sendall(len(body).to_bytes(4, "big") + body)


def _recv_frame(sock: socket.socket, timeout: float):
    """One length-prefixed JSON frame, or None on timeout."""
    sock.settimeout(timeout)
    try:
        buf = b""
        while len(buf) < 4:
            chunk = sock.recv(4 - len(buf))
            if not chunk:
                return None
            buf += chunk
        n = int.from_bytes(buf, "big")
        body = b""
        while len(body) < n:
            chunk = sock.recv(n - len(body))
            if not chunk:
                return None
            body += chunk
        return json.loads(body.decode())
    except socket.timeout:
        return None


def test_gateway_reconnect_frame_releases_previous_registration(topology):
    """A second connect frame on a live gateway socket detaches the first
    registration (the old client leaves the quorum). The JAX twin runs on
    its secured topology; tenancy is ROADMAP A10, so this one is open."""
    p = topology[1]
    observer = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", p)).resolve("t", "redoc")
    raw = socket.create_connection(("127.0.0.1", p))
    try:
        _send_frame(raw, {"t": "connect", "tenant": "t", "doc": "redoc",
                          "rid": 1, "details": {"mode": "write"}})
        first = _recv_frame(raw, 10.0)
        assert first["t"] == "connected"
        a = first["clientId"]
        assert wait_for(lambda: a in observer.audience)
        _send_frame(raw, {"t": "connect", "tenant": "t", "doc": "redoc",
                          "rid": 2, "details": {"mode": "write"}})
        second = None
        while second is None or second["t"] != "connected":
            second = _recv_frame(raw, 10.0)
            assert second is not None
        b = second["clientId"]
        assert b != a
        assert wait_for(lambda: a not in observer.audience
                        and b in observer.audience)
    finally:
        raw.close()


def test_reconnect_rebase_through_gateway(topology):
    l1 = Loader(NetworkDocumentServiceFactory("127.0.0.1", topology[1]))
    l2 = Loader(NetworkDocumentServiceFactory("127.0.0.1", topology[2]))
    c1 = l1.resolve("t", "rcdoc")
    c2 = l2.resolve("t", "rcdoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "base")
    assert wait_for(lambda: _text(c2) == "base")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    c1.disconnect()
    s1.insert_text(0, "X")
    s2.insert_text(4, "Y")
    assert wait_for(lambda: s2.get_text() == "baseY")
    c1.reconnect()
    assert wait_for(lambda: s1.get_text() == s2.get_text() == "XbaseY")


@pytest.mark.parametrize("relay", [1, 3], ids=["native", "python"])
def test_mixed_protocol_clients_through_gateway(topology, relay):
    p = topology[relay]
    lb = Loader(NetworkDocumentServiceFactory("127.0.0.1", p, binary=True))
    lj = Loader(NetworkDocumentServiceFactory("127.0.0.1", p, binary=False))
    doc = f"gwmix-{relay}"
    cb = lb.resolve("t", doc)
    cj = lj.resolve("t", doc)
    sb = cb.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    sb.insert_text(0, "binary")
    assert wait_for(lambda: _text(cj) == "binary")
    sj = cj.runtime.get_data_store("default").get_channel("text")
    sj.insert_text(0, "json+")
    assert wait_for(lambda: sb.get_text() == "json+binary"
                    and sj.get_text() == "json+binary")


def test_ping_answered_at_every_terminator(topology):
    core_port, native, _, python, _ = topology
    for label, port in (("core", core_port), ("native-gateway", native),
                        ("python-gateway", python)):
        t = _Transport("127.0.0.1", port, timeout=5.0)
        got = []
        t.on_push("pong", got.append)
        try:
            t.send({"t": "ping"})
            assert wait_for(lambda: got), f"no pong from {label}"
        finally:
            t.close()


def test_jax_client_through_the_port_relay(topology):
    """The wire between the packages through a relay: a JAX client on
    the port's native gateway and a port client on the core converge."""
    from fluidframework_tpu.driver import (
        NetworkDocumentServiceFactory as JaxFactory,
    )
    from fluidframework_tpu.loader import Loader as JaxLoader

    cj = JaxLoader(JaxFactory("127.0.0.1", topology[1])).resolve(
        "t", "jaxdoc")
    ct = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", topology[0])).resolve("t", "jaxdoc")
    sj = cj.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    sj.insert_text(0, "jax via relay")
    assert wait_for(lambda: _text(ct) == "jax via relay")
    ct.runtime.get_data_store("default").get_channel("text").insert_text(
        0, "port: ")
    assert wait_for(lambda: sj.get_text() == "port: jax via relay")


def test_native_relays_run_the_port_build(topology):
    """The default gateways are the native relay: each process maps the
    library g++ built from the port's ``csrc/gateway.cpp`` into
    ``build/torch_kernels/``; the ``--python`` one maps none."""
    lib = native_build.build("gateway")
    assert lib.parent == native_build.BUILD_DIR
    assert native_build.source("gateway") == \
        Path(native_build.CSRC) / "gateway.cpp"
    maps = [Path(f"/proc/{p.pid}/maps").read_text() for p in topology[4]]
    assert str(lib) in maps[0] and str(lib) in maps[1]
    assert "libgateway_" not in maps[2]


def test_native_build_failure_raises_without_fallback(monkeypatch):
    """A native build or load failure raises: only ``--python`` selects
    the asyncio relay."""
    from fluidframework_tpu_torch.native import gateway as native_gateway
    from fluidframework_tpu_torch.service import gateway

    def broken(name):
        raise RuntimeError(f"g++ failed on {name}")

    monkeypatch.setattr(native_gateway, "load_library", broken)
    monkeypatch.setattr(gateway.Gateway, "serve_forever",
                        lambda self: pytest.fail("fell back to --python"))
    monkeypatch.setattr(sys, "argv", ["gateway", "--core-port", "1"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on gateway"):
        gateway.main()


@pytest.mark.parametrize("flag,relay", [(["--shard-dir", "x"], "python"),
                                        (["--shards", "2"], "native"),
                                        (["--host-id", "h0"], "native"),
                                        (["--table-server", "h:1"],
                                         "python"),
                                        (["--upstream-gateway", "h:1"],
                                         "python")])
def test_unported_gateway_options_raise(monkeypatch, tmp_path, flag, relay):
    """The sharded routing options now work: ``--shard-dir`` and
    ``--table-server`` route each doc to its partition's lease holder on
    the asyncio relay, ``--upstream-gateway`` stacks on it, as in the JAX
    package; without them the native relay runs. ``Gateway(shard_dir=)``
    builds the routing cache."""
    from fluidframework_tpu_torch.native import gateway as native_gateway
    from fluidframework_tpu_torch.service import gateway

    monkeypatch.chdir(tmp_path)  # the shard dir "x" is relative
    ran = []

    class FakeNative:
        port = 9

        def __init__(self, core_host, core_port, host, port):
            ran.append(("native", core_host, core_port))

        def run(self):
            return 0

    monkeypatch.setattr(native_gateway, "NativeGateway", FakeNative)
    monkeypatch.setattr(gateway.Gateway, "serve_forever",
                        lambda self: ran.append(("python", self)))
    monkeypatch.setattr(sys, "argv", ["gateway", "--core-port", "1", *flag])
    if relay == "native":
        with pytest.raises(SystemExit) as done:
            gateway.main()
        assert done.value.code == 0
    else:
        gateway.main()
    assert [r[0] for r in ran] == [relay]
    if flag[0] in ("--shard-dir", "--table-server"):
        assert ran[0][1].routing is not None
        assert ran[0][1].placement.n == 0
    if flag[0] == "--upstream-gateway":
        assert (ran[0][1].core_host, ran[0][1].core_port) == ("h", 1)
    routed = gateway.Gateway("127.0.0.1", 1, shard_dir="x", shards=2)
    assert routed.routing is not None and routed.placement.n == 2
    assert gateway.Gateway("127.0.0.1", 1, shards=2).routing is None


def _run_app(app: str, port: int, capfd) -> str:
    """The port's app ``run_clients`` against ``port``; its stdout."""
    from importlib import import_module

    mod = import_module(f"fluidframework_tpu_torch.examples.{app}")
    assert mod.run_clients(port) == 0
    return capfd.readouterr().out


def test_shared_text_example_demo_converges(topology, capfd):
    """Two editor processes edit concurrently through a gateway and
    render identical documents."""
    out = _run_app("shared_text", topology[1], capfd)
    assert "CONVERGED" in out
    assert "⟦verify deli ordering claim⟧" in out  # anchored comment
    assert "**Welcome**" in out  # bold annotation rendered


def test_clicker_example_demo_converges(topology, capfd):
    """BASELINE config 2: 4 clicker processes hammer one counter through
    a gateway and the total converges."""
    out = _run_app("clicker", topology[1], capfd)
    assert "CONVERGED: 4 processes x 25 clicks = 100" in out


def test_table_doc_example_demo_converges(topology, capfd):
    """Matrix + map + string in one container: two editor processes,
    a row insert racing cell writes, identical tables."""
    out = _run_app("table_doc", topology[1], capfd)
    assert "CONVERGED" in out
    assert "TOTAL" in out
    assert "region" in out
