"""The port's read-scale fan-out (``service/presence.py``'s coalesced
presence lane, read-only sessions through ``driver/`` and ``loader/``,
the relay tree of ``service/gateway.py``) against
``tests/test_read_fanout.py``.

Each test is the twin of the JAX test of the same name. The presence
lane and its codec are fixed by their input: each runs on both packages
with the JAX test's assertions, and the delivered batches, the presence
frames (client and backbone forms) and the counters are equal between
the packages byte for byte. The read-only and relay-tree tests need
sockets: they run the JAX test's assertions on the port alone, the core
in process where the JAX test runs it so, and the tree as one fleet of
the port's processes for the file (core, a ``--python`` mid gateway on a
fixed port, a leaf dialing it with ``--upstream-gateway``). The mid-tier
kill runs last on that fleet: it kills the mid gateway and starts
another on the same port. Tolerance: exact.
"""

from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.service import LocalServer, NetworkFrontEnd

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("jax", "torch")


def wait_for(pred, timeout=15.0, interval=0.005):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if pred():
                return True
        except (KeyError, IndexError):
            pass
        time.sleep(interval)
    return False


def _both(scenario) -> None:
    shown = {pkg: scenario(pkg) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _lane(pkg):
    lane = module(pkg, "service.presence").PresenceLane(
        module(pkg, "obs").tier_counters(f"presence_test_{pkg}"))
    return lane, module(pkg, "protocol.messages").Signal


def _sig_rows(batch):
    return [(s.client_id, s.type, s.content) for s in batch.signals]


def _lww(pkg):
    lane, signal = _lane(pkg)
    got = []
    lane.subscribe("t/d", got.append)
    for i in range(10):
        lane.publish("t/d", signal(client_id="c1", type="cursor",
                                   content={"i": i}))
    lane.publish("t/d", signal(client_id="c2", type="cursor",
                               content={"i": 99}))
    lane.publish("t/d", signal(client_id="c1", type="select",
                               content={"s": 1}))
    lane.flush()
    assert len(got) == 1
    sigs = {(s.client_id, s.type): s.content for s in got[0].signals}
    assert sigs == {("c1", "cursor"): {"i": 9},
                    ("c2", "cursor"): {"i": 99},
                    ("c1", "select"): {"s": 1}}
    snap = lane.counters.snapshot()
    assert snap["presence.lane.coalesced"] == 9
    assert snap["presence.lane.signals"] == 12
    return [_sig_rows(got[0]), got[0].presence_frame(),
            got[0].fpresence_frame(), snap]


def test_presence_lww_coalesces_per_client_and_type():
    _both(_lww)


def _flush_batches(pkg):
    lane, signal = _lane(pkg)
    got_a, got_b = [], []
    sub_a, sub_b = got_a.append, got_b.append
    lane.subscribe("t/a", sub_a)
    lane.subscribe("t/a", sub_b)
    lane.publish("t/a", signal(client_id="x", type="s", content=1))
    lane.publish("t/nobody", signal(client_id="x", type="s", content=2))
    delivered = lane.flush()
    assert delivered == 2
    assert got_a[0] is got_b[0]
    assert lane.flush() == 0
    lane.unsubscribe("t/a", sub_a)
    assert lane.watching("t/a")
    lane.unsubscribe("t/a", sub_b)
    assert not lane.watching("t/a")
    return [delivered, _sig_rows(got_a[0]), got_a[0].presence_frame(),
            lane.counters.snapshot()]


def test_presence_flush_batches_and_unwatched_topics_evaporate():
    _both(_flush_batches)


def _encodes_once(pkg):
    lane, signal = _lane(pkg)
    batches = []
    lane.subscribe("t/d", batches.append)
    lane.publish("t/d", signal(client_id="c", type="s", content={"k": 1}))
    lane.flush()
    pb = batches[0]
    assert pb.presence_frame() is pb.presence_frame()
    assert pb.fpresence_frame() is pb.fpresence_frame()
    assert pb.signal_dicts() is pb.signal_dicts()
    return [pb.presence_frame(), pb.fpresence_frame(), pb.signal_dicts()]


def test_presence_batch_encodes_once_per_wire_form():
    _both(_encodes_once)


def _codec(pkg):
    bw = module(pkg, "protocol.binwire")
    signal = module(pkg, "protocol.messages").Signal
    sigs = [signal(client_id="c1", type="cursor", content={"x": 3}),
            signal(client_id=None, type="system", content=[1, "two"])]
    body = bw.encode_presence(sigs)
    out = bw.decode_presence(body)
    assert [(s.client_id, s.type, s.content) for s in out] \
        == [(s.client_id, s.type, s.content) for s in sigs]
    fbody = bw.encode_presence(sigs, topic="t/d")
    topic, stripped = bw.fpresence_strip_topic(fbody)
    assert topic == "t/d"
    assert stripped == body
    out2 = bw.decode_presence(fbody)
    assert [s.content for s in out2] == [s.content for s in sigs]
    return [body, fbody]


def test_binwire_presence_roundtrip_and_topic_splice():
    _both(_codec)


def _readonly_no_join(pkg):
    server = module(pkg, "service").LocalServer(clock=lambda: 0.0)
    server._client_epoch = "e0"
    w = server.connect("t", "d", None)
    seen = []
    w.on_op = seen.append
    r = server.connect("t", "d", None, readonly=True)
    assert r.mode == "readonly"
    w2 = server.connect("t", "d", None)
    assert wait_for(lambda: any(
        m.type == "join" and w2.client_id in str(m.contents)
        for m in seen))
    assert not any(r.client_id in str(m.contents) for m in seen)
    return [r.mode, r.client_id, [(m.sequence_number, m.type.value,
                                   m.client_id, m.contents) for m in seen]]


def test_readonly_connect_orders_no_join():
    _both(_readonly_no_join)


def test_readonly_network_session_reads_but_cannot_write():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        writer = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port)).resolve("t", "rdoc")
        s1 = writer.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s1.insert_text(0, "read scale")
        reader = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port, readonly=True)).resolve("t", "rdoc")
        assert wait_for(lambda: reader.runtime.get_data_store("default")
                        .get_channel("text").get_text() == "read scale")
        assert fe.counters.snapshot()["session.readonly.connects"] == 1
        assert reader.delta_manager.connection.mode == "readonly"
        with pytest.raises(PermissionError):
            reader.delta_manager.submit(MessageType.OPERATION, {"x": 1})
    finally:
        fe.stop()


def test_readonly_live_tail_and_presence_publish():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        writer = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port)).resolve("t", "taildoc")
        s1 = writer.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s1.insert_text(0, "a")
        reader = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port, readonly=True)).resolve("t", "taildoc")
        got = []
        writer.on_signal = lambda sig: got.append(sig)
        s1.insert_text(1, "b")
        assert wait_for(lambda: reader.runtime.get_data_store("default")
                        .get_channel("text").get_text() == "ab")
        reader.submit_signal({"cursor": 7}, type="cursor")
        assert wait_for(lambda: any(
            s.content == {"cursor": 7} and s.type == "cursor"
            for s in got))
    finally:
        fe.stop()


def test_signal_burst_coalesces_server_side():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", fe.port))
        c1 = loader.resolve("t", "sigdoc")
        c2 = loader.resolve("t", "sigdoc")
        got = []
        c2.on_signal = lambda sig: got.append(sig)
        for i in range(50):
            c1.submit_signal({"i": i}, type="cursor")
        assert wait_for(lambda: any(
            s.content == {"i": 49} for s in got if s.type == "cursor"))
        snap = fe.counters.snapshot()
        assert snap["presence.lane.coalesced"] > 0
        assert len([s for s in got if s.type == "cursor"]) < 50
        assert snap["presence.lane.flushes"] >= 1
    finally:
        fe.stop()


def test_presence_never_overtakes_sequenced_ops():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", fe.port))
        c1 = loader.resolve("t", "orderdoc")
        c2 = loader.resolve("t", "orderdoc")
        s1 = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        seen = []
        c2.on_signal = lambda sig, c2=c2: seen.append(
            c2.runtime.get_data_store("default")
            .get_channel("text").get_text()) if sig.type == "mark" else None
        for i in range(20):
            s1.insert_text(len(s1.get_text()), f"{i % 10}")
        c1.submit_signal({"done": True}, type="mark")
        assert wait_for(lambda: len(seen) >= 1)
        assert seen[0] == "01234567890123456789"
    finally:
        fe.stop()


# -------------------------------------------------------------- relay tree

def _spawn(args):
    proc = subprocess.Popen(
        [sys.executable, "-m"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING"), line
    return proc, int(line.rsplit(":", 1)[1])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


GATEWAY = "fluidframework_tpu_torch.service.gateway"


def _mid(core_port: int, port: int):
    return _spawn([GATEWAY, "--core-port", str(core_port),
                   "--port", str(port), "--python"])[0]


@pytest.fixture(scope="module")
def tree():
    """core ← mid gateway ← leaf gateway, processes of the port: yields
    a dict of the ports and the processes (the kill test swaps ``mid``)."""
    core, core_port = _spawn(
        ["fluidframework_tpu_torch.service.front_end", "--port", "0"])
    p_mid = _free_port()
    fleet = {"core": core, "core_port": core_port, "p_mid": p_mid,
             "mid": _mid(core_port, p_mid)}
    fleet["leaf"], fleet["p_leaf"] = _spawn(
        [GATEWAY, "--upstream-gateway", f"127.0.0.1:{p_mid}"])
    try:
        yield fleet
    finally:
        for name in ("leaf", "mid", "core"):
            fleet[name].terminate()
            fleet[name].wait(timeout=10)


def test_relay_tree_converges_both_ways(tree):
    c1 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["core_port"])).resolve("t", "treedoc")
    c2 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["p_leaf"])).resolve("t", "treedoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "root")
    assert wait_for(lambda: c2.runtime.get_data_store("default")
                    .get_channel("text").get_text() == "root")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(4, " leaf")
    assert wait_for(lambda: s1.get_text() == "root leaf"
                    and s2.get_text() == "root leaf")


def test_signals_traverse_the_tree(tree):
    c1 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["core_port"])).resolve("t", "treesig")
    c2 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["p_leaf"])).resolve("t", "treesig")
    got_down, got_up = [], []
    c2.on_signal = lambda sig: got_down.append(sig.content)
    c1.on_signal = lambda sig: got_up.append(sig.content)
    c1.submit_signal({"from": "root"})
    c2.submit_signal({"from": "leaf"})
    assert wait_for(lambda: {"from": "root"} in got_down)
    assert wait_for(lambda: {"from": "leaf"} in got_up)


def test_readonly_reader_through_the_tree(tree):
    c1 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["core_port"])).resolve("t", "treero")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "fan out")
    reader = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["p_leaf"], readonly=True)).resolve("t", "treero")
    assert wait_for(lambda: reader.runtime.get_data_store("default")
                    .get_channel("text").get_text() == "fan out")
    assert reader.delta_manager.connection.mode == "readonly"
    s1.insert_text(len(s1.get_text()), " live")
    assert wait_for(lambda: reader.runtime.get_data_store("default")
                    .get_channel("text").get_text() == "fan out live")


def test_midtier_gateway_kill_exact_once_delivery(tree):
    """Kill the mid tier under live traffic; every marker written before,
    during and after the outage appears at the leaf's reader exactly
    once."""
    n_ops = 60
    writer = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["core_port"])).resolve("t", "killdoc")
    s1 = writer.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    reader = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", tree["p_leaf"]), auto_reconnect=True).resolve(
        "t", "killdoc")

    def rtext():
        return (reader.runtime.get_data_store("default")
                .get_channel("text").get_text())

    def write(i):
        s1.insert_text(len(s1.get_text()), f"m{i:03d} ")

    for i in range(20):
        write(i)
    assert wait_for(lambda: rtext().count("m019 ") == 1)
    tree["mid"].kill()
    tree["mid"].wait(timeout=10)
    for i in range(20, 40):
        write(i)
    tree["mid"] = _mid(tree["core_port"], tree["p_mid"])
    for i in range(40, n_ops):
        write(i)
    assert wait_for(lambda: rtext().count(f"m{n_ops - 1:03d} ") == 1,
                    timeout=30.0)
    text = rtext()
    lost = [i for i in range(n_ops) if text.count(f"m{i:03d} ") != 1]
    assert not lost, f"lost-or-duplicated markers: {lost}"
