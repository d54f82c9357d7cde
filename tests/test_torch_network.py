"""The port's network tier against the JAX package's: the socket front end
(``service/front_end.py``) and the network driver (``driver/network.py``).

Twins of ``tests/test_network.py``'s flows, run against the port's
``NetworkFrontEnd(LocalServer()).start_background()`` with the port's
client stack, two tests with the front end in a separate process (one of
them the DDS catalog over the wire); then the
wire between the packages: a JAX client against the port's front end and
a port client against the JAX front end converge to the same texts, and
the same scripted edits into a JAX and a port front end leave equal
sequenced streams (client ids mapped by first appearance; timestamps and
trace hops are wall-clock and not compared). Every option of the front
end's ``main()`` builds a core, and the overload and health plane's
doors arm on it.
"""

from __future__ import annotations

import contextlib
import json
import random
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import stack

from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.driver.network import _Transport
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.service import NetworkFrontEnd
from fluidframework_tpu_torch.service.local_server import LocalServer

ROOT = Path(__file__).resolve().parent.parent


def wait_for(pred, timeout=10.0, interval=0.005):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if pred():
                return True
        except (KeyError, IndexError):
            pass
        time.sleep(interval)
    return False


@contextlib.contextmanager
def front_end_process():
    """The port's front end in a separate OS process; yields its port."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        yield int(line.rsplit(":", 1)[1])
    finally:
        proc.terminate()
        proc.wait(timeout=10)


@pytest.fixture
def front_end():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    yield fe
    fe.stop()


@pytest.fixture
def loader(front_end):
    return Loader(NetworkDocumentServiceFactory("127.0.0.1", front_end.port))


def _text(container, name="text"):
    return container.runtime.get_data_store("default").get_channel(
        name).get_text()


def test_two_clients_converge_over_sockets(loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "hello network")
    assert wait_for(lambda: _text(c2) == "hello network")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(5, " there")
    s1.remove_text(0, 1)
    assert wait_for(lambda: s1.get_text() == s2.get_text()
                    and len(s1.get_text()) == 18)
    assert s1.get_text() == "ello there network"


def test_late_joiner_backfills_over_network(loader):
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for i in range(10):
        s1.insert_text(len(s1.get_text()), f"{i}")
    assert wait_for(lambda: s1.get_text() == "0123456789")
    # late joiner must catch up through the delta-backfill endpoint
    c2 = loader.resolve("t", "doc")
    assert wait_for(lambda: _text(c2) == "0123456789")


def test_signals_relay_unsequenced(loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    got = []
    c1.on_signal = got.append
    c2.submit_signal({"cursor": 7})
    assert wait_for(lambda: len(got) == 1)
    assert got[0].content == {"cursor": 7}
    assert got[0].client_id == c2.client_id


def test_map_over_network(loader):
    """The twin of ``test_map_and_counter_over_network``: a map and a
    counter converge across two network clients."""
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    ds1 = c1.runtime.create_data_store("default")
    m1 = ds1.create_channel("kv", "shared-map")
    k1 = ds1.create_channel("n", "shared-counter")
    m1.set("key", {"nested": [1, 2]})
    k1.increment(5)
    assert wait_for(lambda: c2.runtime.get_data_store("default")
                    .get_channel("kv").get("key") == {"nested": [1, 2]})
    # the counter's ops are later: they may reach c2 in a later frame
    assert wait_for(lambda: "n" in c2.runtime.get_data_store("default")
                    .channels and c2.runtime.get_data_store("default")
                    .get_channel("n").value == 5)


def test_oversized_message_nacked_not_sequenced(front_end, loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "ok")
    assert wait_for(lambda: _text(c2) == "ok")
    nacks = []
    c1.on_nack = nacks.append
    s1.insert_text(0, "X" * (front_end.max_message_size + 1))
    assert wait_for(lambda: len(nacks) == 1)
    assert nacks[0].code == 413
    # the oversized op never reached the sequencer
    time.sleep(0.1)
    assert _text(c2) == "ok"


def test_summary_pipeline_over_network(loader):
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    c1 = loader.resolve("t", "doc")
    sm = SummaryManager(c1, max_ops=3)
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "abcdef")
    s.remove_text(0, 2)
    assert wait_for(lambda: sm.summaries_acked >= 1)
    # fresh client boots from the network-uploaded summary + tail
    c2 = loader.resolve("t", "doc")
    assert c2._base_snapshot is not None
    assert wait_for(lambda: _text(c2) == "cdef")


def test_reconnect_rebase_over_network(loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "base")
    assert wait_for(lambda: _text(c2) == "base")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    c1.disconnect()
    s1.insert_text(0, "X")  # offline edit
    s2.insert_text(4, "Y")  # concurrent remote edit
    assert wait_for(lambda: s2.get_text() == "baseY")
    c1.reconnect()
    assert wait_for(lambda: s1.get_text() == s2.get_text() == "XbaseY")


def test_cross_process_server():
    """The port's front end in a separate OS process (``python -m
    fluidframework_tpu_torch.service.front_end``), clients in this one."""
    with front_end_process() as port:
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c1 = loader.resolve("t", "xdoc")
        c2 = loader.resolve("t", "xdoc")
        s1 = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s1.insert_text(0, "cross process!")
        assert wait_for(lambda: _text(c2) == "cross process!")
        s2 = c2.runtime.get_data_store("default").get_channel("text")
        s2.annotate_range(0, 5, {"bold": True})
        s2.insert_text(0, ">> ")
        assert wait_for(lambda: s1.get_text() == s2.get_text()
                        == ">> cross process!")


def test_full_dds_catalog_over_the_wire():
    """The twin of the JAX test of the same name: matrix, directory,
    counter and consensus queue converge across two network clients
    against the port's front end in a process of its own."""
    with front_end_process() as port:
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c1 = loader.resolve("t", "catalog")
        c2 = loader.resolve("t", "catalog")
        ds1 = c1.runtime.create_data_store("default")

        matrix = ds1.create_channel("grid", "shared-matrix")
        matrix.insert_rows(0, 2)
        matrix.insert_cols(0, 2)
        matrix.set_cell(0, 0, "a")
        matrix.set_cell(1, 1, "d")

        directory = ds1.create_channel("dir", "shared-directory")
        directory.create_subdirectory("settings").set("theme", "dark")

        counter = ds1.create_channel("clicks", "shared-counter")
        counter.increment(5)

        queue = ds1.create_channel("work", "consensus-queue")
        queue.add({"job": 1})

        def synced():
            ds2 = c2.runtime.data_stores.get("default")
            return ds2 and all(
                ch in ds2.channels
                for ch in ("grid", "dir", "clicks", "work"))
        assert wait_for(synced)
        ds2 = c2.runtime.get_data_store("default")
        assert wait_for(lambda: ds2.get_channel("grid")
                        .get_cell(1, 1) == "d")
        assert ds2.get_channel("grid").get_cell(0, 0) == "a"
        assert wait_for(lambda: ds2.get_channel("dir")
                        .get_subdirectory("settings") is not None)
        assert ds2.get_channel("dir").get_subdirectory("settings") \
            .get("theme") == "dark"
        assert wait_for(lambda: ds2.get_channel("clicks").value == 5)
        ds2.get_channel("clicks").increment(-2)
        assert wait_for(lambda: ds1.get_channel("clicks").value == 3)

        # consensus queue: exactly-once across the wire
        q2 = ds2.get_channel("work")
        assert wait_for(lambda: len(q2) == 1)
        item = q2.acquire()
        assert item is not None
        q2.complete(item)
        assert wait_for(lambda: len(ds1.get_channel("work")) == 0)
        assert ds1.get_channel("grid").to_lists() == \
            ds2.get_channel("grid").to_lists() == [["a", None], [None, "d"]]


def test_json_and_binary_clients_interoperate(front_end):
    lb = Loader(NetworkDocumentServiceFactory("127.0.0.1", front_end.port,
                                              binary=True))
    lj = Loader(NetworkDocumentServiceFactory("127.0.0.1", front_end.port,
                                              binary=False))
    cb = lb.resolve("t", "mixdoc")
    cj = lj.resolve("t", "mixdoc")
    sb = cb.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    sb.insert_text(0, "from-binary")
    assert wait_for(lambda: _text(cj) == "from-binary")
    sj = cj.runtime.get_data_store("default").get_channel("text")
    sj.insert_text(0, "json:")
    assert wait_for(lambda: sb.get_text() == "json:from-binary"
                    and sj.get_text() == "json:from-binary")


def test_unpackable_message_falls_back_to_json_broadcast(front_end):
    from fluidframework_tpu_torch.protocol.messages import DocumentMessage

    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port,
                                            binary=True)
    conn = factory.create_document_service(
        "t", "odd").connect_to_delta_stream()
    got = []
    conn.on_op = got.append
    big_ref = 2 ** 40  # valid per protocol (>= msn), outside binwire i32
    conn.submit([DocumentMessage(
        client_sequence_number=1, reference_sequence_number=big_ref,
        type=MessageType.OPERATION, contents={"free": "form"})])
    assert wait_for(lambda: any(
        m.client_id == conn.client_id
        and m.reference_sequence_number == big_ref for m in got))
    conn.close()


def test_snapshot_cache_second_boot_issues_no_storage_rpcs(front_end):
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1 = loader.resolve("t", "cachedoc")
    sm = SummaryManager(c1, max_ops=10**9)
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "cache me")
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    sm.summarize_now()
    assert wait_for(lambda: sm.summaries_acked == 1)

    c2 = loader.resolve("t", "cachedoc")
    assert c2._base_snapshot is not None
    assert c2.storage.rpcs > 0
    assert wait_for(lambda: _text(c2) == "cache me")

    c3 = loader.resolve("t", "cachedoc")
    assert c3._base_snapshot is not None
    assert c3.storage.rpcs == 0, "cached boot issued storage RPCs"
    assert wait_for(lambda: _text(c3) == "cache me")

    s.insert_text(0, "fresh ")
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    sm.summarize_now()
    assert wait_for(lambda: sm.summaries_acked == 2)
    assert wait_for(
        lambda: factory.snapshot_cache.stats["invalidations"] >= 1)
    c4 = loader.resolve("t", "cachedoc")
    assert c4.storage.rpcs > 0  # refetched the newer version
    assert wait_for(lambda: _text(c4) == "fresh cache me")


def test_idle_connection_survives_recv_timeout_windows(front_end):
    loader = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", front_end.port, timeout=1.0))
    c1 = loader.resolve("t", "idledoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "x")
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    time.sleep(3.5)  # idle well past 2 recv-timeout windows
    c2 = Loader(NetworkDocumentServiceFactory(
        "127.0.0.1", front_end.port)).resolve("t", "idledoc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(1, "y")
    assert wait_for(lambda: s1.get_text() == "xy", timeout=20.0), \
        f"idle client missed the push: {s1.get_text()!r}"


def test_vanished_server_detected_by_ping_escalation():
    """A vanished peer sends no FIN and answers nothing: here a listener
    that accepts and then stays silent (the JAX twin SIGSTOPs a front-end
    process). Unanswered pings over consecutive idle windows end the
    reader and fire ``on_disconnect``."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    accepted = []
    threading.Thread(target=lambda: accepted.append(srv.accept()),
                     daemon=True).start()
    t = _Transport("127.0.0.1", srv.getsockname()[1], timeout=1.0)
    reasons = []
    t.on_disconnect = reasons.append
    try:
        assert wait_for(lambda: accepted, timeout=5.0)
        assert wait_for(lambda: reasons, timeout=15.0), \
            "vanished server never detected"
    finally:
        t.close()
        for conn, _ in accepted:
            conn.close()
        srv.close()


def test_close_wakes_requester_even_with_reader_parked():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    stop = threading.Event()

    def serve():
        conn, _ = srv.accept()
        need = int.from_bytes(conn.recv(4), "big")
        while need > 0:
            need -= len(conn.recv(need))
        body = json.dumps({"t": "stall"}).encode()
        conn.sendall(len(body).to_bytes(4, "big") + body)
        stop.wait(20.0)
        conn.close()

    threading.Thread(target=serve, daemon=True).start()
    t = _Transport("127.0.0.1", port, timeout=30.0)
    parked = threading.Event()
    t.on_push("stall", lambda frame: (parked.set(), stop.wait(20.0)))
    t.send({"t": "ready"})
    assert parked.wait(10.0), "reader never entered the stall handler"

    outcome = []

    def request():
        t0 = time.monotonic()
        try:
            t.request({"t": "admin_status"})
        except ConnectionError as e:
            outcome.append((time.monotonic() - t0, str(e)))

    requester = threading.Thread(target=request, daemon=True)
    requester.start()
    time.sleep(0.3)  # let it park on the cv
    t.close()
    requester.join(timeout=5.0)
    stop.set()
    srv.close()
    assert outcome, "requester still blocked after close()"
    elapsed, message = outcome[0]
    assert elapsed < 5.0, f"woke by timeout, not by close(): {elapsed}"
    assert "closed" in message


def test_admin_doors_answer_as_a_single_core(front_end, loader):
    """The status RPC reports the doc's pipeline (``applierSeq`` is None
    until an applier stage reports on a backchannel); the sharded core's
    doors answer as a single-pipeline core does."""
    c = loader.resolve("t", "adoc")
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "abc")
    assert wait_for(lambda: c.runtime.pending.count == 0)
    t = _Transport("127.0.0.1", front_end.port, timeout=10.0)
    try:
        status = t.request({"t": "admin_status", "tenant": "t",
                            "doc": "adoc"})["status"]
        assert status["seq"] == c.delta_manager.last_processed_seq
        assert status["applierSeq"] is None and len(status["clients"]) == 1
        assert t.request({"t": "admin_docs"})["docs"] == ["t/adoc"]
        assert t.request({"t": "admin_counters"})["counters"][
            "net.ingress.frames"] > 0
        assert t.request({"t": "admin_placement"})["placement"] is None
        assert t.request({"t": "admin_health"})["health"][
            "verdict"] == "unknown"
        with pytest.raises(RuntimeError, match="not a sharded core"):
            t.request({"t": "admin_migrate_doc", "tenant": "t",
                       "doc": "adoc", "target": "x"})
        # as in the JAX core: no open bootstrap of the tenant registry
        with pytest.raises(RuntimeError, match="require --admin-secret"):
            t.request({"t": "admin_tenant_add", "id": "x",
                       "tenant_secret": "s"})
    finally:
        t.close()


# ------------------------------------------------ between the packages


def _jax_net():
    from fluidframework_tpu.driver import (
        NetworkDocumentServiceFactory as JaxFactory,
    )
    from fluidframework_tpu.loader import Loader as JaxLoader
    from fluidframework_tpu.service import LocalServer as JaxServer
    from fluidframework_tpu.service import NetworkFrontEnd as JaxFrontEnd

    return JaxServer, JaxFrontEnd, JaxFactory, JaxLoader


@pytest.mark.parametrize("served_by", ["torch", "jax"])
def test_clients_of_both_packages_converge(served_by):
    """A JAX client over the JAX network driver and a port client over
    the port's, on one doc of one front end (the port's or the JAX
    package's): every edit reaches both, and the texts are equal."""
    JaxServer, JaxFrontEnd, JaxFactory, JaxLoader = _jax_net()
    fe = (NetworkFrontEnd(LocalServer()) if served_by == "torch"
          else JaxFrontEnd(JaxServer())).start_background()
    try:
        cj = JaxLoader(JaxFactory("127.0.0.1", fe.port)).resolve("t", "x")
        ct = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port)).resolve("t", "x")
        sj = cj.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        sj.insert_text(0, "from jax")
        assert wait_for(lambda: _text(ct) == "from jax")
        st = ct.runtime.get_data_store("default").get_channel("text")
        st.insert_text(0, "torch+")
        sj.remove_text(len(sj.get_text()) - 3, len(sj.get_text()))
        sj.annotate_range(0, 2, {"bold": True})
        # the annotate leaves the text alone: wait for both streams' ends
        assert wait_for(lambda: sj.get_text() == st.get_text()
                        == "torch+from "
                        and cj.runtime.pending.count == 0
                        and ct.runtime.pending.count == 0
                        and cj.delta_manager.last_processed_seq
                        == ct.delta_manager.last_processed_seq)
    finally:
        fe.stop()


#: the scripted docs: (doc, lane, submits, ops a submit) — the binary
#: wire one op at a time and three at a time, and the JSON wire
SCRIPT = (("bin", "binary", 12, 1), ("box", "binary", 4, 3),
          ("json", "json", 8, 1))


def _scripted(pkg: str) -> dict:
    """One client a doc submits the script into a front end of ``pkg``,
    waiting on each ack; returns each doc's sequenced stream, normalized."""
    if pkg == "torch":
        from fluidframework_tpu_torch.service.synthetic import (
            SyntheticEditor,
        )
        Factory, FrontEnd = NetworkDocumentServiceFactory, NetworkFrontEnd
    else:
        from fluidframework_tpu.service.synthetic import SyntheticEditor
        _, FrontEnd, Factory, _ = _jax_net()
    server = stack(pkg).server()
    fe = FrontEnd(server).start_background()
    streams = {}
    try:
        for doc, lane, n, per in SCRIPT:
            conn = Factory("127.0.0.1", fe.port,
                           binary=lane != "json").create_document_service(
                "t", doc).connect_to_delta_stream()
            editor = SyntheticEditor(random.Random(doc))
            acked = []

            def on_op(msg, me=conn.client_id, editor=editor, acked=acked):
                if msg.client_id == me:
                    editor.ref_seq = msg.sequence_number
                    acked.append(msg.sequence_number)
                else:
                    editor.observe(msg)
            conn.on_op = on_op
            for i in range(n):
                want = len(acked) + per
                with conn.lock:
                    conn.submit([editor.next_op() for _ in range(per)])
                assert wait_for(lambda: len(acked) >= want), (pkg, doc, i)
            conn.close()
        assert wait_for(lambda: all(
            server.log.length(f"deltas/t/{d}") > 0 for d, *_ in SCRIPT))
        time.sleep(0.2)  # the leaves
        for doc, *_ in SCRIPT:
            streams[doc] = _normalized(_stream(server.log, doc))
    finally:
        fe.stop()
    return streams


def _stream(log, doc: str) -> list:
    out = []
    topic = f"deltas/t/{doc}"
    for i in range(log.length(topic)):
        rec = log.read(topic, i)
        if "abatch" in rec:
            out += rec["abatch"].messages()
        elif "boxcar" in rec:
            out += rec["boxcar"]
        else:
            out.append(rec["message"])
    return out


def _normalized(msgs: list) -> list:
    """Each message's fields, client ids (also inside join/leave contents)
    replaced by their order of first appearance; no timestamps or
    trace hops."""
    ids: dict = {}

    def cid(c):
        return None if c is None else ids.setdefault(c, len(ids))

    out = []
    for m in msgs:
        contents = m.contents
        kind = str(m.type.value)
        if kind in (MessageType.CLIENT_JOIN.value,
                    MessageType.CLIENT_LEAVE.value):
            contents = dict(contents, clientId=cid(contents["clientId"]))
        out.append((cid(m.client_id), m.sequence_number,
                    m.minimum_sequence_number, m.client_sequence_number,
                    m.reference_sequence_number, kind,
                    json.dumps(contents, sort_keys=True, default=str)))
    return out


def test_scripted_streams_equal_jax():
    """The same scripted single-client edits, each waited on, into a JAX
    and a port front end (both on a clock stuck at 0 with a fixed client
    id epoch): every doc's sequenced stream is equal field for field."""
    port, jax = _scripted("torch"), _scripted("jax")
    for doc, _, n, per in SCRIPT:
        assert len(port[doc]) == len(jax[doc]) >= n * per + 1
        assert port[doc] == jax[doc], doc


# ------------------------------------------------ the front end's options


@pytest.mark.parametrize("flag,item", [
    # every flag of main() builds a core: the sharded core's flags (alone
    # or beside the storage tier's) a sharded one; the overload and
    # health plane's flags arm their planes on it
    (["--storage-server", "1", "--shard-dir", "x"], "sharded"),
    (["--external-scribe", "--shards", "2"], "single"),
    (["--storage-dir", "x", "--prefer", "0"], "single"),
    (["--tenant", "a:b"], "single"),
    (["--tenant-rate", "a:5"], "admission"),
    (["--slo", "ingest=submit_to_admit:25:5:2"], "slo"),
    (["--probe"], "health"), (["--shard-dir", "x"], "sharded"),
    (["--topology", "spec.json"], "sharded"), (["--rebalance"], "refused"),
    (["--shards", "2"], "single"), (["--prefer", "0"], "single"),
    (["--lease-ttl", "5"], "single"), (["--no-shed"], "single")])
def test_unported_front_end_options_raise(monkeypatch, tmp_path, flag,
                                          item):
    """Each flag of ``main()``: the sharded core's flags build a sharded
    core (``--rebalance`` without a shard dir is refused, as in the JAX
    package); ``--tenant-rate`` gives the tenant a budget and builds the
    admission gate, ``--slo`` a ticking SLO engine attached to it,
    ``--probe`` the health plane's config (armed once the core serves);
    ``--no-shed`` alone changes nothing; the others serve the single
    pipeline."""
    import gc

    from fluidframework_tpu_torch.obs import get_journal, reset_journal
    from fluidframework_tpu_torch.service import front_end
    from fluidframework_tpu_torch.service.topology import default_spec

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(gc, "disable", lambda: None)
    monkeypatch.setattr(gc, "freeze", lambda: None)
    default_spec(str(tmp_path / "fleet"), n_cores=1, n_partitions=2,
                 storage_dir=None).save("spec.json")
    served = []
    monkeypatch.setattr(front_end.NetworkFrontEnd, "serve_forever",
                        lambda self: served.append(self))
    monkeypatch.setattr(sys, "argv", ["front_end", "--port", "0", *flag])
    try:
        if item == "refused":
            with pytest.raises(SystemExit):
                front_end.main()
        else:
            front_end.main()
    finally:
        reset_journal()
        # a sharded core's journal keeps the registry its first emit
        # found: a later test's reset_registry would strand it
        get_journal()._registry = None
    if item == "refused":
        assert not served
        return
    (front,) = served
    assert (front.shard_host is not None) == (item == "sharded")
    if flag == ["--tenant", "a:b"]:
        assert front.server.tenants.list_tenants() == ["a"]
    assert (front.admission is not None) == (item in ("admission", "slo"))
    if item == "admission":
        assert front._rate_for("a")[0] == 5.0
        # rates alone leave tenancy open (no secret registered)
        assert not front.server.tenants.enforcing
    if item == "slo":
        engine = front.slo_engine
        engine.stop()
        assert front.admission.engine is engine and front.admission.shedding
        assert [s.name for s in engine.specs] == ["ingest"]
    assert (front._health_cfg is not None) == (item == "health")
    assert front.prober is None and front.health_engine is None


def test_unported_front_end_planes_raise(tmp_path):
    """The overload and health plane's doors work: ``enable_admission``
    builds one gate reading the tenant registry, ``attach_slo`` arms it
    with an engine (or, ``shedding=False``, only observes),
    ``enable_health`` stores the prober's and engine's config; boot
    admission and the rebalancer are the JAX package's (the rebalancer
    needs a sharded core), and ``NetworkFrontEnd(shard_host=)`` serves
    the sharded core."""
    from fluidframework_tpu_torch.obs.slo import SloEngine, SloSpec
    from fluidframework_tpu_torch.service.admission import (
        AdmissionController,
    )
    from fluidframework_tpu_torch.service.front_end import ShardHost
    from fluidframework_tpu_torch.service.tenants import TenantManager

    tm = TenantManager()
    tm.set_rate("acme", 10.0, 20.0)
    fe = NetworkFrontEnd(LocalServer(tenants=tm))
    adm = fe.enable_admission()
    assert isinstance(adm, AdmissionController)
    assert fe.enable_admission() is adm
    assert fe._rate_for("acme") == tm.rate_for("acme")
    assert fe._rate_for("other") is None
    engine = SloEngine([SloSpec("x", "submit_to_admit", 1.0)])
    assert fe.attach_slo(engine, shedding=False) is fe
    assert fe.slo_engine is engine and adm.engine is engine
    assert adm.shedding is False
    assert fe.enable_health(probe_tick_s=0.5) is fe
    assert fe._health_cfg["probe_tick_s"] == 0.5
    assert fe.prober is None and fe.health_engine is None
    with pytest.raises(ValueError, match="requires a sharded core"):
        fe.enable_rebalancer()
    assert fe.enable_boot_admission() is fe
    assert fe.server.rehydrator is not None
    sharded = NetworkFrontEnd(shard_host=ShardHost(str(tmp_path), 2))
    assert sharded.enable_rebalancer()._rebalance_cfg["budget"] == 2
    assert sharded.migration_engine is not None


# ------------------------------------------------ the socket load


def test_run_network_acks_every_op(front_end):
    """``load_gen.run_network``: thread-per-connection clients through the
    network driver, 8 docs x 2 clients, every op acked, hop legs read
    back from the trace stamps."""
    from fluidframework_tpu_torch.service.load_gen import run_network

    stats = run_network(front_end.port, n_docs=8, clients_per_doc=2,
                        ops_per_client=12, rate_hz=200.0, seed=3)
    assert stats.ops_acked == stats.ops_submitted == 8 * 2 * 12
    assert len(stats.ack_latencies_ms) == stats.ops_acked
    assert {"submit_to_admit", "deli_to_fanout"} <= set(stats.hops)


def test_run_load_acks_every_op(front_end):
    """``load_async.run_load``: asyncio socket clients on the columnar
    submit lane, 8 docs x 2 clients x 3 boxcars of 4, every op acked, with
    the sampled hoptail read back."""
    import asyncio

    from fluidframework_tpu_torch.service.load_async import run_load

    r = asyncio.run(run_load("127.0.0.1", front_end.port, 8, 2, 3, 4,
                             50.0, 0, "al", trace_sample_n=1))
    assert r["acked"] == r["ops"] == 8 * 2 * 3 * 4
    assert not r["errors"] and r["shed"] == 0
    assert len(r["lat_ms"]) == 8 * 2 * 3
    assert "submit_to_admit" in r["hops"]
    assert front_end.counters.snapshot()["net.ingress.columnar"] == 8 * 2 * 3


def test_run_load_start_gate(front_end):
    """The start barrier: ``run_load`` asks its gate for the start instant
    after its clients have joined, submits nothing before that instant,
    and reports its window in wall-clock epochs."""
    import asyncio

    from fluidframework_tpu_torch.service.load_async import run_load

    def columnar():
        return front_end.counters.snapshot().get("net.ingress.columnar", 0)

    before, gate_at = columnar(), []

    async def gate():
        await asyncio.sleep(0.1)
        gate_at.append((columnar(), time.time() + 0.2))
        return gate_at[0][1]

    r = asyncio.run(run_load("127.0.0.1", front_end.port, 4, 2, 2, 4,
                             50.0, 0, "gate", start_gate=gate))
    assert gate_at[0][0] == before  # nothing submitted before the gate
    assert r["acked"] == r["ops"] == 4 * 2 * 2 * 4
    assert r["late_s"] == 0.0
    assert gate_at[0][1] <= r["started_at"] < r["ended_at"]
    assert columnar() == before + 4 * 2 * 2


def test_admin_spans_records_a_core_process(tmp_path):
    """``admin_spans``: on resets and starts a core process's span
    recorder with no profiler in it, off stops it and answers its totals:
    the ingress batches, the log flush that gates their acks and the held
    frames' egress, with ``server.submit`` and the pipeline's spans nested
    in the ingress."""
    import asyncio

    from fluidframework_tpu_torch.service.load_async import run_load

    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0", "--log-dir", str(tmp_path / "log")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        port = int(line.rsplit(":", 1)[1])
        t = _Transport("127.0.0.1", port, timeout=30.0)
        try:
            assert t.request({"t": "admin_spans", "on": True})[
                "spans"] is None
            r = asyncio.run(run_load("127.0.0.1", port, 4, 2, 3, 4, 50.0, 0,
                                     "sp"))
            assert r["acked"] == r["ops"] == 4 * 2 * 3 * 4
            snap = t.request({"t": "admin_spans", "on": False})["spans"]
        finally:
            t.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    spans = snap["spans"]
    for name in ("net.ingress", "log.flush", "net.egress", "server.submit",
                 "deli", "scriptorium", "scribe", "broadcaster"):
        assert spans[name]["calls"] > 0, name
    assert spans["server.submit"]["calls"] >= 4 * 2 * 3
    ingress = spans["net.ingress"]
    nested = sum(spans[n]["seconds"] for n in ("server.submit", "log.flush",
                                                "net.egress"))
    assert ingress["seconds"] - ingress["self_seconds"] >= 0.99 * nested


def test_core_spans_are_off_without_a_switch(tmp_path):
    """With no profiler and the recorder not started, a core over a
    durable log serves its load and its recorder keeps nothing."""
    import asyncio

    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.load_async import run_load
    from fluidframework_tpu_torch.utils import telemetry
    from fluidframework_tpu_torch.utils.telemetry import SPANS

    assert not telemetry.tracing()
    SPANS.reset()
    (tmp_path / "log").mkdir()
    fe = NetworkFrontEnd(LocalServer(
        log=DurableLog(str(tmp_path / "log")))).start_background()
    try:
        r = asyncio.run(run_load("127.0.0.1", fe.port, 2, 2, 2, 4, 50.0, 0,
                                 "off"))
        assert r["acked"] == r["ops"]
        assert fe.counters.snapshot()["net.flush.performed"] > 0
        snap = SPANS.snapshot()
        assert snap["spans"] == {} and snap["rows"] == 0
        telemetry.record(True)
        try:
            assert telemetry.tracing()
        finally:
            telemetry.record(False)
        assert not telemetry.tracing()
    finally:
        fe.stop()
        fe.server.log.close()
