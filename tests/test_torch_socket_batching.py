"""The port's socket-tier batching (the driver's coalescer,
``driver/network.py``; the front end's drain-batched serving, dirty-shard
flush and encode-once fan-out, ``service/front_end.py``; the durable
log's binary record path, ``service/durable_log.py``; the placement
leases' lock) against ``tests/test_socket_batching.py``.

Each test is the twin of the JAX test of the same name. What reaches a
socket, and when a lease goes stale, is not fixed by a seed: those tests
run the JAX test's assertions on the port alone, its front end in
process as in the JAX test. The durable log's binary record is fixed by
its input: its bytes, and the decoded record, are equal between the two
packages exactly. Tolerance: exact.
"""

from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import canonical, module

from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.protocol.messages import (
    DocumentMessage,
    MessageType,
)
from fluidframework_tpu_torch.protocol.serialization import message_to_dict
from fluidframework_tpu_torch.service import LocalServer, NetworkFrontEnd
from fluidframework_tpu_torch.service.durable_log import DurableLog


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


@pytest.fixture
def front_end():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    yield fe
    fe.stop()


def _op(cseq, contents, ref_seq=0):
    return DocumentMessage(
        client_sequence_number=cseq, reference_sequence_number=ref_seq,
        type=MessageType.OPERATION, contents=contents)


def _own_ops(seen, cid):
    return [m for m in seen
            if m.client_id == cid and m.type == MessageType.OPERATION]


def test_driver_coalescer_preserves_order_and_reduces_frames(front_end):
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    conn = factory.create_document_service(
        "t", "coal").connect_to_delta_stream()
    conn.coalesce_window = 0.002
    seen = []
    conn.on_op = seen.append
    n = 120
    for i in range(n):
        conn.submit([_op(i + 1, {"i": i})])
    assert wait_for(lambda: len(_own_ops(seen, conn.client_id)) >= n)
    mine = _own_ops(seen, conn.client_id)
    assert [m.client_sequence_number for m in mine] == list(range(1, n + 1))
    assert [m.contents["i"] for m in mine] == list(range(n))
    snap = factory.counters.snapshot()
    assert snap.get("driver.submit.coalesced", 0) > 0
    assert 0 < snap["driver.submit.frames"] < snap["driver.submit.ops"]
    conn.close()


def test_driver_close_drains_pending_coalesced_ops(front_end):
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    conn = factory.create_document_service(
        "t", "drain").connect_to_delta_stream()
    watcher = factory.create_document_service(
        "t", "drain").connect_to_delta_stream()
    seen = []
    watcher.on_op = seen.append
    conn.coalesce_window = 5.0
    conn.submit([_op(1, {"last": "words"})])
    cid = conn.client_id
    conn.close()
    assert wait_for(lambda: len(_own_ops(seen, cid)) >= 1)
    assert _own_ops(seen, cid)[0].contents == {"last": "words"}
    watcher.close()


def test_fanout_cache_never_serves_stale_frame_across_docs(front_end):
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    subs = {}
    seen = {}
    for doc in ("doc-a", "doc-b"):
        seen[doc] = []
        subs[doc] = [factory.create_document_service(
            "t", doc).connect_to_delta_stream() for _ in range(2)]
        for c in subs[doc]:
            c.on_op = seen[doc].append
    writers = {doc: subs[doc][0] for doc in subs}
    for i in range(5):
        for doc in ("doc-a", "doc-b"):
            writers[doc].submit([_op(i + 1, {"from": doc, "i": i})])

    def got_all():
        return all(len(_own_ops(seen[doc], writers[doc].client_id)) >= 10
                   for doc in subs)

    assert wait_for(got_all)
    for doc in subs:
        for m in seen[doc]:
            if m.type == MessageType.OPERATION:
                assert m.contents["from"] == doc, \
                    f"doc {doc} subscriber got a frame for " \
                    f"{m.contents['from']}: stale fan-out cache"
    assert front_end.counters.snapshot().get("net.fanout.cache_hits",
                                             0) > 0
    for doc in subs:
        for c in subs[doc]:
            c.close()


def test_drain_batch_flush_keeps_appends_visible_before_ack(tmp_path):
    log_dir = str(tmp_path / "log")
    front = NetworkFrontEnd(
        LocalServer(log=DurableLog(log_dir))).start_background()
    try:
        factory = NetworkDocumentServiceFactory("127.0.0.1", front.port)
        conn = factory.create_document_service(
            "t", "doc").connect_to_delta_stream()
        seen = []
        conn.on_op = seen.append
        ro = DurableLog(log_dir, readonly=True)
        base = ro.refresh_topic("deltas/t/doc")
        n = 3
        for i in range(n):
            conn.submit([_op(i + 1, {"i": i})])
        assert wait_for(lambda: len(_own_ops(seen, conn.client_id)) >= n)
        assert ro.refresh_topic("deltas/t/doc") >= base + n
        ro.close()
        conn.close()
    finally:
        front.stop()


def test_ping_only_batch_elides_the_flush(tmp_path):
    front = NetworkFrontEnd(
        LocalServer(log=DurableLog(str(tmp_path / "log"))))
    front.start_background()
    try:
        s = socket.create_connection(("127.0.0.1", front.port),
                                     timeout=10)
        _send(s, {"t": "ping"})
        assert _read_until(s, lambda f: f.get("t") == "pong")
        assert wait_for(
            lambda: front.counters.snapshot().get("net.flush.elided",
                                                  0) > 0)
        assert front.counters.snapshot().get("net.flush.performed",
                                             0) == 0
        s.close()
    finally:
        front.stop()


def _send(s, obj):
    body = json.dumps(obj, separators=(",", ":")).encode()
    s.sendall(len(body).to_bytes(4, "big") + body)


def _read_until(s, pred, timeout=10.0):
    s.settimeout(timeout)
    buf = b""
    hits = []
    while True:
        while len(buf) >= 4:
            n = int.from_bytes(buf[:4], "big")
            if len(buf) < 4 + n:
                break
            frame, buf = json.loads(buf[4:4 + n].decode()), buf[4 + n:]
            hits.append(frame)
            if pred(frame):
                return hits
        chunk = s.recv(65536)
        if not chunk:
            return None
        buf += chunk


def test_ingress_burst_is_coalesced_and_fully_acked(front_end):
    s = socket.create_connection(("127.0.0.1", front_end.port),
                                 timeout=10)
    _send(s, {"t": "connect", "tenant": "t", "doc": "burst", "rid": 1})
    hits = _read_until(s, lambda f: f.get("rid") == 1)
    cid = hits[-1]["clientId"]
    n = 12
    body = b""
    for i in range(n):
        m = json.dumps(
            {"t": "submit", "ops": [message_to_dict(_op(i + 1, {"i": i}))]},
            separators=(",", ":")).encode()
        body += len(m).to_bytes(4, "big") + m
    before = front_end.counters.snapshot().get("net.ingress.coalesced", 0)
    s.sendall(body)
    acked = []

    def saw_all(frame):
        if frame.get("t") == "ops":
            for m in frame["msgs"]:
                if m.get("client_id", m.get("clientId")) == cid:
                    acked.append(m)
        return len(acked) >= n

    assert _read_until(s, saw_all) is not None
    assert wait_for(
        lambda: front_end.counters.snapshot().get(
            "net.ingress.coalesced", 0) > before)
    s.close()


def test_admin_counters_rpc_exposes_batching_counters(front_end):
    s = socket.create_connection(("127.0.0.1", front_end.port),
                                 timeout=10)
    _send(s, {"t": "ping"})
    assert _read_until(s, lambda f: f.get("t") == "pong")
    _send(s, {"t": "admin_counters", "rid": 9})
    hits = _read_until(s, lambda f: f.get("rid") == 9)
    counters = hits[-1]["counters"]
    assert counters.get("net.ingress.frames", 0) > 0
    assert all(isinstance(v, int) for v in counters.values())
    s.close()


def _mini_batch(pkg):
    ab = module(pkg, "service.array_batch")
    box = ab.ArrayBoxcar(
        tenant_id="t", document_id="doc", client_id="c1",
        ds_id="default", channel_id="text",
        kind=np.zeros(1, np.int8),
        a=np.zeros(1, np.int32), b=np.zeros(1, np.int32),
        cseq=np.ones(1, np.int32), rseq=np.zeros(1, np.int32),
        text="hi", text_off=np.array([0, 2], np.int32),
        props=None, timestamp=1.0)
    return ab.SequencedArrayBatch(
        boxcar=box, base_seq=7, msns=np.array([3], np.int64),
        timestamp=1.0)


def test_durable_log_binary_path_requires_exact_record_shape():
    shown = {}
    for pkg in ("jax", "torch"):
        dl = module(pkg, "service.durable_log")
        batch = _mini_batch(pkg)
        exact = {"tenant_id": "t", "document_id": "doc", "abatch": batch}
        data = dl._encode_binary(exact)
        assert data is not None
        back = dl._decode_value(data)
        assert back["tenant_id"] == "t" and back["document_id"] == "doc"
        assert back["abatch"].base_seq == 7
        assert list(back["abatch"].msns) == [3]
        assert back["abatch"].boxcar.text == "hi"
        renamed = {"tenant": "t", "document_id": "doc", "abatch": batch}
        assert dl._encode_binary(renamed) is None
        extra = dict(exact, route="elsewhere")
        assert dl._encode_binary(extra) is None
        divergent = dict(exact, tenant_id="other")
        assert dl._encode_binary(divergent) is None
        shown[pkg] = [bytes(data), canonical(
            [m for m in back["abatch"].messages()])]
    assert shown["torch"] == shown["jax"]


def test_stalled_ex_owner_heartbeat_loses_to_takeover(tmp_path):
    from fluidframework_tpu_torch.service.placement import PlacementDir

    pd = PlacementDir(str(tmp_path / "pl"), 1, ttl_s=0.3)
    assert pd.try_claim(0, "A", "addr-a")
    time.sleep(0.4)
    assert pd.try_claim(0, "B", "addr-b")
    assert pd.heartbeat(0, "A") is False
    pd.release(0, "A")
    assert pd.owner_of(0) == "addr-b"
    assert pd.heartbeat(0, "B") is True


def test_heartbeat_and_takeover_interleave_under_the_same_lock(tmp_path):
    from fluidframework_tpu_torch.service import placement as pl

    pd = pl.PlacementDir(str(tmp_path / "pl"), 1, ttl_s=0.25)
    assert pd.try_claim(0, "A", "addr-a")
    time.sleep(0.3)
    in_read = threading.Event()
    real_read = pd._read

    def slow_read(k):
        rec = real_read(k)
        in_read.set()
        time.sleep(0.2)
        return rec

    results = {}

    def hb():
        pd._read = slow_read
        try:
            results["a_keeps"] = pd.heartbeat(0, "A")
        finally:
            pd._read = real_read

    t = threading.Thread(target=hb)
    t.start()
    assert in_read.wait(5.0)
    pd2 = pl.PlacementDir(str(tmp_path / "pl"), 1, ttl_s=0.25)
    results["b_wins"] = pd2.try_claim(0, "B", "addr-b")
    t.join(10.0)
    assert not t.is_alive()
    assert not (results["a_keeps"] and results["b_wins"])
    assert results["a_keeps"] or results["b_wins"]
    owner = pd._read(0)["owner"]
    assert owner == ("A" if results["a_keeps"] else "B")
