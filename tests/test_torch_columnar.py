"""The port's columnar ingress (``protocol/binwire.py`` FT_COLS_*, the
``ArrayBoxcar`` the door builds, deli's bulk admission, the front end's
splice and fan-out) against ``tests/test_columnar.py``.

Each codec and deli test is the twin of the JAX test of the same name:
its seeded ops are built on each package and the JAX test's assertions
hold on both, and every frame (submit columns, the gateway's fsubmit
prepend, the stamped ops frame and its fops twin), the decoded and
scanned fields, and deli's sequenced stream and nacks are equal between
the packages byte for byte. The two socket tests run the JAX test's
assertions on the port's ``NetworkFrontEnd`` alone (in process, as the
JAX test runs its own): what reaches a socket is not fixed by a seed.
Tolerance: exact.

``rand_cols_ops`` is shared with ``test_torch_obs.py``.
"""

from __future__ import annotations

import json
import random
import socket
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import canonical, module

from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.protocol import binwire
from fluidframework_tpu_torch.protocol.messages import (
    DocumentMessage,
    MessageType,
)
from fluidframework_tpu_torch.service import LocalServer, NetworkFrontEnd

PKGS = ("jax", "torch")


def wait_for(pred, timeout=10.0, interval=0.005):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def _chanop(op):
    return {"kind": "chanop", "address": "default",
            "contents": {"address": "text", "contents": op}}


_POOL = ["a", "bc", "déf", "ghij", "héllo", "жopб", "x" * 40]


def rand_cols_ops(rng: random.Random, n: int, cseq0: int = 1,
                  pkg: str = "torch") -> list:
    """n random columnar-eligible ops on one channel, as ``pkg``'s
    ``DocumentMessage``s."""
    msgs = module(pkg, "protocol.messages")
    ops = []
    rseq = rng.randrange(100)
    for i in range(n):
        r = rng.random()
        if r < 0.5:
            op = {"type": 0, "pos": rng.randrange(10_000),
                  "text": rng.choice(_POOL)}
        elif r < 0.8:
            a = rng.randrange(10_000)
            op = {"type": 1, "start": a, "end": a + 1 + rng.randrange(40)}
        else:
            a = rng.randrange(10_000)
            op = {"type": 2, "start": a, "end": a + 2,
                  "props": {"k": rng.randrange(4), "s": rng.choice(_POOL)}}
        rseq += rng.randrange(3)
        ops.append(msgs.DocumentMessage(
            client_sequence_number=cseq0 + i,
            reference_sequence_number=rseq,
            type=msgs.MessageType.OPERATION, contents=_chanop(op)))
    return ops


def _both(scenario) -> None:
    shown = {pkg: scenario(pkg, module(pkg, "protocol.binwire"))
             for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _roundtrip(pkg, bw):
    rng = random.Random(21)
    frames = []
    for _ in range(50):
        ops = rand_cols_ops(rng, rng.randrange(1, 40), pkg=pkg)
        body = bw.encode_submit_columns(ops)
        assert body is not None
        assert bw.is_binary(body)
        sid, sc = bw.decode_submit_columns(body)
        assert sid is None
        assert bw.cols_to_ops(sc) == ops
        rec_frame = bw.encode_submit(ops)
        _, rec = bw.decode_submit(rec_frame)
        assert rec == ops
        frames.append([body, rec_frame, canonical(bw.cols_to_ops(sc))])
    return frames


def test_cols_roundtrip_equivalence_fuzz():
    _both(_roundtrip)


def _fsubmit(pkg, bw):
    ops = rand_cols_ops(random.Random(22), 12, pkg=pkg)
    plain = bw.encode_submit_columns(ops)
    direct = bw.encode_submit_columns(ops, sid=777)
    assert bw.submit_to_fsubmit(plain, 777) == direct
    sid, sc = bw.decode_submit_columns(direct)
    assert sid == 777
    assert bw.cols_to_ops(sc) == ops
    return [plain, direct]


def test_cols_fsubmit_relay_equivalence():
    _both(_fsubmit)


def _non_columnable(pkg, bw):
    msgs = module(pkg, "protocol.messages")
    ok = rand_cols_ops(random.Random(23), 3, pkg=pkg)
    assert bw.encode_submit_columns(ok) is not None

    def variant(mutate):
        ops = rand_cols_ops(random.Random(23), 3, pkg=pkg)
        mutate(ops)
        return bw.encode_submit_columns(ops)

    shown = [
        variant(lambda o: setattr(o[1], "metadata", {"batch": True})),
        variant(lambda o: o[1].traces.append(msgs.TraceHop(
            service="client", action="submit", timestamp=1.0))),
        variant(lambda o: setattr(o[1], "type", msgs.MessageType.NOOP)),
        variant(lambda o: setattr(o[1], "contents",
                                  {"kind": "attach", "blob": "x"})),
        variant(lambda o: o[1].contents["contents"].__setitem__(
            "address", "other")),
        variant(lambda o: o[1].contents["contents"]["contents"].update(
            {"type": 0, "pos": 1, "text": "t", "marker": True})),
        variant(lambda o: o[1].contents["contents"].__setitem__(
            "contents", {"type": 0, "pos": 2**31, "text": "t"})),
    ]
    assert shown == [None] * 7
    return [bw.encode_submit_columns(ok)]


def test_non_columnable_shapes_return_none():
    _both(_non_columnable)


def _stamp(pkg, bw):
    op_type = module(pkg, "protocol.messages").MessageType.OPERATION
    ops = rand_cols_ops(random.Random(24), 9, pkg=pkg)
    body = bw.encode_submit_columns(ops)
    _, sc = bw.decode_submit_columns(body)
    msns = list(range(92, 92 + 9))
    stamped = bw.stamp_cols_ops(sc.cols, "client-7", 100, msns, 1234.5)
    assert sc.cols in stamped
    topic, out = bw.decode_cols_ops(stamped)
    assert topic is None
    assert [m.contents for m in out] == [m.contents for m in ops]
    assert [m.sequence_number for m in out] == list(range(100, 109))
    assert [m.minimum_sequence_number for m in out] == msns
    assert all(m.client_id == "client-7" and m.timestamp == 1234.5
               and m.type is op_type for m in out)
    scanned = list(bw.scan_ops(stamped))
    for m, (cid, seq, cseq, deli_ts, delta) in zip(out, scanned):
        assert (cid, seq, cseq, deli_ts) == (
            "client-7", m.sequence_number, m.client_sequence_number, 1234.5)
        op = m.contents["contents"]["contents"]
        if op["type"] == 0:
            assert delta == len(op["text"])
        elif op["type"] == 1:
            assert delta == op["start"] - op["end"]
        else:
            assert delta == 0
    fops = bw.stamp_cols_ops(sc.cols, "client-7", 100, msns, 1234.5,
                             topic="op/t/doc")
    t, stripped = bw.fops_strip_topic(fops)
    assert t == "op/t/doc" and stripped == stamped
    return [stamped, fops, scanned, canonical(out)]


def test_stamp_is_verbatim_splice_and_decodes():
    _both(_stamp)


class _Capture:
    def __init__(self):
        self.sequenced = []
        self.nacks = []

    def send(self, msg):
        self.sequenced.append(msg)

    def send_batch(self, batch):
        if isinstance(batch, list):
            self.sequenced.extend(batch)
        else:
            self.sequenced.extend(batch.messages())

    def nack(self, client_id, nack):
        self.nacks.append((client_id, nack))


def _cols_boxcar(pkg, bw, ops):
    """An ArrayBoxcar exactly as the columnar ingress door builds it."""
    _, sc = bw.decode_submit_columns(bw.encode_submit_columns(ops))
    return module(pkg, "service.array_batch").ArrayBoxcar(
        tenant_id="t", document_id="d", client_id="",
        ds_id=sc.ds_id, channel_id=sc.channel_id, kind=sc.kind,
        a=sc.a, b=sc.b, cseq=sc.cseq, rseq=sc.rseq,
        text=sc.text, text_off=sc.text_off, props=sc.props,
        wire_cols=sc.cols)


def _bulk_misses(pkg, bw):
    msgs = module(pkg, "protocol.messages")
    deli_mod = module(pkg, "service.deli")
    queued = module(pkg, "service.core").QueuedMessage
    rng = random.Random(25)
    join = deli_mod.RawMessage("t", "d", None, msgs.DocumentMessage(
        -1, -1, msgs.MessageType.CLIENT_JOIN, {"clientId": "a"}), 1000.0)
    good = rand_cols_ops(rng, 4, cseq0=1, pkg=pkg)
    gap = rand_cols_ops(rng, 3, cseq0=9, pkg=pkg)
    ghost = rand_cols_ops(rng, 2, cseq0=1, pkg=pkg)

    def feed(cap, columnar: bool):
        deli = deli_mod.DeliLambda(
            "t", "d", send_sequenced=cap.send, send_nack=cap.nack,
            clock=lambda: 1000.0, send_sequenced_batch=cap.send_batch)
        records = [join]
        for cid, ops in (("a", good), ("a", gap), ("ghost", ghost)):
            if columnar:
                box = _cols_boxcar(pkg, bw, ops)
                box.client_id = cid
                box.timestamp = 1001.0
                records.append(box)
            else:
                records.extend(deli_mod.RawMessage("t", "d", cid, op, 1001.0)
                               for op in ops)
        for off, rec in enumerate(records):
            deli.handler(queued(off + 1, "raw", 0, rec))
        return deli

    cap_c, cap_s = _Capture(), _Capture()
    deli = feed(cap_c, columnar=True)
    feed(cap_s, columnar=False)
    assert deli.boxcars_fast == 1
    assert deli.boxcars_fallback == 2

    def key(m):
        return (m.client_id, m.sequence_number, m.minimum_sequence_number,
                m.client_sequence_number, m.reference_sequence_number,
                m.type.value, repr(m.contents))

    stream = [key(m) for m in cap_c.sequenced]
    assert stream == [key(m) for m in cap_s.sequenced]
    nacks = [(c, n.code, n.type.value, n.message) for c, n in cap_c.nacks]
    assert nacks == [(c, n.code, n.type.value, n.message)
                     for c, n in cap_s.nacks]
    assert cap_c.nacks
    return [stream, nacks]


def test_bulk_admission_misses_nack_like_scalar():
    _both(_bulk_misses)


@pytest.fixture
def front_end():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    yield fe
    fe.stop()


def test_oversize_nack_identical_through_either_door(front_end, monkeypatch):
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    big = DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=MessageType.OPERATION,
        contents=_chanop({"type": 0, "pos": 0, "text": "x" * 20_000}))

    def drive(doc):
        conn = factory.create_document_service(
            "t", doc).connect_to_delta_stream()
        nacks = []
        conn.on_nack = nacks.append
        conn.submit([big])
        assert wait_for(lambda: nacks)
        conn.close()
        return nacks[0]

    n_cols = drive("doc-cols")
    srv = front_end.counters.snapshot()
    assert srv.get("net.ingress.fallback", 0) >= 1
    monkeypatch.setattr(binwire, "encode_submit_columns",
                        lambda ops, sid=None: None)
    n_rec = drive("doc-rec")
    assert (n_cols.code, n_cols.type, n_cols.message) \
        == (n_rec.code, n_rec.type, n_rec.message)
    assert n_cols.code == 413
    assert n_cols.operation.client_sequence_number \
        == n_rec.operation.client_sequence_number == 1


def frame_json(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode()
    return len(body).to_bytes(4, "big") + body


def bin_client(port: int, doc: str):
    """A raw binwire subscriber of ``doc``: (socket, read one frame),
    past the JSON connect reply."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(frame_json({"t": "connect", "tenant": "t", "doc": doc,
                          "rid": 1, "bin": 1}))
    buf = [b""]

    def read_frame():
        while True:
            b = buf[0]
            if len(b) >= 4:
                n = int.from_bytes(b[:4], "big")
                if len(b) >= 4 + n:
                    buf[0] = b[4 + n:]
                    return b[4:4 + n]
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError("closed")
            buf[0] += chunk

    while binwire.is_binary(read_frame()):
        pass
    return s, read_frame


def next_cols(read):
    """The next columnar ops frame a subscriber reads."""
    while True:
        f = read()
        if binwire.is_binary(f) and f[1] in (binwire.FT_COLS_OPS,
                                             binwire.FT_COLS_FOPS):
            return f


def test_stamped_splice_reaches_subscribers_through_fanout(front_end):
    ops = rand_cols_ops(random.Random(26), 8)
    body = binwire.encode_submit_columns(ops)
    _, sc = binwire.decode_submit_columns(body)
    s1, read1 = bin_client(front_end.port, "doc")
    s2, read2 = bin_client(front_end.port, "doc")
    s1.sendall(binwire.frame(body))
    b1, b2 = next_cols(read1), next_cols(read2)
    assert b1 == b2
    assert sc.cols in b1
    _, msgs = binwire.decode_ops(b1)
    assert [m.contents for m in msgs] == [m.contents for m in ops]
    assert [m.client_sequence_number for m in msgs] \
        == [m.client_sequence_number for m in ops]
    assert [m.sequence_number for m in msgs] \
        == list(range(msgs[0].sequence_number,
                      msgs[0].sequence_number + len(ops)))
    snap = front_end.counters.snapshot
    assert wait_for(lambda: snap().get("net.ingress.columnar", 0) >= 1)
    assert wait_for(lambda: snap().get("net.fanout.cache_hits", 0) >= 1)
    s1.close()
    s2.close()
