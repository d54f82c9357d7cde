"""The port's binary wire codec (``protocol/binwire.py``): the twin of
``tests/test_binwire.py`` (exact roundtrip against the canonical objects,
whether an op takes the packed chanop fast path or the generic JSON
fallback), plus the wire between the packages: the same seeded messages
encode to the same bytes in the JAX package and the port, each package
decodes the other's frames, and the FT_HISTORY commit frames of the
history doors are byte-equal over seeded commits."""

import dataclasses
import enum
import random
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.protocol import binwire as jax_binwire
from fluidframework_tpu.protocol import messages as jax_messages
from fluidframework_tpu_torch.protocol import binwire
from fluidframework_tpu_torch.protocol import messages as port_messages
from fluidframework_tpu_torch.protocol.messages import (
    MessageType,
    SequencedDocumentMessage,
    TraceHop,
)

_PORT = SimpleNamespace(**{n: getattr(port_messages, n) for n in (
    "DocumentMessage", "SequencedDocumentMessage", "MessageType",
    "TraceHop")})
_JAX = SimpleNamespace(**{n: getattr(jax_messages, n) for n in (
    "DocumentMessage", "SequencedDocumentMessage", "MessageType",
    "TraceHop")})


def _chanop(op):
    return {"kind": "chanop", "address": "default",
            "contents": {"address": "text", "contents": op}}


def _rand_doc_msg(rng: random.Random, cseq: int, M=None):
    M = M or _PORT
    r = rng.random()
    if r < 0.3:
        contents = _chanop({"type": 0, "pos": rng.randrange(1000),
                            "text": "abcd"[: 1 + rng.randrange(4)]})
    elif r < 0.5:
        a = rng.randrange(1000)
        contents = _chanop({"type": 1, "start": a, "end": a + 1 + rng.randrange(8)})
    elif r < 0.65:
        a = rng.randrange(1000)
        contents = _chanop({"type": 2, "start": a, "end": a + 2,
                            "props": {"k": rng.randrange(4)}})
    elif r < 0.8:
        # generic: non-chanop payload
        contents = {"kind": "attach", "blob": "x" * rng.randrange(20)}
    else:
        contents = None
    msg = M.DocumentMessage(
        client_sequence_number=cseq,
        reference_sequence_number=rng.randrange(500),
        type=M.MessageType.OPERATION if r < 0.9 else M.MessageType.NOOP,
        contents=contents,
        metadata={"batch": True} if rng.random() < 0.1 else None,
    )
    if rng.random() < 0.5:
        msg.traces.append(M.TraceHop(service="client", action="submit",
                                     timestamp=rng.random() * 1e9))
    return msg


def test_submit_roundtrip_fuzz():
    rng = random.Random(7)
    for trial in range(50):
        ops = [_rand_doc_msg(rng, i + 1) for i in range(rng.randrange(1, 40))]
        body = binwire.encode_submit(ops)
        assert binwire.is_binary(body)
        sid, out = binwire.decode_submit(body)
        assert sid is None
        assert out == ops


def test_fsubmit_roundtrip_and_rewrite():
    rng = random.Random(8)
    ops = [_rand_doc_msg(rng, i + 1) for i in range(10)]
    plain = binwire.encode_submit(ops)
    direct = binwire.encode_submit(ops, sid=1234)
    # the gateway's zero-decode rewrite produces the identical frame
    assert binwire.submit_to_fsubmit(plain, 1234) == direct
    sid, out = binwire.decode_submit(direct)
    assert sid == 1234
    assert out == ops


def _rand_seq_msg(rng: random.Random, seq: int, M=None):
    M = M or _PORT
    base = _rand_doc_msg(rng, rng.randrange(100), M)
    return M.SequencedDocumentMessage(
        client_id=None if rng.random() < 0.1 else f"client-{rng.randrange(4)}",
        sequence_number=seq,
        minimum_sequence_number=max(0, seq - rng.randrange(10)),
        client_sequence_number=base.client_sequence_number,
        reference_sequence_number=base.reference_sequence_number,
        type=base.type,
        contents=base.contents,
        metadata=base.metadata,
        origin="other-cluster" if rng.random() < 0.05 else None,
        timestamp=rng.random() * 1e9,
        traces=[M.TraceHop(service="deli", action="sequence",
                           timestamp=rng.random() * 1e9)],
    )


def test_ops_roundtrip_fuzz():
    rng = random.Random(9)
    for trial in range(50):
        msgs = [_rand_seq_msg(rng, s + 1)
                for s in range(rng.randrange(1, 40))]
        body = binwire.encode_ops(msgs)
        topic, out = binwire.decode_ops(body)
        assert topic is None
        assert out == msgs


def test_fops_roundtrip_and_strip():
    rng = random.Random(10)
    msgs = [_rand_seq_msg(rng, s + 1) for s in range(12)]
    body = binwire.encode_ops(msgs, topic="op/t/doc-1")
    topic, client_body = binwire.fops_strip_topic(body)
    assert topic == "op/t/doc-1"
    # the stripped body IS the direct-encoded ops frame
    assert client_body == binwire.encode_ops(msgs)
    t2, out = binwire.decode_ops(body)
    assert t2 == "op/t/doc-1"
    assert out == msgs


def test_sentinel_fields():
    """System messages carry -1 cseq/rseq and a None client id."""
    msg = SequencedDocumentMessage(
        client_id=None, sequence_number=5, minimum_sequence_number=3,
        client_sequence_number=-1, reference_sequence_number=-1,
        type=MessageType.CLIENT_JOIN, contents={"clientId": "c1"},
        timestamp=123.5)
    _, out = binwire.decode_ops(binwire.encode_ops([msg]))
    assert out == [msg]


def test_spliced_encode_equals_full_encode():
    """encode_ops_spliced (payload bytes reused from the submit frame)
    must decode to exactly what encode_ops produces for the deli
    fast-lane shape: contents objects shared with the submit decode."""
    rng = random.Random(11)
    for trial in range(20):
        ops = [_rand_doc_msg(rng, i + 1) for i in range(rng.randrange(1, 24))]
        for op in ops:
            if op.contents is None:  # splice keys by contents identity
                op.contents = {"x": 1}
        body = binwire.encode_submit(ops)
        _, decoded, spans, blob, npool = binwire.decode_submit(
            body, with_spans=True)
        msgs = [
            SequencedDocumentMessage(
                client_id="client-1", sequence_number=100 + i,
                minimum_sequence_number=90 + i,
                client_sequence_number=op.client_sequence_number,
                reference_sequence_number=op.reference_sequence_number,
                type=op.type, contents=op.contents, metadata=op.metadata,
                timestamp=12.5,
                traces=list(op.traces) + [TraceHop(
                    service="deli", action="sequence", timestamp=13.0)])
            for i, op in enumerate(decoded)
        ]
        spliced = binwire.encode_ops_spliced(msgs, spans, blob, npool)
        assert spliced is not None
        _, out = binwire.decode_ops(spliced)
        _, ref = binwire.decode_ops(binwire.encode_ops(msgs))
        assert out == ref == msgs
        # fops variant strips back to the identical ops body
        fops = binwire.encode_ops_spliced(msgs, spans, blob, npool,
                                          topic="t/doc")
        topic, stripped = binwire.fops_strip_topic(fops)
        assert topic == "t/doc"
        _, out2 = binwire.decode_ops(stripped)
        assert out2 == msgs
    # unknown contents → None (caller falls back)
    foreign = SequencedDocumentMessage(
        client_id="c", sequence_number=1, minimum_sequence_number=1,
        client_sequence_number=1, reference_sequence_number=0,
        type=MessageType.OPERATION, contents={"other": True}, timestamp=1.0)
    assert binwire.encode_ops_spliced([foreign], spans, blob, npool) is None


def test_scan_ops_matches_decode():
    """scan_ops must agree with the full decode on identity fields and
    visible-length deltas."""
    rng = random.Random(12)
    for trial in range(20):
        msgs = [_rand_seq_msg(rng, s + 1) for s in range(rng.randrange(1, 30))]
        body = binwire.encode_ops(msgs)
        scanned = list(binwire.scan_ops(body))
        assert len(scanned) == len(msgs)
        for m, (cid, seq, cseq, deli_ts, delta) in zip(msgs, scanned):
            assert cid == m.client_id
            assert seq == m.sequence_number
            assert cseq == m.client_sequence_number
            expect_deli = None
            for t in m.traces:
                if t.service == "deli":
                    expect_deli = t.timestamp
            assert deli_ts == expect_deli
            # only fast-path records carry a delta: the generic JSON
            # payload (non-OPERATION type, metadata, origin) scans as 0
            fast = (m.type is MessageType.OPERATION
                    and m.metadata is None and m.origin is None)
            env = m.contents if isinstance(m.contents, dict) else {}
            op = (env.get("contents") or {}).get("contents") \
                if fast and env.get("kind") == "chanop" else None
            if op and op.get("type") == 0:
                assert delta == len(op["text"].encode())
            elif op and op.get("type") == 1:
                assert delta == op["start"] - op["end"]
            else:
                assert delta == 0


# ------------------------------------------------ between the packages


def _fields(msg) -> tuple:
    """A message's fields, package-independent (enums by value, trace
    hops as tuples)."""
    out = []
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if f.name == "traces":
            v = [(t.service, t.action, t.timestamp) for t in v]
        elif isinstance(v, enum.Enum):
            v = v.value
        out.append((f.name, v))
    return tuple(out)


@pytest.mark.parametrize("seed", [7, 9, 11])
def test_encodings_equal_jax(seed):
    """Seeded submits, broadcasts and backbone broadcasts: the same bytes
    from both packages, and each package decodes the other's bodies to
    the same fields."""
    for trial in range(10):
        rp, rj = random.Random(seed * 100 + trial), \
            random.Random(seed * 100 + trial)
        n = rp.randrange(1, 30)
        rj.randrange(1, 30)
        ops_p = [_rand_doc_msg(rp, i + 1) for i in range(n)]
        ops_j = [_rand_doc_msg(rj, i + 1, _JAX) for i in range(n)]
        sub = binwire.encode_submit(ops_p, sid=trial or None)
        assert sub == jax_binwire.encode_submit(ops_j, sid=trial or None)
        assert [_fields(m) for m in jax_binwire.decode_submit(sub)[1]] == \
            [_fields(m) for m in ops_p]
        msgs_p = [_rand_seq_msg(rp, s + 1) for s in range(n)]
        msgs_j = [_rand_seq_msg(rj, s + 1, _JAX) for s in range(n)]
        for topic in (None, "t/doc"):
            body = binwire.encode_ops(msgs_p, topic=topic)
            assert body == jax_binwire.encode_ops(msgs_j, topic=topic)
            t2, out = binwire.decode_ops(
                jax_binwire.encode_ops(msgs_j, topic=topic))
            assert t2 == topic and out == msgs_p


def _rand_commit(rng: random.Random, i: int) -> dict:
    commit = {"id": f"c{i}-{rng.randrange(1 << 30):x}",
              "version": f"v{rng.randrange(1 << 20)}",
              "base_seq": rng.randrange(1 << 20),
              "ts": rng.random() * 1e9,
              "parents": [f"c{rng.randrange(i + 1)}"
                          for _ in range(rng.randrange(3))],
              "chunk_ids": [f"{rng.randrange(1 << 62):016x}"
                            for _ in range(rng.randrange(6))]}
    if rng.random() < 0.5:
        commit["extra"] = {"fork_of": f"d{rng.randrange(9)}",
                           "at": rng.randrange(100)}
    return commit


@pytest.mark.parametrize("seed", [0, 1])
def test_history_frames_equal_jax(seed):
    """FT_HISTORY: a commit and its rid encode to the same bytes in both
    packages, and decode back to the same (rid, commit) on either side;
    a torn body raises in both."""
    rng = random.Random(seed)
    for i in range(40):
        commit = _rand_commit(rng, i)
        rid = rng.randrange(1 << 32)
        body = binwire.encode_history_commit(rid, commit)
        assert body == jax_binwire.encode_history_commit(rid, commit)
        assert body[1] == binwire.FT_HISTORY == jax_binwire.FT_HISTORY
        got = binwire.decode_history_commit(body)
        assert got == jax_binwire.decode_history_commit(body)
        assert got[0] == rid
        assert {k: got[1].get(k) for k in ("id", "version", "base_seq",
                                            "parents", "chunk_ids")} == \
            {k: commit.get(k) for k in ("id", "version", "base_seq",
                                         "parents", "chunk_ids")}
        for decode in (binwire.decode_history_commit,
                       jax_binwire.decode_history_commit):
            with pytest.raises(ValueError):
                decode(body[:-3])
