"""The port's durable log: the native op log, the segment store,
``DurableLog``, and directories shared with the JAX package.

Twins of ``tests/test_native.py``'s op-log tests and of the
``DurableLog`` tests of ``tests/test_segment_store.py`` that need no
network or Loader, run against the port's own build of
``csrc/oplog.cpp``. Then the two packages read each other's directories:
every record of a directory written by one package reads back equal in
the other (``abatch`` columns and every message field), streams written by
the two packages on the same seed agree (client ids mapped by first
appearance), and a port ``LocalServer`` reopened over its directory
resumes with the same deltas.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import random

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.durable_log import DurableLog as JaxLog
from fluidframework_tpu.service.load_gen import run_inproc as jax_run_inproc
from fluidframework_tpu_torch.native import NativeOpLog
from fluidframework_tpu_torch.protocol import binwire
from fluidframework_tpu_torch.protocol.messages import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
    TraceHop,
)
from fluidframework_tpu_torch.protocol.serialization import (
    decode_message,
    encode_message,
)
from fluidframework_tpu_torch.service.array_batch import (
    ArrayBoxcar,
    SequencedArrayBatch,
)
from fluidframework_tpu_torch.service.deli import RawMessage
from fluidframework_tpu_torch.service.durable_log import (
    DurableLog,
    _decode_value,
    _desanitize,
    _encode_value,
    _sanitize,
)
from fluidframework_tpu_torch.service.load_gen import run_inproc
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.log_compat import (
    _TAG_ESC,
    _TAG_MSG,
    decode_json_value,
    encode_json_value,
)
from fluidframework_tpu_torch.service.segment_store import SegmentReader
from tests.test_torch_service import _normalized


def _boxcar(n=3, tenant="t0", doc="d0", client="c1", ts=12.5):
    text = "ab" * n
    text_off = np.arange(0, 2 * n + 2, 2, dtype=np.int32)[: n + 1]
    return ArrayBoxcar(
        tenant_id=tenant, document_id=doc, client_id=client,
        ds_id="root", channel_id="seq", kind=np.zeros(n, np.int8),
        a=np.arange(n, dtype=np.int32), b=np.zeros(n, np.int32),
        cseq=np.arange(1, n + 1, dtype=np.int32),
        rseq=np.zeros(n, np.int32),
        text=text, text_off=text_off, props=None, timestamp=ts)


def _abatch_record(base_seq, n=3, tenant="t0", doc="d0", ts=100.0):
    box = _boxcar(n, tenant=tenant, doc=doc)
    return {"tenant_id": tenant, "document_id": doc,
            "abatch": SequencedArrayBatch(
                boxcar=box, base_seq=base_seq,
                msns=np.arange(base_seq, base_seq + n, dtype=np.int64),
                timestamp=ts)}


def _storage_snap(log):
    return {k: v for k, v in log.counters.snapshot().items()
            if k.startswith("storage.")}


def _delta(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


# ----------------------------------------------------------- the op log

def test_oplog_append_read_roundtrip(tmp_path):
    oplog = NativeOpLog(str(tmp_path / "log"))
    assert oplog.append("t1", b"hello") == 0
    assert oplog.append("t1", b"") == 1
    assert oplog.append("t1", b"x" * 10_000) == 2
    assert oplog.append("t2", b"other") == 0
    assert oplog.length("t1") == 3
    assert oplog.read("t1", 0) == b"hello"
    assert oplog.read("t1", 1) == b""
    assert oplog.read("t1", 2) == b"x" * 10_000
    assert oplog.read("t2", 0) == b"other"
    with pytest.raises(IndexError):
        oplog.read("t1", 3)
    oplog.close()


def test_oplog_survives_reopen(tmp_path):
    path = str(tmp_path / "log")
    log = NativeOpLog(path)
    for i in range(50):
        log.append("ops", f"record-{i}".encode())
    log.sync()
    log.close()
    log2 = NativeOpLog(path)
    assert log2.length("ops") == 50
    assert log2.read("ops", 17) == b"record-17"
    assert log2.append("ops", b"after-restart") == 50
    log2.close()


def test_oplog_truncates_torn_record_durably(tmp_path):
    path = tmp_path / "log"
    log = NativeOpLog(str(path))
    log.append("t", b"AAAA")
    log.append("t", b"BBBB")
    log.sync()
    log.close()
    # a crash mid-append: index entry present, data truncated
    with open(path / "t.idx", "ab") as f:
        f.write((4 + 4 + 4).to_bytes(8, "little"))
    with open(path / "t.data", "ab") as f:
        f.write((4).to_bytes(4, "little") + b"CC")  # 2 of 4 bytes
    log1 = NativeOpLog(str(path))
    assert log1.length("t") == 2
    assert log1.append("t", b"CCCC") == 2
    log1.sync()
    log1.close()
    # the truncation was durable: no stale entry resurrects
    log2 = NativeOpLog(str(path))
    assert log2.length("t") == 3
    assert log2.read("t", 2) == b"CCCC"
    log2.close()


def test_oplog_truncates_torn_partial_index_entry(tmp_path):
    path = tmp_path / "log"
    log = NativeOpLog(str(path))
    log.append("t", b"AAAA")
    log.append("t", b"BBBB")
    log.sync()
    log.close()
    with open(path / "t.idx", "ab") as f:
        f.write(b"\x10\x00\x00")  # 3 bytes of a new index entry
    log1 = NativeOpLog(str(path))
    assert log1.length("t") == 2
    assert log1.append("t", b"CCCC") == 2
    log1.sync()
    log1.close()
    log2 = NativeOpLog(str(path))
    assert [log2.read("t", i) for i in range(3)] == [b"AAAA", b"BBBB",
                                                    b"CCCC"]
    log2.close()


def test_oplog_fd_cap_bounds_open_files(tmp_path):
    path = str(tmp_path / "log")
    log = NativeOpLog(path)
    log.fd_cap(20)
    for i in range(100):
        log.append(f"topic-{i}", f"first-{i}".encode())
    assert 0 < log.open_files() <= 20
    for i in range(100):
        log.append(f"topic-{i}", f"second-{i}".encode())
    assert log.open_files() <= 20
    log.sync()
    for i in range(0, 100, 7):
        assert log.read(f"topic-{i}", 0) == f"first-{i}".encode()
        assert log.read(f"topic-{i}", 1) == f"second-{i}".encode()
    assert log.open_files() <= 20
    log.close()
    log2 = NativeOpLog(path)
    for i in range(100):
        assert log2.length(f"topic-{i}") == 2
        assert log2.read(f"topic-{i}", 1) == f"second-{i}".encode()
    log2.close()


def test_oplog_fd_cap_bounds_segment_streams(tmp_path):
    path = str(tmp_path / "log")
    log = NativeOpLog(path)
    log.fd_cap(16)
    for i in range(40):
        log.seg_append(f"stream-{i}", 1, 2, f"blk-a-{i}".encode(), 0)
    assert log.open_files() <= 16
    for i in range(40):
        log.seg_append(f"stream-{i}", 3, 4, f"blk-b-{i}".encode(), 0)
    log.sync()
    for i in range(0, 40, 5):
        assert log.seg_count(f"stream-{i}") == 2
        assert log.seg_read(f"stream-{i}", 0) == f"blk-a-{i}".encode()
        assert log.seg_read(f"stream-{i}", 1) == f"blk-b-{i}".encode()
    assert log.open_files() <= 16
    log.close()
    log2 = NativeOpLog(path)
    for i in range(40):
        assert log2.seg_count(f"stream-{i}") == 2
        assert log2.seg_read(f"stream-{i}", 1) == f"blk-b-{i}".encode()
    log2.close()


def test_durable_log_escapes_colliding_user_payloads(tmp_path):
    log = DurableLog(str(tmp_path / "log"))
    tricky = {"contents": {"_msg": {"user": "data"}, "_esc": 1,
                           "n": [1, {"_msg": 2}]}}
    log.append("t", tricky)
    assert log.read("t", 0) == tricky
    log.close()


def test_message_serialization_roundtrip():
    seq = SequencedDocumentMessage(
        client_id="c1", sequence_number=7, minimum_sequence_number=3,
        client_sequence_number=2, reference_sequence_number=5,
        type=MessageType.OPERATION, contents={"kind": "chanop", "x": [1, 2]},
        traces=[TraceHop(service="deli", action="sequence", timestamp=1.5)])
    assert decode_message(encode_message(seq)) == seq
    raw = RawMessage(
        tenant_id="t", document_id="d", client_id="c1",
        operation=DocumentMessage(
            client_sequence_number=1, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={"op": "set"}),
        timestamp=2.0)
    assert decode_message(encode_message(raw)) == raw
    batch = _abatch_record(5)["abatch"]
    back = decode_message(encode_message(batch))
    assert back.base_seq == 5 and back.messages() == batch.messages()


# ------------------------------------------------------- segment streams

def test_native_seg_roundtrip_rolls_and_reopen(tmp_path):
    d = str(tmp_path)
    log = NativeOpLog(d)
    log.seg_config(256)
    blocks = []
    seq = 1
    for i in range(12):
        payload = bytes([i]) * (60 + i)
        blocks.append((seq, seq + 2, payload))
        assert log.seg_append("s", seq, seq + 2, payload, 1) == i
        seq += 3
    assert log.seg_count("s") == 12
    segs = [f for f in os.listdir(d) if f.startswith("s.seg")
            and not f.endswith(".segidx")]
    assert len(segs) > 1
    for i, (first, last, payload) in enumerate(blocks):
        assert log.seg_read("s", i) == payload
        e_first, e_last, _seg, _off, e_len, e_btype = log.seg_entry("s", i)
        assert (e_first, e_last, e_len, e_btype) == (
            first, last, len(payload), 1)
    log.close()
    log2 = NativeOpLog(d)
    assert log2.seg_count("s") == 12
    assert log2.seg_read("s", 7) == blocks[7][2]
    log2.close()


@pytest.mark.parametrize("mode", [0, 1])
def test_native_torn_tail_truncated_on_reopen(tmp_path, mode):
    d = str(tmp_path)
    log = NativeOpLog(d)
    good = [b"alpha" * 10, b"bravo" * 10]
    for i, p in enumerate(good):
        log.seg_append("s", 10 * i + 1, 10 * i + 5, p, 1)
    log.seg_tear("s", 21, 25, b"torn-victim" * 8, 1, mode=mode)
    log.close()
    log2 = NativeOpLog(d)
    assert log2.seg_count("s") == 2
    assert [log2.seg_read("s", i) for i in range(2)] == good
    assert log2.seg_append("s", 21, 25, b"survivor", 1) == 2
    assert log2.seg_read("s", 2) == b"survivor"
    log2.close()


def test_segment_reader_never_admits_torn_tail(tmp_path):
    d = str(tmp_path)
    log = NativeOpLog(d)
    log.seg_append("s", 1, 3, b"first", 1)
    reader = SegmentReader(d, "s", flush=log.flush)
    assert reader.refresh() == 1
    log.seg_tear("s", 4, 6, b"ragged" * 4, 1, mode=1)
    log.flush()
    assert reader.refresh() == 1
    assert reader.block(0)[3] == b"first"
    with pytest.raises(IndexError):
        reader.block(1)
    log.seg_append("s", 4, 6, b"clean", 1)
    assert reader.refresh() == 2
    assert reader.block(1) == (1, 4, 6, b"clean")
    reader.close()
    log.close()


def test_range_blocks_sound_under_replay_span_regression(tmp_path):
    d = str(tmp_path)
    log = NativeOpLog(d)
    spans = [(1, 3), (4, 6), (7, 9), (4, 6), (10, 12)]  # [3] is a replay
    for i, (first, last) in enumerate(spans):
        log.seg_append("s", first, last, b"%d" % i, 1)
    reader = SegmentReader(d, "s", flush=log.flush)
    reader.refresh()
    rng = random.Random(5)
    for _ in range(200):
        a, b = rng.randrange(-1, 14), rng.randrange(-1, 15)
        want = [i for i, (f, last) in enumerate(spans)
                if last > a and f < b]
        assert reader.range_blocks(a, b) == want, (a, b)
    assert reader.range_blocks(3, 10) == [1, 2, 3]
    reader.close()
    log.close()


def test_sanitize_roundtrip_fuzz():
    rng = random.Random(11)
    for _ in range(500):
        topic = "".join(rng.choice("ab_.d/-0")
                        for _ in range(rng.randrange(1, 16)))
        san = _sanitize(topic)
        assert "/" not in san and _desanitize(san) == topic


def test_kind3_raw_boxcar_record_roundtrip():
    box = _boxcar()
    data = _encode_value(box)
    assert data[0] == 0xFF and data[1] == 3
    out = _decode_value(data)
    assert (out.tenant_id, out.document_id, out.client_id) == (
        "t0", "d0", "c1")
    assert out.text == box.text and np.array_equal(out.a, box.a)
    assert out.wire_cols is not None


def test_durable_log_segment_roundtrip_and_recovery_replay(tmp_path):
    d = str(tmp_path)
    topic = "deltas/t0/d0"
    log = DurableLog(d, segment_bytes=2048)
    before = _storage_snap(log)
    for i in range(20):
        log.append(topic, _abatch_record(1 + 3 * i, n=3, ts=100.0 + i))
    after = _storage_snap(log)
    assert _delta(before, after, "storage.segment.appends") == 20
    assert _delta(before, after, "storage.log.legacy_json") == 0
    assert os.path.exists(os.path.join(d, _sanitize(topic) + ".segidx"))
    log._read_cache.clear()
    v = log.read(topic, 5)
    assert [m.sequence_number for m in v["abatch"].messages()] == \
        [16, 17, 18]
    log.close()
    log2 = DurableLog(d)
    before = _storage_snap(log2)
    assert log2.length(topic) == 20
    assert [log2.read(topic, i)["abatch"].base_seq for i in range(20)] == \
        list(range(1, 60, 3))
    after = _storage_snap(log2)
    assert _delta(before, after, "storage.segment.decodes") == 20
    log2.close()


def test_record_format_directory_stays_record_lane(tmp_path):
    d = str(tmp_path)
    topic = "deltas/t0/d0"
    old = DurableLog(d, segmented=False)
    old.append(topic, _abatch_record(1))
    old.close()
    log = DurableLog(d)
    before = _storage_snap(log)
    assert log.length(topic) == 1
    log.append(topic, _abatch_record(4))
    assert not any(f.endswith(".segidx") for f in os.listdir(d))
    assert log.length(topic) == 2
    log._read_cache.clear()
    assert log.read(topic, 1)["abatch"].base_seq == 4
    after = _storage_snap(log)
    assert _delta(before, after, "storage.segment.appends") == 0
    assert log.delta_blocks(topic, 0, 100) is None
    log.close()


def test_legacy_json_counter_scoping(tmp_path):
    log = DurableLog(str(tmp_path))
    before = _storage_snap(log)
    log.append("rawops/t0/d0", _boxcar())
    log.append("checkpoints/t0/d0", {"deli": {}})
    after = _storage_snap(log)
    assert _delta(before, after, "storage.log.legacy_json") == 0
    log.append("deltas/t0/d0", {"weird": "record"})
    after2 = _storage_snap(log)
    assert _delta(after, after2, "storage.log.legacy_json") == 1
    log._read_cache.clear()
    assert log.read("deltas/t0/d0", 0) == {"weird": "record"}
    assert _delta(after2, _storage_snap(log), "storage.log.legacy_json") == 1
    log.close()


def test_torn_append_on_segment_lane_record_survives(tmp_path):
    d = str(tmp_path)
    topic = "deltas/t0/d0"
    log = DurableLog(d)
    pending = ["torn", "torn"]

    def plane(point, **ctx):
        if point == "log.append" and ctx["topic"] == topic and pending:
            return pending.pop()
        return None

    log.fault_plane = plane
    before = _storage_snap(log)
    for i in range(4):
        log.append(topic, _abatch_record(1 + 3 * i))
    after = _storage_snap(log)
    assert _delta(before, after, "storage.segment.torn") == 2
    assert _delta(before, after, "storage.segment.appends") == 4
    log.close()
    log2 = DurableLog(d)
    assert [log2.read(topic, i)["abatch"].base_seq for i in range(4)] \
        == [1, 4, 7, 10]
    log2.close()


def test_delta_blocks_zero_decode_byte_range_backfill(tmp_path):
    topic = "deltas/t0/d0"
    log = DurableLog(str(tmp_path))
    for i in range(50):
        log.append(topic, _abatch_record(1 + 3 * i, n=3))
    before = _storage_snap(log)
    payloads, legacy = log.delta_blocks(topic, 10, 40)
    assert legacy == []
    after = _storage_snap(log)
    assert _delta(before, after, "storage.segment.decodes") == 0
    assert _delta(before, after, "storage.backfill.byterange") == \
        len(payloads)
    seqs = []
    for p in payloads:
        _rid, msgs = binwire.read_cols_deltas(binwire.cols_deltas_body(7, p))
        seqs.extend(m.sequence_number for m in msgs)
    assert [s for s in sorted(seqs) if 10 < s < 40] == list(range(11, 40))
    assert min(seqs) > 10 - 3 and max(seqs) < 40 + 3
    log.close()


def test_legacy_blocks_materialize_through_shim(tmp_path):
    topic = "deltas/t0/d0"
    log = DurableLog(str(tmp_path))
    log.append(topic, _abatch_record(1, n=3))
    legacy_msg = SequencedDocumentMessage(
        client_id="c9", sequence_number=4, minimum_sequence_number=1,
        client_sequence_number=1, reference_sequence_number=1,
        type=MessageType.OPERATION, contents={"x": 1}, timestamp=5.0)
    log.append(topic, {"tenant_id": "t0", "document_id": "d0",
                       "message": legacy_msg})
    log.append(topic, _abatch_record(5, n=2))
    payloads, legacy = log.delta_blocks(topic, 0, 100)
    assert len(payloads) == 2
    assert legacy == [legacy_msg]
    log.close()


def _rand_json_value(rng, depth=0):
    r = rng.random()
    if depth >= 4 or r < 0.35:
        return rng.choice([None, True, False, 17, -3, 2.5, "plain", "",
                           _TAG_MSG, _TAG_ESC])
    if r < 0.55:
        return [_rand_json_value(rng, depth + 1)
                for _ in range(rng.randrange(3))]
    if r < 0.65:
        return SequencedDocumentMessage(
            client_id=f"c{rng.randrange(3)}",
            sequence_number=rng.randrange(100), minimum_sequence_number=0,
            client_sequence_number=rng.randrange(10),
            reference_sequence_number=rng.randrange(10),
            type=MessageType.OPERATION,
            contents={"p": rng.randrange(5)}, timestamp=1.5)
    keys = ["a", "b", _TAG_MSG, _TAG_ESC, "c_d"]
    return {rng.choice(keys): _rand_json_value(rng, depth + 1)
            for _ in range(rng.randrange(4))}


def test_wrap_unwrap_fuzz_roundtrip_with_tag_collisions():
    rng = random.Random(1234)
    for trial in range(300):
        v = _rand_json_value(rng)
        assert decode_json_value(encode_json_value(v)) == v, trial


@pytest.mark.parametrize("value", [
    {_TAG_MSG: 5}, {_TAG_ESC: {_TAG_MSG: 5}}, {_TAG_ESC: {_TAG_ESC: {}}},
    {_TAG_MSG: {_TAG_MSG: {_TAG_MSG: None}}},
    {_TAG_MSG: 1, _TAG_ESC: 2, "x": 3}, [{_TAG_MSG: [{_TAG_ESC: "y"}]}],
    {"outer": {_TAG_ESC: {"inner": {_TAG_MSG: [1, 2]}}}}])
def test_wrap_unwrap_adversarial_shapes(value):
    assert decode_json_value(encode_json_value(value)) == value


# -------------------------------------------- directories of both packages

RUN = dict(n_docs=6, clients_per_doc=2, ops_per_client=16, batch_size=8,
           flush_every=64)


def _write(pkg: str, directory: str, seed: int, array_lane: bool) -> None:
    os.makedirs(directory)
    log = (DurableLog if pkg == "port" else JaxLog)(directory)
    run = run_inproc if pkg == "port" else jax_run_inproc
    run(seed=seed, array_lane=array_lane, log=log, **RUN)
    log.flush()
    log.close()


def _records(log, topic: str) -> list:
    return [log.read(topic, i) for i in range(log.length(topic))]


def _messages(records: list) -> list:
    out = []
    for rec in records:
        if "abatch" in rec:
            out += rec["abatch"].messages()
        elif "boxcar" in rec:
            out += rec["boxcar"]
        else:
            out.append(rec["message"])
    return out


def _columns(records: list) -> list:
    """Every abatch record's columns, seq stamps and timestamps."""
    out = []
    for rec in records:
        batch = rec.get("abatch")
        if batch is None:
            continue
        box = batch.boxcar
        out.append((rec["tenant_id"], rec["document_id"], box.client_id,
                    box.ds_id, box.channel_id,
                    *(np.asarray(getattr(box, f)).tolist()
                      for f in ("kind", "a", "b", "cseq", "rseq",
                                "text_off")),
                    box.text, box.props, box.timestamp, batch.base_seq,
                    np.asarray(batch.msns).tolist(), batch.timestamp))
    return out


def _plain(value):
    """A record as plain data, comparable across the two packages'
    classes: dataclasses by class name and compared public fields, arrays
    as lists, enums by value."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                {f.name: _plain(getattr(value, f.name))
                 for f in dataclasses.fields(value)
                 if f.compare and not f.name.startswith("_")})
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, enum.Enum):
        return value.value
    return value


def _fields(msgs: list) -> list:
    return [(m.client_id, m.sequence_number, m.minimum_sequence_number,
             m.client_sequence_number, m.reference_sequence_number,
             str(m.type.value), m.contents, m.metadata, m.timestamp)
            for m in msgs]


@pytest.mark.parametrize("array_lane", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_reads_back_in_the_other_package(tmp_path, writer,
                                                   array_lane):
    d = str(tmp_path / "log")
    _write(writer, d, seed=2, array_lane=array_lane)
    port, jax = DurableLog(d, readonly=True), JaxLog(d, readonly=True)
    topics = port.list_topics()
    assert topics == jax.list_topics()
    assert sum(t.startswith("deltas/") for t in topics) == RUN["n_docs"]
    for topic in topics:
        assert port.refresh_topic(topic) == jax.refresh_topic(topic)
        got, want = _records(port, topic), _records(jax, topic)
        assert [_plain(r) for r in got] == [_plain(r) for r in want], topic
        if not topic.startswith("deltas/"):
            continue
        assert got
        assert _columns(got) == _columns(want), topic
        assert bool(_columns(got)) == array_lane
        assert _fields(_messages(got)) == _fields(_messages(want)), topic
    port.close()
    jax.close()


def test_same_seed_directories_agree(tmp_path):
    """Each package writes its own directory on one seed; read back by
    the port, every doc's sequenced stream agrees with client ids mapped
    by first appearance."""
    for pkg in ("port", "jax"):
        _write(pkg, str(tmp_path / pkg), seed=5, array_lane=True)
    logs = {pkg: DurableLog(str(tmp_path / pkg), readonly=True)
            for pkg in ("port", "jax")}
    for d in range(RUN["n_docs"]):
        topic = f"deltas/bench/doc{d}"
        streams = [_normalized(_messages(_records(log, topic)), {})
                   for log in logs.values()]
        assert len(streams[0]) > RUN["ops_per_client"]
        assert streams[0] == streams[1], topic
    for log in logs.values():
        log.close()


def test_local_server_reopens_over_its_directory(tmp_path):
    """A port LocalServer over a DurableLog, checkpointed and closed, is
    rebuilt over the same directory: deli resumes from its checkpoint in
    the log, no pre-restart delta is re-sequenced, and the doc goes on."""
    path = str(tmp_path / "service-log")

    def op(cseq, text):
        return DocumentMessage(
            client_sequence_number=cseq, reference_sequence_number=0,
            type=MessageType.OPERATION, contents={"text": text})

    server = LocalServer(log=DurableLog(path))
    conn = server.connect("t", "doc")
    for i in range(6):
        conn.submit([op(i + 1, f"op{i}")])
    server.checkpoint_all()
    server.log.sync()
    before = server.get_deltas("t", "doc", 0, 10**9)
    seq_before = server._orderers["t/doc"].deli.sequence_number
    server.log.close()
    del server

    server2 = LocalServer(log=DurableLog(path))
    conn2 = server2.connect("t", "doc")
    after = server2.get_deltas("t", "doc", 0, 10**9)
    assert _fields(after[:len(before)]) == _fields(before)
    assert len(after) == len(before) + 1  # exactly the new join
    assert after[-1].type == MessageType.CLIENT_JOIN
    assert after[-1].sequence_number == seq_before + 1
    conn2.submit([op(1, "after restart")])
    last = server2.get_deltas("t", "doc", 0, 10**9)[-1]
    assert last.contents == {"text": "after restart"}
    assert last.sequence_number == seq_before + 2
    server2.log.close()


def test_a_fresh_server_serves_get_deltas_and_checkpoints_in_parts(tmp_path):
    """A server built over another's durable log serves a doc's deltas
    at its first read (the read drains the replay it starts), and
    ``checkpoint_all((k, n))`` over k = 0..n-1 checkpoints every dirty
    pipeline exactly once."""
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.load_gen import run_inproc_on
    from fluidframework_tpu_torch.service.local_server import LocalServer

    log_dir = tmp_path / "log"
    log_dir.mkdir()
    first = LocalServer(log=DurableLog(str(log_dir)))
    run_inproc_on(first, n_docs=6, clients_per_doc=2, ops_per_client=12,
                  batch_size=6, array_lane=True)
    keys = sorted(first._orderers)
    want = {k: len(first.get_deltas(*k.split("/"), 0, 1 << 31))
            for k in keys}
    counts = dict.fromkeys(keys, 0)
    for key, orderer in first._orderers.items():
        checkpoint = orderer.checkpoint

        def counted(key=key, checkpoint=checkpoint):
            counts[key] += 1
            checkpoint()
        orderer.checkpoint = counted
    for k in range(3):
        first.checkpoint_all((k, 3))
    assert set(counts.values()) == {1}
    first.log.flush()
    fresh = LocalServer(log=DurableLog(str(log_dir), readonly=True))
    assert {k: len(fresh.get_deltas(*k.split("/"), 0, 1 << 31))
            for k in keys} == want
    assert all(n > 0 for n in want.values())
    first.log.close()
    fresh.log.close()
