"""The port's snapcols chunk codec against the JAX package's.

``protocol/snapcols.py`` of both packages encodes the same merge-tree
snapshots (random collaborative histories of three clients, seeded, as in
``tests/test_snapshot_boot.py``'s fuzz) into chunk lists that must be
equal byte for byte; the port decodes them back to the exact snapshot,
and a port replica loaded from the decoded form holds the same text.
Prefix stability under append holds as in the JAX package's test, and
hand-built segments reach every kind bit and aux tag.
"""

import hashlib
import json
import random

import pytest

from fluidframework_tpu.mergetree import MergeTreeClient as JaxMergeTreeClient
from fluidframework_tpu.protocol import snapcols as jax_snapcols
from fluidframework_tpu_torch.mergetree import MergeTreeClient, op_to_wire
from fluidframework_tpu_torch.protocol import (
    MessageType,
    SequencedDocumentMessage,
    snapcols,
)

from tests.mergetree_fixtures import FarmClient, FarmServer, random_op


def _canon(snap: dict) -> str:
    return json.dumps(snap, sort_keys=True)


def _fuzz_snapshot(seed: int) -> dict:
    rng = random.Random(seed)
    clients = [FarmClient(f"c{i}") for i in range(3)]
    farm = FarmServer(clients, rng)
    for _ in range(rng.randint(30, 120)):
        random_op(rng.choice(clients), rng)
        if rng.random() < 0.4:
            farm.sequence_one()
    farm.sequence_all()
    return clients[0].client.snapshot()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("segs_per_chunk", [7, snapcols.SEGS_PER_CHUNK])
def test_chunks_equal_jax_and_round_trip(seed, segs_per_chunk):
    snap = _fuzz_snapshot(seed)
    chunks = snapcols.encode_snapshot_chunks(snap, segs_per_chunk)
    assert chunks == jax_snapcols.encode_snapshot_chunks(snap, segs_per_chunk)
    decoded = snapcols.decode_snapshot_chunks(chunks, snap["minSeq"],
                                              snap["seq"])
    assert _canon(decoded) == _canon(snap)
    assert _canon(decoded) == _canon(jax_snapcols.decode_snapshot_chunks(
        chunks, snap["minSeq"], snap["seq"]))
    assert MergeTreeClient.load("b", decoded).get_text() \
        == JaxMergeTreeClient.load("a", snap).get_text()


def _append_run(client_cls, msg_cls, wire, n=160, snap_at=150):
    c = client_cls("w")
    snap1 = None
    for i in range(n):
        op = c.insert_text_local(c.get_length(), f"s{i} ")
        c.apply_msg(msg_cls(
            client_id="w", sequence_number=i + 1,
            minimum_sequence_number=i + 1, client_sequence_number=i + 1,
            reference_sequence_number=i, type=MessageType.OPERATION,
            contents=wire(op)), local=True)
        if i == snap_at:
            snap1 = c.snapshot()
    return snap1, c.snapshot()


def test_prefix_stable_under_append_as_jax():
    """A quiet single-writer doc coalesces into one growing run; the text
    split keeps every chunk but the trailing one byte-identical across the
    append, and the port's chunks equal the JAX package's (whose replica
    ran the same edits)."""
    from fluidframework_tpu.mergetree import op_to_wire as jax_op_to_wire
    from fluidframework_tpu.protocol import (
        SequencedDocumentMessage as JaxMessage,
    )

    snap1, snap2 = _append_run(MergeTreeClient, SequencedDocumentMessage,
                               op_to_wire)
    jsnap1, jsnap2 = _append_run(JaxMergeTreeClient, JaxMessage,
                                 jax_op_to_wire)
    assert _canon(snap1) == _canon(jsnap1) and _canon(snap2) == _canon(jsnap2)
    assert len(snap1["segments"]) == 1 and len(snap2["segments"]) == 1

    def enc(s):
        return snapcols.encode_snapshot_chunks(s, segs_per_chunk=4,
                                               text_split=64)

    chunks1, chunks2 = enc(snap1), enc(snap2)
    for s, chunks in ((jsnap1, chunks1), (jsnap2, chunks2)):
        assert chunks == jax_snapcols.encode_snapshot_chunks(
            s, segs_per_chunk=4, text_split=64)

    def h(b):
        return hashlib.sha256(b).hexdigest()

    assert len(chunks1) >= 3
    assert [h(b) for b in chunks1[:-1]] \
        == [h(b) for b in chunks2[:len(chunks1) - 1]]
    assert h(chunks1[-1]) != h(chunks2[len(chunks1) - 1])
    for snap, chunks in ((snap1, chunks1), (snap2, chunks2)):
        decoded = snapcols.decode_snapshot_chunks(
            chunks, snap["minSeq"], snap["seq"])
        assert _canon(decoded) == _canon(snap)


SEGMENTS = [
    {"text": "plain"},
    {"text": "ins", "insSeq": 4, "insClient": "client-a"},
    {"text": "é€😀", "insSeq": 5, "insClient": None,
     "props": {"b": True, "a": [1, 2.5, None, "s", {"z": False, "y": -7}]}},
    {"marker": {"refType": 1, "tile": "para"}, "insSeq": 6,
     "insClient": "client-b"},
    {"text": "gone", "insSeq": 7, "insClient": "client-a", "remSeq": 9,
     "remClient": "client-b", "remClients": ["client-b", "client-c"]},
    {"marker": {}, "props": {"k": 2 ** 40}, "remSeq": 8,
     "remClient": "client-c"},
]


@pytest.mark.parametrize("segs_per_chunk", [1, 2, 256])
def test_every_kind_and_aux_tag(segs_per_chunk):
    snap = {"minSeq": 3, "seq": 9, "segments": SEGMENTS}
    chunks = snapcols.encode_snapshot_chunks(snap, segs_per_chunk)
    assert chunks == jax_snapcols.encode_snapshot_chunks(snap,
                                                         segs_per_chunk)
    assert _canon(snapcols.decode_snapshot_chunks(chunks, 3, 9)) \
        == _canon(snap)


def test_empty_snapshot_and_refusals():
    empty = {"minSeq": 0, "seq": 0, "segments": []}
    assert snapcols.encode_snapshot_chunks(empty) \
        == jax_snapcols.encode_snapshot_chunks(empty)
    assert snapcols.decode_snapshot_chunks(
        snapcols.encode_snapshot_chunks(empty), 0, 0) == empty
    with pytest.raises(TypeError, match="wire strings"):
        snapcols.encode_chunk([{"text": "x", "insSeq": 1, "insClient": 3}])
    with pytest.raises(TypeError, match="cannot encode"):
        snapcols.encode_chunk([{"text": "x", "props": {"k": object()}}])
    chunk = bytearray(snapcols.encode_chunk([{"text": "x"}]))
    chunk[0] = 9
    with pytest.raises(ValueError, match="unknown chunk version"):
        snapcols.decode_chunk(bytes(chunk))
