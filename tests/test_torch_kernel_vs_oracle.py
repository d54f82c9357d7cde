"""The port's plain apply lane == the port's scalar oracle on fuzzed streams.

The port's twin of tests/test_kernel_vs_oracle.py, with the same cases
and parametrisation: sequenced op streams from seeded concurrent farm
sessions go through the port's oracle (``mergetree/``) and, vectorized
into op rows, through ``ops/apply.py::apply_ops_batch_ref`` with
``compact_batch`` (the plain version of the CUDA kernel and zamboni).
After every round the decoded state must match the oracle exactly: per
character text, insert and remove stamps and properties, plus the visible
text at random past (refSeq, client) perspectives. Runs on the CPU; the
kernel is held against the same plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import random

import numpy as np
import torch

import pytest

from fluidframework_tpu_torch.mergetree import MergeTreeClient, Perspective
from fluidframework_tpu_torch.ops.apply import (
    NO_VAL,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
    apply_ops_batch_ref,
    compact_batch,
    make_op,
    wave_min_seq,
)
from fluidframework_tpu_torch.ops.doc_state import (
    FLAG_MARKER,
    DocState,
    PropTable,
    TextArena,
    decode_state,
    encode_tree,
)
from fluidframework_tpu_torch.ops.opgen import generate_doc_ops
from fluidframework_tpu_torch.protocol import (
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.testing.farm import (
    FarmClient,
    FarmServer,
    random_op,
)


def norm_chars(tree, min_seq, view):
    """Per-char (char, norm insert stamp, remove stamp, props) tuples;
    stamps at or below min_seq are one class (visible or removed in every
    reachable perspective), so oracle-side zamboni merges do not differ."""
    out = []
    for seg in tree.segments:
        if not seg.visible_in(view):
            continue
        ins = (0, -2) if seg.ins_seq <= min_seq else (seg.ins_seq,
                                                       seg.ins_client)
        props = tuple(sorted(seg.props.items()))
        body = "￼" if seg.is_marker else seg.text
        for ch in body:
            out.append((ch, ins, seg.rem_seq, props))
    return out


class PlainDoc:
    """One doc of the port's plain apply lane, with its host arena and
    prop table (the single-doc twin of GpuDocumentApplier's staging)."""

    def __init__(self, max_slots=256):
        self.state = DocState.empty(1, max_slots, device="cpu")
        self.arena = TextArena()
        self.props = PropTable()

    def vectorize(self, msg, intern):
        c = msg.contents
        common = dict(seq=msg.sequence_number,
                      ref_seq=msg.reference_sequence_number,
                      client=intern(msg.client_id),
                      msn=msg.minimum_sequence_number)

        def annotates(start, end, props):
            return [make_op(OP_ANNOTATE, pos=start, end=end,
                            key=self.props.intern_key(k),
                            val=NO_VAL if v is None
                            else self.props.intern_val(v), **common)
                    for k, v in props.items()]

        if c["type"] == 0:  # insert (+ optional props on the new segment)
            if c.get("text") is None:  # marker
                start = self.arena.append("￼")
                vecs = [make_op(OP_INSERT, pos=c["pos"], text_len=1,
                                text_start=start, flags=FLAG_MARKER,
                                **common)]
                tlen = 1
            else:
                text = c["text"]
                start = self.arena.append(text)
                vecs = [make_op(OP_INSERT, pos=c["pos"], text_len=len(text),
                                text_start=start, **common)]
                tlen = len(text)
            vecs.extend(annotates(c["pos"], c["pos"] + tlen,
                                  c.get("props") or {}))
            return vecs
        if c["type"] == 1:  # remove
            return [make_op(OP_REMOVE, pos=c["start"], end=c["end"],
                            **common)]
        if c["type"] == 2:  # annotate: one device op per key
            return annotates(c["start"], c["end"], c["props"])
        return []

    def apply_rows(self, rows):
        """One wave: the rows as a [1, K, OP_FIELDS] batch."""
        ops = torch.from_numpy(np.stack(rows))[None]
        self.state = apply_ops_batch_ref(self.state, ops)

    def apply_wire(self, msg, intern):
        rows = self.vectorize(msg, intern)
        if rows:
            self.apply_rows(rows)

    def compact_to(self, min_seq):
        self.state = compact_batch(
            self.state, torch.tensor([min_seq], dtype=torch.int32))

    @property
    def overflow(self) -> bool:
        return bool(self.state.overflow[0])


def run_stream(seed, n_clients=3, rounds=8, compact_every=0,
               allow_annotate=True):
    """Drive a farm; feed the sequenced stream to the oracle server
    replica and the plain lane, and compare after every round."""
    rng = random.Random(seed)
    clients = [FarmClient(f"c{i}") for i in range(n_clients)]
    server = FarmServer(clients, rng)
    oracle = MergeTreeClient("__server__")
    doc = PlainDoc()
    stream: list[SequencedDocumentMessage] = []

    for rnd in range(rounds):
        for fc in clients:
            for _ in range(rng.randint(1, 3)):
                random_op(fc, rng, allow_annotate=allow_annotate)
        while True:
            ready = [c for c in clients if c.outbound]
            if not ready:
                break
            sender = rng.choice(ready)
            raw = sender.outbound.popleft()
            server.seq += 1
            server.client_ref[sender.name] = max(
                server.client_ref[sender.name], raw["refSeq"])
            msg = SequencedDocumentMessage(
                client_id=sender.name,
                sequence_number=server.seq,
                minimum_sequence_number=min(server.client_ref.values()),
                client_sequence_number=raw["clientSeq"],
                reference_sequence_number=raw["refSeq"],
                type=MessageType.OPERATION,
                contents=raw["contents"],
            )
            for c in clients:
                c.client.apply_msg(msg)
            oracle.apply_msg(msg)
            doc.apply_wire(msg, oracle.intern)
            stream.append(msg)
        if compact_every and rnd % compact_every == compact_every - 1:
            doc.compact_to(oracle.tree.min_seq)

        # host escalation, as the applier does: a doc past the fixed
        # bounds is flagged, rebuilt from the oracle and re-uploaded once
        # its state encodes cleanly again
        if doc.overflow:
            arena = TextArena()
            st = encode_tree(oracle.tree, arena, doc.state.max_slots,
                             prop_table=doc.props, device="cpu")
            if not bool(st.overflow[0]):
                doc.state, doc.arena = st, arena
        if not doc.overflow:
            compare(oracle, doc, rng, f"seed={seed} round={rnd}")
    assert not doc.overflow, "doc never de-escalated"
    return oracle, doc, stream


def compare(oracle, doc, rng, ctx):
    tree = decode_state(doc.state, doc.arena, doc.props)
    min_seq = oracle.tree.min_seq
    cur = Perspective(oracle.tree.current_seq, 10**7)
    o_chars = norm_chars(oracle.tree, min_seq, cur)
    k_chars = norm_chars(tree, min_seq, cur)
    assert o_chars == k_chars, (
        f"{ctx}: char/stamp mismatch\noracle: {o_chars[:40]}\n"
        f"plain:  {k_chars[:40]}")
    for _ in range(5):  # past perspectives (only refSeq >= minSeq)
        ref = rng.randint(min_seq, oracle.tree.current_seq)
        client = rng.choice(list(oracle._ids.values()) + [10**7])
        view = Perspective(ref, client)
        assert oracle.tree.get_text(view) == tree.get_text(view), (
            f"{ctx}: past view ({ref},{client}) diverged")


def _msg(seq, contents, client="a", ref=None):
    return SequencedDocumentMessage(
        client_id=client, sequence_number=seq, minimum_sequence_number=0,
        client_sequence_number=seq,
        reference_sequence_number=seq - 1 if ref is None else ref,
        type=MessageType.OPERATION, contents=contents)


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_oracle(seed):
    run_stream(seed, n_clients=3, rounds=8, allow_annotate=False)


@pytest.mark.parametrize("seed", range(6))
def test_plain_matches_oracle_with_annotate(seed):
    run_stream(200 + seed, n_clients=3, rounds=8, allow_annotate=True)


@pytest.mark.parametrize("seed", range(3))
def test_plain_matches_oracle_with_compaction(seed):
    run_stream(100 + seed, n_clients=4, rounds=8, compact_every=2)


def test_annotate_lww_and_delete():
    """Per-key LWW in seq order, None deletes, splits copy props to both
    halves."""
    doc = PlainDoc(max_slots=32)
    intern = {"a": 0, "b": 1}.__getitem__
    doc.apply_wire(_msg(1, {"type": 0, "pos": 0, "text": "hello world"}),
                   intern)
    doc.apply_wire(_msg(2, {"type": 2, "start": 0, "end": 5,
                            "props": {"bold": True, "size": 12}}), intern)
    doc.apply_wire(_msg(3, {"type": 2, "start": 0, "end": 3,
                            "props": {"bold": False}}, client="b"), intern)
    doc.apply_wire(_msg(4, {"type": 2, "start": 0, "end": 2,
                            "props": {"size": None}}), intern)
    doc.apply_wire(_msg(5, {"type": 0, "pos": 4, "text": "XY"}), intern)

    tree = decode_state(doc.state, doc.arena, doc.props)
    view = Perspective(10**6, 10**7)
    assert tree.get_text(view) == "hellXYo world"
    props_at = [dict(c[3]) for c in norm_chars(tree, 0, view)]
    assert props_at[0] == {"bold": False}
    assert props_at[2] == {"bold": False, "size": 12}
    assert props_at[3] == {"bold": True, "size": 12}
    assert props_at[4] == {}  # inserted X
    assert props_at[6] == {"bold": True, "size": 12}  # tail half of 'o'
    assert props_at[8] == {}  # 'w' never annotated
    assert not doc.overflow


def test_prop_table_capacity_overflow_flags():
    """A slot needing a (P+1)th distinct key flags overflow for host
    escalation instead of dropping the annotate."""
    doc = PlainDoc(max_slots=16)
    P = doc.state.max_props
    intern = lambda cid: 0  # noqa: E731
    doc.apply_wire(_msg(1, {"type": 0, "pos": 0, "text": "x"}), intern)
    for k in range(P + 1):
        doc.apply_wire(_msg(2 + k, {"type": 2, "start": 0, "end": 1,
                                    "props": {f"key{k}": k}}), intern)
    assert doc.overflow


def test_user_text_marker_glyph_roundtrips():
    """User text holding U+FFFC is text, not a marker: marker-ness is the
    out-of-band flags bit."""
    doc = PlainDoc(max_slots=16)
    intern = lambda cid: 0  # noqa: E731
    doc.apply_wire(_msg(1, {"type": 0, "pos": 0, "text": "a￼b"}), intern)
    doc.apply_wire(_msg(2, {"type": 0, "pos": 3, "text": None,
                            "marker": {"refType": 1}}), intern)
    segs = decode_state(doc.state, doc.arena, doc.props).segments
    assert [s.is_marker for s in segs] == [False, True]
    assert segs[0].text == "a￼b"


def test_zamboni_runs_at_wave_msn():
    """With the msn riding each op, compaction after each wave drops the
    tombstones the collaboration window has passed: the slot count stays
    bounded under insert/remove churn."""
    ops, _, _ = generate_doc_ops(np.random.default_rng(3), 512,
                                 remove_fraction=0.48, max_insert=4,
                                 msn_lag=8)
    state = DocState.empty(1, 256, device="cpu")
    K = 16
    counts = []
    for i in range(0, 512, K):
        wave = torch.from_numpy(ops[i:i + K])[None]
        state = compact_batch(apply_ops_batch_ref(state, wave),
                              wave_min_seq(wave))
        counts.append(int(state.count[0]))
    assert not bool(state.overflow[0])
    # without zamboni this stream overflows 256 slots
    assert max(counts) < 200, max(counts)


def test_wave_batch_matches_single_op_path():
    """A K-op wave == the same rows applied one op at a time."""
    rng = random.Random(7)
    clients = [FarmClient(f"c{i}") for i in range(3)]
    server = FarmServer(clients, rng)
    oracle = MergeTreeClient("__server__")
    for fc in clients:
        for _ in range(6):
            random_op(fc, rng, allow_annotate=True)
    server.sequence_all()

    single = PlainDoc()
    rows = []
    for m in server.log:
        for row in single.vectorize(m, oracle.intern):
            rows.append(row)
            single.apply_rows([row])
    batched = PlainDoc()
    batched.apply_rows(rows)
    for f in ("length", "text_start", "flags", "ins_seq", "ins_client",
              "rem_seq", "prop_key", "prop_val", "count"):
        np.testing.assert_array_equal(getattr(batched.state, f).numpy(),
                                      getattr(single.state, f).numpy(), f)
