"""The yardstick's arithmetic and generators, and the plain reference
held against hand-worked cases and against the port's CPU farm."""

from __future__ import annotations

import random
from dataclasses import replace

import numpy as np
import pytest

from portbench.reference.mergetree import (
    INS_CLIENT,
    INS_SEQ,
    REM_SEQ,
    REMOVERS,
    TEXT,
    Doc,
    replay,
    rich_runs,
)
from portbench.yardstick import stats, trace
from portbench.yardstick.driving import sample_docs, seed_rng
from portbench.yardstick.streams import farm_rich_text
from portbench.yardstick.synthetic import SyntheticEditor


# -- percentile over all samples ---------------------------------------------

def test_percentile_takes_every_sample_by_nearest_rank():
    samples = list(range(100, 0, -1))  # 1..100, unsorted
    assert stats.percentile(samples, 0.95) == 95
    assert stats.percentile(samples, 0.5) == 51
    assert stats.percentile(samples, 0.0) == 1
    assert stats.percentile(samples, 1.0) == 100
    # one far sample moves the tail only when it is in the tail
    assert stats.percentile(samples + [10**6], 0.95) == 96


def test_percentile_of_nothing_is_no_reading():
    with pytest.raises(ValueError):
        stats.percentile([], 0.95)


# -- the profiler's interval arithmetic ---------------------------------------

def test_union_length_merges_overlaps_and_nesting():
    assert trace.union_length([(0, 1), (0.5, 2), (3, 4), (3.2, 3.5)]) == 3.0
    assert trace.union_length([]) == 0.0


def test_idle_gaps_are_the_complement_longest_first():
    gaps = trace.idle_gaps([(1, 2), (1.5, 3), (6, 7)], 0, 11)
    assert gaps == [(7, 11), (3, 6), (0, 1)]
    assert trace.idle_gaps([(-1, 11)], 0, 10) == []


def test_covered_clips_spans_to_the_interval():
    s = np.array([0.0, 2.0, 5.0])
    e = np.array([1.0, 4.0, 6.0])
    assert trace.covered(s, e, 0.5, 5.5) == pytest.approx(0.5 + 2 + 0.5)
    assert trace.covered(s, e, 2.5, 3.0) == pytest.approx(0.5)
    assert trace.covered(s, e, 4.0, 5.0) == 0.0


def test_gap_label_is_the_innermost_host_activity():
    spans = {"submit": (np.array([0.0]), np.array([10.0])),
             "ingest": (np.array([1.0, 5.0]), np.array([2.0, 9.0]))}
    nested = {"submit": ["ingest"]}
    assert trace.label_gap(spans, nested, 4.0, 9.0) == "ingest"
    assert trace.label_gap(spans, nested, 0.0, 4.0) == "submit"
    assert trace.label_gap(spans, nested, 10.0, 20.0) == "other"


def test_analyse_splits_kernels_from_copies():
    device = [(0.0, 1.0, "apply_kernel(Args)"),
              (0.5, 1.5, "Memcpy HtoD (Pinned -> Device)"),
              (3.0, 4.0, "argsort"), (9.0, 12.0, "late")]
    out = trace.analyse(device, 0.0, 10.0, {}, {})
    assert out["busy_s"] == pytest.approx(1.5 + 1.0 + 1.0)
    assert out["window_s"] == 10.0
    assert set(out["kernel_s"]) == {"apply_kernel(Args)", "argsort", "late"}
    assert out["kernel_s"]["late"] == pytest.approx(1.0)
    assert out["idle_gaps"][0] == ["other", pytest.approx(5.0)]


# -- generators: the same seed gives the same inputs --------------------------

def test_synthetic_editor_is_fixed_by_its_seed():
    from fluidframework_tpu_torch.service.array_batch import ArrayBoxcar

    def boxes(seed):
        ed = SyntheticEditor(random.Random(seed), ArrayBoxcar, 0.475, 0.05, 8)
        ed.length = 40
        return [ed.next_boxcar(24) for _ in range(5)]

    a, b, c = boxes(11), boxes(11), boxes(12)
    key = lambda bs: [(x.kind.tolist(), x.a.tolist(), x.b.tolist(), x.text,
                       x.props) for x in bs]
    assert key(a) == key(b) and key(a) != key(c)


def test_sample_holds_the_largest_and_is_seeded():
    sizes = {f"d{i}": i for i in range(50)}
    s1 = sample_docs(sizes, 8, seed_rng(4, 1))
    assert s1[0] == "d49" and len(set(s1)) == 8
    assert s1 == sample_docs(sizes, 8, seed_rng(4, 1))
    assert s1 != sample_docs(sizes, 8, seed_rng(5, 1))


# -- the plain reference ------------------------------------------------------

def _op(kind, a, b, text, seq, ref, client, props=None, msn=0):
    return (kind, a, b, text, props, seq, ref, client, msn)


def test_reference_sequential_edits():
    ops = [_op(0, 0, 0, "hello", 1, 0, "A"),
           _op(0, 5, 0, " world", 2, 1, "A"),
           _op(1, 0, 1, "", 3, 2, "B"),
           _op(2, 1, 4, "", 4, 3, "B", {"k": 1}),
           _op(0, 4, 0, "XY", 5, 4, "A")]
    assert replay(ops) == [("e", ()), ("llo", (("k", 1),)),
                           ("XY world", ())]


def test_reference_concurrent_inserts_take_the_earliest_boundary():
    # B inserts at 1 without seeing A's insert at 1: B's text goes first
    ops = [_op(0, 0, 0, "ac", 1, 0, "A"),
           _op(0, 1, 0, "X", 2, 1, "A"),
           _op(0, 1, 0, "Y", 3, 1, "B")]
    assert replay(ops) == [("aYXc", ())]


def test_reference_concurrent_removes_and_annotate_of_removed_text():
    ops = [_op(0, 0, 0, "abcdef", 1, 0, "A"),
           _op(1, 1, 4, "", 2, 1, "A"),
           _op(1, 2, 5, "", 3, 1, "B"),      # overlaps A's remove
           _op(2, 0, 6, "", 4, 1, "C", {"k": 2}),  # C saw neither
           _op(0, 1, 0, "Z", 5, 4, "C")]
    doc = Doc()
    for op in ops:
        doc.apply(*op)
    removed = [s for s in doc.segs if s[REM_SEQ] is not None]
    assert {s[TEXT]: (s[REM_SEQ], s[REMOVERS]) for s in removed} == {
        "b": (2, {"A"}), "cd": (2, {"A", "B"}), "e": (3, {"B"})}
    assert doc.rich_text() == [("a", (("k", 2),)), ("Z", ()),
                               ("f", (("k", 2),))]


def test_reference_refuses_an_op_past_the_text():
    doc = Doc()
    doc.apply(*_op(0, 0, 0, "ab", 1, 0, "A"))
    with pytest.raises(ValueError):
        doc.apply(*_op(1, 1, 3, "", 2, 1, "A"))
    with pytest.raises(ValueError):
        doc.apply(*_op(0, 1, 0, "x", 2, 1, "A"))  # seq not after the last


def test_compaction_changes_no_text():
    rng = random.Random(3)
    ops, length, seq = [], 0, 0
    for _ in range(400):
        seq += 1
        if length > 4 and rng.random() < 0.45:
            a = rng.randrange(length - 1)
            b = rng.randint(a + 1, min(length, a + 8))
            ops.append(_op(1, a, b, "", seq, seq - 1, "A", msn=seq - 3))
            length -= b - a
        elif length > 1 and rng.random() < 0.2:
            a = rng.randrange(length - 1)
            ops.append(_op(2, a, a + 1, "", seq, seq - 1, "A",
                           {"k": rng.randrange(3)}, msn=seq - 3))
        else:
            t = "xyz"[:rng.randint(1, 3)]
            ops.append(_op(0, rng.randint(0, length), 0, t, seq, seq - 1,
                           "A", msn=seq - 3))
            length += len(t)
    never = [op[:8] + (0,) for op in ops]  # msn 0: nothing compacts
    assert replay(ops) == replay(never)
    assert sum(len(t) for t, _ in replay(ops)) == length


def test_rich_runs_merge_equal_properties():
    assert rich_runs([("a", {}), ("", {"k": 1}), ("b", {}),
                      ("c", {"k": 1, "j": 2}), ("d", {"j": 2, "k": 1})]) \
        == [("ab", ()), ("cd", (("j", 2), ("k", 1)))]


def _perspective_length(doc: Doc, ref: int, client) -> int:
    return sum(len(s[TEXT]) for s in doc.segs
               if (s[INS_CLIENT] == client or s[INS_SEQ] <= ref)
               and (s[REM_SEQ] is None
                    or (s[REM_SEQ] > ref and client not in s[REMOVERS])))


def _concurrent_stream(seed: int, n_ops: int, n_clients: int) -> list:
    """A sequenced stream where each client's refSeq lags: valid ops at
    every op's own perspective, made with the reference's own view."""
    rng = random.Random(seed)
    doc = Doc()
    last_ref = [0] * n_clients
    ops = []
    for seq in range(1, n_ops + 1):
        c = rng.randrange(n_clients)
        last_ref[c] = rng.randint(last_ref[c], seq - 1)
        ref, client, msn = last_ref[c], f"c{c}", min(last_ref)
        n = _perspective_length(doc, ref, client)
        r = rng.random()
        if n > 2 and r < 0.35:
            a = rng.randrange(n - 1)
            op = _op(1, a, rng.randint(a + 1, min(n, a + 6)), "", seq, ref,
                     client, msn=msn)
        elif n > 2 and r < 0.5:
            a = rng.randrange(n - 1)
            op = _op(2, a, rng.randint(a + 1, min(n, a + 6)), "", seq, ref,
                     client, {f"k{rng.randrange(3)}": rng.randrange(4)},
                     msn=msn)
        else:
            op = _op(0, rng.randint(0, n), 0, "pqrstu"[:rng.randint(1, 6)],
                     seq, ref, client, msn=msn)
        doc.apply(*op)
        ops.append(op)
    return ops


@pytest.mark.parametrize("seed", range(6))
def test_reference_agrees_with_the_ports_farm_under_concurrency(
        seed, one_thread):
    """Streams with lagging refSeqs, 2 and 5 clients: the port's CPU
    farm (held against the JAX package by the tier-1 tests) and the
    reference give the same rich text."""
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    streams = {f"d{k}": _concurrent_stream(seed * 10 + k, 90, (2, 5)[k % 2])
               for k in range(4)}
    app = GpuDocumentApplier(device="cpu", max_docs=4, max_slots=256,
                             ops_per_dispatch=16)
    wire = {}
    for doc, ops in streams.items():
        pairs = []
        for kind, a, b, text, props, seq, ref, client, msn in ops:
            op = ({"type": 0, "pos": a, "text": text} if kind == 0 else
                  {"type": 1, "start": a, "end": b} if kind == 1 else
                  {"type": 2, "start": a, "end": b, "props": props})
            pairs.append((SequencedDocumentMessage(
                client_id=client, sequence_number=seq,
                minimum_sequence_number=msn, client_sequence_number=seq,
                reference_sequence_number=ref, type=MessageType.OPERATION,
                contents=None), op))
        wire[doc] = pairs
    app.set_replay_source(lambda t, d: [replace(m, contents=w)
                                        for m, w in wire[d]])
    for doc, pairs in wire.items():
        for i in range(0, len(pairs), 7):
            app.ingest_batch("t", doc, pairs[i:i + 7])
        app.flush()
    app.finalize()
    for doc, ops in streams.items():
        assert farm_rich_text(app.get_tree("t", doc)) == replay(ops), doc
