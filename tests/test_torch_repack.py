"""The farm's repack on the CPU: zamboni's merge of settled neighbours on
a doc's row, done before a wave could take the doc past its slots.

``ops/doc_state.py::merge_settled_runs`` is held to the host oracle's
merge (``MergeTree.update_min_seq`` with ``Segment.can_append``) on the
same rows. A small farm (S=64, K=4) fed histories far longer than its
slots hold, through the array lane and the dict lane, sync and async,
repacks instead of escalating, and every doc's rich text equals the plain
reference's replay (``portbench/reference/mergetree.py``) before and after
further ops. A doc that a lagging client keeps in the collaboration
window cannot shrink: it still escalates, and the counters say so, the
ops its host replica applied included. A repacked farm's checkpoint
round-trips, and a farm too narrow to repack (S ≤ 4K) escalates as
before.
"""

from __future__ import annotations

import copy
import random
from dataclasses import replace

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.mergetree.mergetree import MergeTree
from fluidframework_tpu_torch.ops.doc_state import (
    FIELDS,
    FLAG_MARKER,
    NO_KEY,
    NO_SEQ,
    SLOT_FILL,
    DocState,
    PropTable,
    TextArena,
    decode_state,
    merge_settled_runs,
    state_from_numpy,
)
from fluidframework_tpu_torch.service.array_batch import ArrayBoxcar
from fluidframework_tpu_torch.service.broadcaster import BroadcasterLambda
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    load_applier_checkpoint,
    repack_ceiling,
    repack_watermark,
    save_applier_checkpoint,
)
from fluidframework_tpu_torch.service.local_server import LocalServer
from portbench.reference.mergetree import replay
from portbench.yardstick.streams import farm_rich_text, reference_ops
from portbench.yardstick.synthetic import SyntheticEditor

SMALL = dict(max_slots=64, ops_per_dispatch=4)


def _stream(seed: int, clients: int, rounds: int, boxcar: int,
            lagging: bool = False) -> list:
    """One doc's broadcast array batches: ``clients`` synthetic editors
    taking turns on a ``LocalServer``, each sending ``rounds`` boxcars.
    With ``lagging`` one more client joins first and never sends, so the
    msn stays at its join."""
    server = LocalServer()
    rng = random.Random(seed)
    entries = []
    server.pubsub.subscribe(BroadcasterLambda.topic("t", "doc"),
                            entries.append)
    if lagging:
        server.connect("t", "doc")
    sessions = []
    for _ in range(clients):
        conn = server.connect("t", "doc")
        editor = SyntheticEditor(rng, ArrayBoxcar, 0.475, 0.05, 8)

        def on_abatch(batch, editor=editor, me=conn.client_id):
            if batch.boxcar.client_id == me:
                editor.ref_seq = batch.last_seq
            else:
                editor.observe_abatch(batch)

        def on_ops(batch, editor=editor):
            for msg in batch:
                editor.observe(msg)

        conn.on_abatch = on_abatch
        conn.on_ops = on_ops
        sessions.append((conn, editor))
    for _ in range(rounds):
        for conn, editor in sessions:
            conn.submit_array(editor.next_boxcar(boxcar, "t", "doc",
                                                 conn.client_id))
    return [e for e in entries if type(e) is not list]


def _farm(streams: dict, **kw) -> GpuDocumentApplier:
    app = GpuDocumentApplier(device="cpu", max_docs=len(streams),
                             **{**SMALL, **kw})
    app.set_replay_source(lambda t, d: [
        replace(b.message(j), contents=b.boxcar.wire_op(j))
        for b in streams[d] for j in range(b.n)])
    return app


def _feed(app, streams: dict, lane: str, lo: int = 0, hi: int = None,
          flush_every: int = 4) -> None:
    """Each doc's batches ``[lo, hi)``, docs taking turns, a flush every
    ``flush_every`` turns, then ``finalize``."""
    hi = max(len(s) for s in streams.values()) if hi is None else hi
    for i in range(lo, hi):
        for doc, batches in streams.items():
            if i >= len(batches):
                continue
            b = batches[i]
            if lane == "array":
                app.ingest_array_batch("t", doc, b)
            else:
                app.ingest_batch("t", doc, [(b.message(j), b.boxcar.wire_op(j))
                                            for j in range(b.n)])
        if i % flush_every == flush_every - 1:
            app.flush()
    app.finalize()


def _differing(app, streams: dict, upto: int = None) -> list:
    return [d for d, s in streams.items()
            if farm_rich_text(app.get_tree("t", d))
            != replay(reference_ops(s[:upto]))]


# ------------------------------------------------------------ the merge rule

def _rows(app, doc: str) -> tuple:
    """The doc's row as merge_settled_runs takes it, with its arena."""
    slot = app.slot_of("t", doc)
    state, row = app._locate(slot)
    rows = {f: getattr(state, f)[row:row + 1].numpy().copy()
            for f in FIELDS[:-1]}
    return rows, app.arenas[slot], int(app._applied_msn[slot])


def _merged_tree(rows: dict, arena: TextArena, msn: int,
                 props: PropTable) -> MergeTree:
    merged = merge_settled_runs(rows, np.array([msn]))
    n = int(merged["count"][0])
    old = arena.text()
    text = "".join(old[a:a + b] for a, b in zip(
        rows["text_start"][0, :int(rows["count"][0])].tolist(),
        rows["length"][0, :int(rows["count"][0])].tolist()))
    starts = np.cumsum(merged["length"][0]) - merged["length"][0]
    merged["text_start"] = np.where(np.arange(len(starts)) < n, starts,
                                    0)[None].astype(np.int32)
    new_arena = TextArena()
    new_arena.append(text)
    merged["overflow"] = np.zeros(1, bool)
    return decode_state(state_from_numpy(merged, "cpu"), new_arena, props)


def _segments(tree: MergeTree) -> list:
    return [(s.text, s.is_marker, s.ins_seq, s.ins_client, s.rem_seq,
             sorted(s.rem_clients) if s.rem_seq is not None else [],
             sorted((s.props or {}).items())) for s in tree.segments]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_merge_equals_update_min_seq(seed):
    """Rows of a doc that never reached its watermark, merged at its
    msn, decode to the segments the oracle's ``update_min_seq`` makes of
    the same rows: the same runs, stamps from each run's first segment,
    equal properties in any table order, markers, removed and
    in-window segments left alone."""
    streams = {"doc": _stream(seed, clients=3, rounds=40, boxcar=6)}
    app = _farm(streams, max_slots=1024, ops_per_dispatch=8)
    _feed(app, streams, "array")
    assert int(app.doc_repacks.sum()) == 0
    rows, arena, msn = _rows(app, "doc")
    slot = app.slot_of("t", "doc")
    state, row = app._locate(slot)
    oracle = decode_state(state, arena, app.prop_table, doc=row)
    kept = len(oracle.segments)
    oracle.update_min_seq(msn)
    got = _merged_tree(rows, arena, msn, app.prop_table)
    assert _segments(got) == _segments(oracle)
    assert len(got.segments) < kept  # something merged
    settled = [s for s in got.segments if s.ins_seq > msn or s.rem_seq]
    assert settled  # and something stayed in the window
    app.close()


def _hand_rows(slots: list, width: int = 8, props: int = 2) -> dict:
    """One doc's row from (length, flags, ins_seq, rem_seq, props)."""
    rows = {f: np.full((1, width, props) if f.startswith("prop")
                       else (1, width), SLOT_FILL[f], np.int32)
            for f in FIELDS[:-2]}
    start = 0
    for i, (length, flags, ins, rem, table) in enumerate(slots):
        rows["length"][0, i] = length
        rows["text_start"][0, i] = start
        rows["flags"][0, i] = flags
        rows["ins_seq"][0, i] = ins
        rows["ins_client"][0, i] = i
        rows["rem_seq"][0, i] = rem
        for p, (k, v) in enumerate(table):
            rows["prop_key"][0, i, p] = k
            rows["prop_val"][0, i, p] = v
        start += length
    rows["count"] = np.array([len(slots)], np.int32)
    return rows


def test_merge_keeps_what_can_append_refuses():
    """Only settled, unremoved, unmarked neighbours with equal tables
    merge; a table's entry order does not matter; the run keeps its
    first slot's stamps; unused slots come back filled."""
    rows = _hand_rows([
        (2, 0, 1, NO_SEQ, []),
        (3, 0, 2, NO_SEQ, []),              # joins slot 0
        (1, FLAG_MARKER, 3, NO_SEQ, []),    # a marker: alone
        (4, 0, 4, NO_SEQ, [(0, 1), (1, 2)]),
        (1, 0, 5, NO_SEQ, [(1, 2), (0, 1)]),  # same props, other order
        (2, 0, 6, 7, []),                   # removed: alone
        (2, 0, 9, NO_SEQ, []),              # above the msn: alone
    ])
    merged = merge_settled_runs(rows, np.array([8]))
    assert merged["count"].tolist() == [5]
    assert merged["length"][0, :5].tolist() == [5, 1, 5, 2, 2]
    assert merged["ins_seq"][0, :5].tolist() == [1, 3, 4, 6, 9]
    assert merged["ins_client"][0, :5].tolist() == [0, 2, 3, 5, 6]
    assert merged["rem_seq"][0, :5].tolist() == [NO_SEQ] * 3 + [7, NO_SEQ]
    assert (merged["length"][0, 5:] == 0).all()
    assert (merged["prop_key"][0, 5:] == NO_KEY).all()
    assert (merged["rem_seq"][0, 5:] == NO_SEQ).all()


def test_watermark_and_ceiling_follow_s_and_k():
    assert repack_watermark(1024, 32) == 960
    assert repack_ceiling(1024, 32) == 896
    assert repack_watermark(64, 4) == 56 and repack_ceiling(64, 4) == 48
    # S ≤ 4K: nothing to repack into
    assert repack_ceiling(8, 4) <= 0


# -------------------------------------------------------- the small farm

def _long_streams(n_docs: int = 4, rounds: int = 60) -> dict:
    """Histories of 480 ops a doc: about 1,000 slots unmerged, for 64."""
    return {f"doc{i}": _stream(i, clients=2, rounds=rounds, boxcar=4)
            for i in range(n_docs)}


@pytest.mark.parametrize("lane", ["array", "dict"])
@pytest.mark.parametrize("async_dispatch", [False, True])
def test_small_farm_repacks_instead_of_escalating(lane, async_dispatch):
    streams = _long_streams()
    half = 30
    app = _farm(streams, async_dispatch=async_dispatch)
    try:
        _feed(app, streams, lane, hi=half)
        assert _differing(app, streams, upto=half) == []
        first = int(app.doc_repacks.sum())
        _feed(app, streams, lane, lo=half)
        assert _differing(app, streams) == []
        assert 0 < first < int(app.doc_repacks.sum())
        assert app.host_escalations == 0 and app.repack_escalations == 0
        assert app.repack_slots_out < app.repack_slots_in
        total = sum(b.n for s in streams.values() for b in s)
        assert app.ops_applied == total and app.host_ops_applied == 0
        # a repacked doc's arena holds its slots' text and what came
        # after, not its whole history
        for doc in streams:
            slot = app.slot_of("t", doc)
            history = sum(len(b.boxcar.text) for b in streams[doc])
            if app.doc_repacks[slot]:
                assert len(app.arenas[slot].text()) < history
            else:
                assert len(app.arenas[slot].text()) == history
    finally:
        app.close()


def test_sync_and_async_lanes_repack_alike():
    """The async worker hands a repack to the caller's next sync point
    and waits: its waves, counts and rows are the sync lane's."""
    streams = _long_streams()
    apps = [_farm(streams, async_dispatch=a) for a in (False, True)]
    for app in apps:
        _feed(app, streams, "array")
    sync, worker = apps
    for name in ("dispatches", "ops_applied", "repack_slots_in",
                 "repack_slots_out"):
        assert getattr(sync, name) == getattr(worker, name), name
    assert np.array_equal(sync.doc_repacks, worker.doc_repacks)
    for f in FIELDS:
        assert np.array_equal(getattr(sync.state, f).numpy(),
                              getattr(worker.state, f).numpy()), f
    for app in apps:
        app.close()


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_a_repack_with_boxcars_recorded(async_dispatch):
    """Docs repacked while each has a boxcar recorded and not packed: on
    the async lane ``close`` repacks what the worker handed over (the
    caller's thread, the worker gone); on the sync lane the repack is
    called as a wave's check calls it. A recorded boxcar has no arena
    start yet, so the next pack appends it to the rebuilt arena: the farm
    ends as one that packed it before the repack, state and arenas, and
    takes the rest of the stream to the reference's text."""
    streams = _long_streams()
    half = 30
    farms = {}
    for order in ("pack_first", "repack_first"):
        app = _farm(streams, async_dispatch=async_dispatch)
        _feed(app, streams, "array", hi=half)
        for doc, batches in streams.items():
            app.ingest_array_batch("t", doc, batches[half])
        slots = np.array(sorted(app._pending), np.int64)
        assert len(slots) == len(streams)
        if order == "pack_first":
            app._pack()
        repacks = int(app.doc_repacks.sum())
        if async_dispatch:
            with app._lock:
                app._repack_slots |= set(slots.tolist())
            app.close()
        else:
            with app._on_streams():
                app._bound[slots] = app._repack(slots, {})
        assert int(app.doc_repacks.sum()) == repacks + len(slots)
        assert bool(app._pending) == (order == "repack_first")
        app.flush()
        farms[order] = app
    first, later = farms["pack_first"], farms["repack_first"]
    for f in FIELDS:
        assert np.array_equal(getattr(first.state, f).numpy(),
                              getattr(later.state, f).numpy()), f
    assert [a.text() for a in first.arenas] == \
        [a.text() for a in later.arenas]
    for app in (first, later):
        _feed(app, streams, "array", lo=half + 1)
        assert _differing(app, streams) == []
        assert app.host_escalations == 0
        app.close()


def test_a_lagging_client_still_escalates():
    """A client that joined and never sent holds every doc's msn at its
    join: nothing settles, a repack cannot shrink the doc, the kernel's
    flag sends it to the host, and the counters say so. Every op is
    applied once, on the card or on the host replica."""
    streams = {"doc0": _stream(0, clients=2, rounds=60, boxcar=4,
                               lagging=True),
               "doc1": _stream(1, clients=2, rounds=60, boxcar=4)}
    app = _farm(streams)
    _feed(app, streams, "array")
    assert _differing(app, streams) == []
    assert app.host_escalations == 1 and app.repack_escalations == 1
    assert app._doc_keys[next(iter(app._host_docs))] == ("t", "doc0")
    assert app.doc_repacks[app.slot_of("t", "doc1")] > 0
    total = sum(b.n for s in streams.values() for b in s)
    assert app.ops_applied + app.host_ops_applied == total
    assert app.host_ops_applied > 0
    app.close()


def test_a_repacked_farms_checkpoint_round_trips(tmp_path):
    streams = _long_streams()
    app = _farm(streams)
    _feed(app, streams, "array", hi=40)
    assert int(app.doc_repacks.sum()) > 0
    path = str(tmp_path / "farm")
    save_applier_checkpoint(app, path)
    back = load_applier_checkpoint(path, device="cpu",
                                   ops_per_dispatch=SMALL["ops_per_dispatch"])
    back.set_replay_source(app._replay_log)
    for f in FIELDS:
        assert np.array_equal(getattr(app.state, f).numpy(),
                              getattr(back.state, f).numpy()), f
    assert [a.text() for a in app.arenas] == [a.text() for a in back.arenas]
    assert _differing(back, streams, upto=40) == []
    for farm in (app, back):
        _feed(farm, streams, "array", lo=40)
        assert _differing(farm, streams) == []
        assert farm.host_escalations == 0
    assert int(back.doc_repacks.sum()) > 0
    app.close()
    back.close()


def test_a_farm_too_narrow_to_repack_escalates():
    """At S ≤ 4K the farm has no room to repack into: a doc that
    outgrows S goes to the host as it always did."""
    streams = {"doc0": _stream(3, clients=2, rounds=20, boxcar=4)}
    app = _farm(streams, max_slots=16, ops_per_dispatch=4)
    _feed(app, streams, "array")
    assert int(app.doc_repacks.sum()) == 0 and app.host_escalations == 1
    assert app.repack_escalations == 0
    assert _differing(app, streams) == []
    app.close()


def test_a_repack_keeps_the_rows_of_a_wave_in_flight():
    """A doc repacked before a wave that holds several of its boxcars:
    the inserts of that wave and of the rows still staged keep pointing
    at their text in the rebuilt arena."""
    streams = _long_streams(n_docs=2)
    app = _farm(streams)
    _feed(app, streams, "array", flush_every=16)
    assert int(app.doc_repacks.sum()) > 0
    assert _differing(app, streams) == []
    app.close()


def test_the_merge_leaves_a_fresh_state_unchanged():
    """An empty farm's rows come out as they went in."""
    state = DocState.empty(2, 8, device="cpu")
    rows = {f: getattr(state, f).numpy().copy() for f in FIELDS[:-1]}
    merged = merge_settled_runs(copy.deepcopy(rows), np.zeros(2))
    assert merged["count"].tolist() == [0, 0]
    for f in FIELDS[:-1]:
        if f != "text_start":
            assert np.array_equal(merged[f], rows[f]), f
