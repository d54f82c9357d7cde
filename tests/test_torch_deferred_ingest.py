"""The farm's deferred array ingest (``GpuDocumentApplier``, device="cpu").

``ingest_array_batch`` records each boxcar by reference and the next
flush does every recorded boxcar's bookkeeping (coverage, clients, text
arena, property ids) and packs its op rows in one columnar pass
(``_pack``). The port is held against the JAX package's
``TpuDocumentApplier``, which does all of that as each boxcar is
ingested, fed the same calls, against the port's own dict lane fed the
same stream, and against the scalar merge-tree oracle: the two lanes
interleaved on one doc within a flush, reads of docs whose boxcars are
only recorded, escalation of a doc with recorded boxcars, the async farm,
a checkpoint taken and one loaded with boxcars recorded, and the packed
rows byte for byte against each boxcar's bookkeeping and pack made on
its own at its arrival.
"""

import copy
import threading
from dataclasses import replace

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.tpu_applier import TpuDocumentApplier
from fluidframework_tpu.service.tpu_applier import (
    load_applier_checkpoint as jax_load_applier_checkpoint,
)
from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
from fluidframework_tpu_torch.ops.apply import (
    F_CLIENT,
    F_END,
    F_KEY,
    F_MSN,
    F_POS,
    F_REFSEQ,
    F_SEQ,
    F_TLEN,
    F_TSTART,
    F_TYPE,
    F_VAL,
    NO_VAL,
    OP_FIELDS,
    OP_INSERT,
)
from fluidframework_tpu_torch.ops.doc_state import FIELDS, PropTable
from fluidframework_tpu_torch.ops.opgen import generate_doc_ops
from fluidframework_tpu_torch.service.array_batch import (
    ArrayBoxcar,
    SequencedArrayBatch,
)
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    load_applier_checkpoint,
    save_applier_checkpoint,
)
from fluidframework_tpu_torch.testing.streams import array_batches

GEOMETRY = dict(max_docs=8, max_slots=128, ops_per_dispatch=8)
N_DOCS = 5
SEEDS = (1, 9)
# which lane each boxcar takes: k is the boxcar's index within its doc
LANES = {
    "array": lambda d, k: "array",
    "alternate": lambda d, k: "dict" if (d + k) % 2 else "array",
    "dict_first": lambda d, k: "dict" if k == 0 else "array",
}


def _streams(seed: int) -> dict:
    """{doc: [SequencedArrayBatch]} of opgen docs in boxcars of at most
    four ops; doc0's first annotate carries two keys, so the array lane
    hands its boxcar to the dict lane."""
    rng = np.random.default_rng(seed)
    texts = np.random.default_rng(seed + 100)
    out = {}
    for d in range(N_DOCS):
        rows, _, _ = generate_doc_ops(rng, 36 + 6 * d, remove_fraction=0.35,
                                      annotate_fraction=0.2, max_insert=6)
        out[f"doc{d}"] = array_batches(rows, texts, "t", f"doc{d}",
                                       max_boxcar=4)
    for batch in out["doc0"]:
        props = batch.boxcar.props
        if props is not None:
            i = next(i for i, p in enumerate(props) if p)
            props[i] = {**props[i], "wide": 1}
            break
    else:
        raise AssertionError("doc0 has no annotate")
    return out


def _pairs(batch) -> list:
    """A boxcar as the dict lane's (message, wire op) pairs."""
    out = []
    for i in range(batch.n):
        wire = batch.boxcar.wire_op(i)
        out.append((replace(batch.message(i), contents=wire), wire))
    return out


def _log(streams: dict) -> dict:
    return {doc: [m for b in batches for m, _ in _pairs(b)]
            for doc, batches in streams.items()}


def _farms(streams: dict, **kw):
    """A port farm and a JAX farm with the streams' log as replay
    source."""
    log = _log(streams)
    port = GpuDocumentApplier(device="cpu", **{**GEOMETRY, **kw})
    jax_kw = {k: v for k, v in kw.items() if k != "async_dispatch"}
    jax_app = TpuDocumentApplier(kernel="xla", **{**GEOMETRY, **jax_kw})
    for app in (port, jax_app):
        app.set_replay_source(lambda t, d: log[d])
    return port, jax_app


def _calls(streams: dict, lanes) -> list:
    """The ingest calls, docs round-robin: (lane, doc, batch)."""
    order = list(streams)
    calls = []
    for k in range(max(len(b) for b in streams.values())):
        for d, doc in enumerate(order):
            if k < len(streams[doc]):
                calls.append((lanes(d, k), doc, streams[doc][k]))
    return calls


def _feed(apps, calls, flush_every=None) -> None:
    for n, (lane, doc, batch) in enumerate(calls, 1):
        for app in apps:
            if lane == "array":
                app.ingest_array_batch("t", doc, batch)
            else:
                app.ingest_batch("t", doc, _pairs(batch))
            if flush_every and n % flush_every == 0:
                app.flush()


def _oracle(msgs: list) -> MergeTreeClient:
    oracle = MergeTreeClient("oracle")
    for m in msgs:
        oracle.apply_msg(m, local=False)
    return oracle


def _assert_same(port, jax_app, streams, waves=True,
                 counters=True) -> None:
    """Every doc's text and properties equal the JAX farm's and the
    oracle's; the farms' states, property tables and counters (waves:
    also ``dispatches``) agree; the port has nothing left recorded or
    staged."""
    for doc, msgs in _log(streams).items():
        oracle = _oracle(msgs)
        text = port.get_text("t", doc)
        assert text == jax_app.get_text("t", doc) == oracle.get_text(), doc
        for pos in range(0, len(text), 2):
            assert port.get_properties_at("t", doc, pos) == \
                jax_app.get_properties_at("t", doc, pos) == \
                oracle.get_properties_at(pos), (doc, pos)
        assert port.applied_seq("t", doc) == jax_app.applied_seq("t", doc)
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(port.state, f).numpy(),
            np.asarray(getattr(jax_app.state, f)), err_msg=f)
    assert port.prop_table.snapshot() == jax_app.prop_table.snapshot()
    if counters:
        assert port.host_escalations == jax_app.host_escalations
        assert port.ops_applied == jax_app.ops_applied
    if counters and waves:
        assert port.dispatches == jax_app.dispatches > 0
    assert not port._pending and not port._staged
    assert port._staged_ops == 0


def _rows(chunks) -> np.ndarray:
    return np.concatenate(chunks) if chunks else np.zeros((0, OP_FIELDS),
                                                          np.int32)


def _pack_each(app, pending: dict, arrivals: list) -> dict:
    """The loop reference: each recorded boxcar's bookkeeping and rows
    made on its own at its arrival, on copies of the farm's client
    tables, arena lengths and property table: clients and text a doc,
    property ids in global arrival order. A boxcar with an annotate of
    other than one key gets the dict lane's rows (one a key, no text
    start off an insert). Returns {slot: rows}."""
    tables = copy.deepcopy(app._client_ids)
    lengths = {slot: len(app.arenas[slot].text()) for slot in pending}
    props = PropTable.load(app.prop_table.snapshot())
    boxcars = {slot: iter(group) for slot, group in pending.items()}
    rows = {slot: [] for slot in pending}
    for slot in arrivals:
        batch = next(boxcars[slot])
        box = batch.boxcar
        table = tables.setdefault(slot, {})
        client = table.setdefault(box.client_id, len(table))
        start = lengths[slot]
        lengths[slot] += len(box.text)
        off = np.asarray(box.text_off)
        per_op = any(box.kind[i] == 2 and len(box.props[i]) != 1
                     for i in range(batch.n))
        for i in range(batch.n):
            kind = int(box.kind[i])
            row = [0] * OP_FIELDS
            row[F_TYPE] = kind + 1
            row[F_POS] = int(box.a[i])
            row[F_END] = int(box.b[i])
            row[F_SEQ] = batch.base_seq + i
            row[F_REFSEQ] = int(box.rseq[i])
            row[F_CLIENT] = client
            row[F_MSN] = int(batch.msns[i])
            row[F_TLEN] = int(off[i + 1] - off[i])
            if kind == 0 or not per_op:
                row[F_TSTART] = start + int(off[i])
            if kind != 2:
                rows[slot].append(row)
                continue
            for k, v in box.props[i].items():
                row = list(row)
                row[F_KEY] = props.intern_key(k)
                row[F_VAL] = NO_VAL if v is None else props.intern_val(v)
                rows[slot].append(row)
    return {slot: np.array(r, np.int32).reshape(-1, OP_FIELDS)
            for slot, r in rows.items()}


# ------------------------------------------------------------- the lanes


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lanes", sorted(LANES))
def test_lanes_interleaved_in_one_flush_match_jax(seed, lanes):
    """Array and dict lane boxcars of one doc interleaved inside one
    flush (the two-key annotate falls back to the dict lane): each doc's
    rows keep arrival order across both lanes."""
    streams = _streams(seed)
    port, jax_app = _farms(streams)
    _feed((port, jax_app), _calls(streams, LANES[lanes]))
    for app in (port, jax_app):
        app.finalize()
    _assert_same(port, jax_app, streams)


@pytest.mark.parametrize("lanes", sorted(LANES))
def test_packed_rows_equal_a_per_boxcar_pack(lanes):
    """The flush's columnar pass stages, doc by doc, the very rows a pack
    of each boxcar on its own stages (the JAX farm's, made at ingest, and
    the loop reference's over the recorded boxcars), byte for byte."""
    streams = _streams(SEEDS[0])
    port, jax_app = _farms(streams)
    calls = _calls(streams, LANES[lanes])
    _feed((port, jax_app), calls)
    recorded = {slot: list(group) for slot, group in port._pending.items()}
    assert recorded
    reference = _pack_each(port, recorded, list(port._arrivals))
    staged_before = {slot: _rows(c) for slot, c in port._staged.items()}
    port._pack()
    assert not port._pending
    assert set(port._staged) == set(jax_app._staged)
    total = 0
    for slot, chunks in port._staged.items():
        got = _rows(chunks)
        want = _rows(jax_app._staged[slot])
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes(), slot
        total += len(got)
        if slot in recorded:
            # the pass's rows for this slot follow what the slot staged
            # before it, and equal the loop reference
            before = staged_before.get(slot, _rows([]))
            assert got[:len(before)].tobytes() == before.tobytes()
            assert got[len(before):].tobytes() == reference[slot].tobytes()
    assert port._staged_ops == jax_app._staged_ops == total
    for app in (port, jax_app):
        app.finalize()
    _assert_same(port, jax_app, streams)


# --------------------------------------------------------------- reads


@pytest.mark.parametrize("read", ["get_text", "get_tree",
                                  "get_properties_at", "applied_seq",
                                  "slot_count"])
def test_reads_of_a_doc_whose_boxcars_are_only_recorded(read):
    """A doc whose boxcars are only recorded reads as the JAX farm's,
    whose rows were staged at ingest: the reads that flush first flush
    the recorded boxcars too."""
    streams = _streams(SEEDS[1])
    port, jax_app = _farms(streams)
    head = {**streams, "doc1": streams["doc1"][:-2]}
    _feed((port, jax_app), _calls(head, LANES["array"]), flush_every=7)
    for app in (port, jax_app):
        app.flush()
    _feed((port, jax_app), [("array", "doc1", b)
                            for b in streams["doc1"][-2:]])
    slot = port.slot_of("t", "doc1")
    assert list(port._pending) == [slot] and not port._staged
    assert port.dispatches == jax_app.dispatches
    if read == "get_text":
        assert port.get_text("t", "doc1") == jax_app.get_text("t", "doc1")
    elif read == "get_tree":
        assert port.get_tree("t", "doc1").get_text() == \
            jax_app.get_tree("t", "doc1").get_text()
    elif read == "get_properties_at":
        assert port.get_properties_at("t", "doc1", 0) == \
            jax_app.get_properties_at("t", "doc1", 0)
    elif read == "applied_seq":
        for doc, batches in streams.items():
            assert port.applied_seq("t", doc) == \
                jax_app.applied_seq("t", doc) == batches[-1].last_seq
            assert port.first_seq("t", doc) == jax_app.first_seq("t", doc)
    else:
        for doc in streams:
            assert port.slot_count("t", doc) == jax_app.slot_count("t", doc)
    if read in ("get_text", "get_tree", "get_properties_at"):
        # the read flushed: nothing recorded, and the same waves
        assert not port._pending and port._staged_ops == 0
        assert port.dispatches == jax_app.dispatches
    for app in (port, jax_app):
        app.finalize()
    _assert_same(port, jax_app, streams)


# ----------------------------------------------------------- escalation


class _Plane:
    """Answers ``escalate_host`` at the first ingest consultation for
    ``slot``; records every consultation."""

    def __init__(self, slot: int):
        self.slot = slot
        self.calls = []
        self.fired = False

    def __call__(self, seam, **info):
        self.calls.append((seam, info))
        if not self.fired and seam == "applier.ingest" \
                and info.get("slot") == self.slot:
            self.fired = True
            return "escalate_host"
        return None


def test_escalate_host_drops_the_docs_recorded_boxcars():
    """The fault plane escalates doc2 at a dict-lane batch while doc2 has
    array boxcars recorded: they are dropped (the replay holds them), the
    staged-row count stays exact, and both farms consult the plane at the
    same seams in the same order."""
    streams = _streams(SEEDS[0])
    port, jax_app = _farms(streams)
    slot = port.slot_of("t", "doc2")
    assert jax_app.slot_of("t", "doc2") == slot
    port.fault_plane, jax_app.fault_plane = _Plane(slot), _Plane(slot)

    def lanes(d, k):
        return "dict" if (d, k) == (2, 3) else "array"

    calls = _calls(streams, lanes)
    cut = calls.index(("dict", "doc2", streams["doc2"][3]))
    _feed((port, jax_app), calls[:cut])
    assert slot in port._pending
    _feed((port, jax_app), calls[cut:cut + 1])
    assert port.host_escalations == jax_app.host_escalations == 1
    assert slot not in port._pending and slot not in port._staged
    assert port._staged_ops == sum(len(c) for chunks in port._staged.values()
                                   for c in chunks)
    _feed((port, jax_app), calls[cut + 1:])
    for app in (port, jax_app):
        app.finalize()
    _assert_same(port, jax_app, streams)
    assert port.fault_plane.calls == jax_app.fault_plane.calls


def _box(client: str, base_seq: int, ops: list) -> SequencedArrayBatch:
    """A boxcar of ("ins", pos, text), ("rem", start, end) and ("ann",
    start, end, props) ops, sequenced from ``base_seq``."""
    kind, a, b, props, texts, off = [], [], [], [], [], [0]
    for op in ops:
        kind.append({"ins": 0, "rem": 1, "ann": 2}[op[0]])
        a.append(op[1])
        b.append(0 if op[0] == "ins" else op[2])
        text = op[2] if op[0] == "ins" else ""
        texts.append(text)
        off.append(off[-1] + len(text))
        props.append(op[3] if op[0] == "ann" else None)
    n = len(ops)
    box = ArrayBoxcar(
        tenant_id="t", document_id="", client_id=client, ds_id="default",
        channel_id="text", kind=np.array(kind, np.int8),
        a=np.array(a, np.int32), b=np.array(b, np.int32),
        cseq=np.arange(base_seq, base_seq + n, dtype=np.int32),
        rseq=np.full(n, base_seq - 1, np.int32), text="".join(texts),
        text_off=np.array(off, np.int32), props=props)
    return SequencedArrayBatch(boxcar=box, base_seq=base_seq,
                               msns=np.zeros(n, np.int64), timestamp=0.0)


def test_prop_table_overflow_escalates_a_doc_with_recorded_boxcars():
    """A flush overflows doc "hot"'s device property table (nine keys on
    one character) with the poll deferred; then "hot" records more
    boxcars, and a read of another doc polls, escalates "hot" and drops
    them. Both farms end on the oracle's text and properties."""
    hot = [_box("a", 1, [("ins", 0, "xyz")]),
           _box("a", 2, [("ann", 0, 1, {f"key{k}": k}) for k in range(5)]),
           _box("a", 7, [("ann", 0, 1, {f"key{k}": k}) for k in range(5, 9)])]
    tail = [_box("a", 11, [("ins", 3, "uv"), ("ann", 1, 2, {"late": 1})]),
            _box("a", 13, [("rem", 2, 3), ("ins", 0, "w")])]
    cold = [_box("b", 1, [("ins", 0, "cold")])]
    streams = {"hot": hot + tail, "cold": cold}
    port, jax_app = _farms(streams, overflow_check_every=1000)
    calls = ([("array", "hot", b) for b in hot]
             + [("array", "cold", b) for b in cold])
    _feed((port, jax_app), calls)
    for app in (port, jax_app):
        app.flush()
    assert port.host_escalations == jax_app.host_escalations == 0
    _feed((port, jax_app), [("array", "hot", b) for b in tail])
    slot = port.slot_of("t", "hot")
    assert len(port._pending[slot]) == 2
    assert port.get_text("t", "cold") == jax_app.get_text("t", "cold") \
        == "cold"
    assert port.host_escalations == jax_app.host_escalations == 1
    assert slot in port._host_docs
    assert not port._pending and port._staged_ops == 0
    for app in (port, jax_app):
        app.finalize()
    _assert_same(port, jax_app, streams)
    assert port.get_text("t", "hot") == "wxyuv"
    assert port.get_properties_at("t", "hot", 1) == {
        f"key{k}": k for k in range(9)}
    assert port.get_properties_at("t", "hot", 2) == {"late": 1}


def _unread_starts_zeroed(rows: np.ndarray) -> np.ndarray:
    """Rows with a non-insert's text start zeroed: nothing reads it (a
    wave packs it as 0, ``ops/apply.pack_wave_rows``); the array lane
    leaves its boxcar's text offset there, the dict lane 0."""
    rows = rows.copy()
    rows[rows[:, F_TYPE] != OP_INSERT, F_TSTART] = 0
    return rows


@pytest.mark.parametrize("two_keys", [False, True])
def test_array_lane_equals_dict_lane_and_jax(two_keys):
    """One stream fed to three farms: the port's array lane (recorded,
    then packed at the flush), the port's dict lane (the stream's
    materialised pairs, staged at ingest) and the JAX farm's array lane
    (packed at ingest). Docs interleave; client "z" appears mid-stream;
    keys and values are first seen on one doc and then on another, so
    only global arrival order gives the ids; (two_keys) doc A has a
    two-key annotate between single-key ones; doc H went to the host
    earlier and takes its boxcars there. After the pack the staged rows,
    arenas, client tables, property table and coverage are the JAX
    farm's byte for byte and the dict lane's (a non-insert's unread text
    start aside), and every doc ends on the oracle's text and props."""
    hot = [_box("h", 1, [("ins", 0, "xyz")]),
           _box("h", 2, [("ann", 0, 1, {f"key{k}": k}) for k in range(5)]),
           _box("h", 7, [("ann", 0, 1, {f"key{k}": k}) for k in range(5, 9)])]
    middle = {"kc": 1, "kd": None} if two_keys else {"kc": 1}
    calls = [
        ("A", _box("a", 1, [("ins", 0, "hello")])),
        ("B", _box("b", 1, [("ins", 0, "world"), ("rem", 1, 2)])),
        ("B", _box("b", 3, [("ann", 0, 2, {"kb": "vb"})])),
        ("H", _box("h", 11, [("ins", 1, "uv"), ("ann", 0, 2, {"late": 1})])),
        ("A", _box("a", 2, [("ann", 1, 3, {"ka": "va"}), ("ins", 0, "x")])),
        ("C", _box("c", 1, [("ins", 0, "abc"), ("ann", 0, 1, {"kb": 7})])),
        ("A", _box("z", 4, [("ann", 0, 2, middle), ("rem", 3, 4)])),
        ("C", _box("z", 3, [("ann", 1, 3, {"ke": [1, 2]})])),
        ("A", _box("a", 6, [("ann", 0, 1, {"ka": 7}), ("ins", 2, "yy")])),
        ("H", _box("h", 13, [("rem", 2, 3), ("ins", 0, "w")])),
        ("B", _box("b", 4, [("ann", 0, 1, {"kf": "vb"}), ("ins", 4, "!")])),
        ("C", _box("c", 4, [("ins", 1, "q"), ("ann", 0, 4, {"kg": "vg"})])),
    ]
    streams = {"H": hot + [b for doc, b in calls if doc == "H"]}
    for doc, b in calls:
        streams.setdefault(doc, []).append(b)
    array_farm, jax_app = _farms(streams)
    dict_farm = _farms(streams)[0]
    feeds = ((array_farm, "array"), (dict_farm, "dict"), (jax_app, "array"))
    for app, lane in feeds:
        _feed((app,), [(lane, "H", b) for b in hot])
        app.finalize()
        assert app.host_escalations == 1
    for app, lane in feeds:
        _feed((app,), [(lane, doc, b) for doc, b in calls])
    host = array_farm.slot_of("t", "H")
    assert host in array_farm._host_docs and host not in array_farm._pending
    assert len(array_farm._arrivals) == len(calls) - 2

    def same_coverage(other):
        for doc in streams:
            for read in ("applied_seq", "first_seq"):
                assert getattr(array_farm, read)("t", doc) == \
                    getattr(other, read)("t", doc), (doc, read)

    # docs A, B and C have nothing but recorded boxcars yet
    same_coverage(jax_app)
    array_farm._pack()
    assert not array_farm._pending and not array_farm._arrivals
    for other in (dict_farm, jax_app):
        assert set(array_farm._staged) == set(other._staged)
        for slot, chunks in array_farm._staged.items():
            got, want = _rows(chunks), _rows(other._staged[slot])
            if other is dict_farm:
                got, want = _unread_starts_zeroed(got), \
                    _unread_starts_zeroed(want)
            assert got.tobytes() == want.tobytes(), slot
        assert [a.text() for a in array_farm.arenas] == \
            [a.text() for a in other.arenas]
        assert array_farm._client_ids == other._client_ids
        assert array_farm.prop_table.snapshot() == \
            other.prop_table.snapshot()
        same_coverage(other)
    # "z" arrived after "a" on doc A; the keys in their first arrival
    assert array_farm._client_ids[array_farm.slot_of("t", "A")] == {
        "a": 0, "z": 1}
    keys = array_farm.prop_table.snapshot()["keys"]
    assert keys[keys.index("kb"):] == (
        ["kb", "ka", "kc"] + ["kd"] * two_keys + ["ke", "kf", "kg"])
    for app in (array_farm, dict_farm, jax_app):
        app.finalize()
    _assert_same(array_farm, jax_app, streams)
    _assert_same(dict_farm, jax_app, streams)


# ----------------------------------------------------------- async farm


@pytest.mark.parametrize("min_wave", [0, 48, 10**6])
def test_async_farm_packs_at_flush_and_finalize(min_wave):
    """The async farm: recorded rows are invisible to the worker until a
    flush packs them on the caller's thread; ``finalize`` packs and
    drains without waiting on recorded rows; ``close`` then leaves an
    inline farm that packs at its next flush."""
    streams = _streams(SEEDS[1])
    port, jax_app = _farms(streams, async_dispatch=True,
                           min_wave_ops=min_wave)
    try:
        # three array boxcars a doc, then the lanes alternate; each doc's
        # last boxcar comes at the end, on the array lane
        calls = _calls({doc: b[:-1] for doc, b in streams.items()},
                       lambda d, k: "array" if k < 3
                       else LANES["alternate"](d, k))
        last = [("array", doc, b[-1]) for doc, b in streams.items()]
        head = 3 * N_DOCS
        _feed((port, jax_app), calls[:head])
        assert all(c[0] == "array" for c in calls[:head])
        # recorded, and so invisible to the worker
        assert len(port._pending) == N_DOCS
        assert port._staged_ops == 0 and port.dispatches == 0
        # a flush packs them on the caller's thread before the worker
        # wakes; held back by min_wave, they wait as staged rows
        rows = sum(b.n for _lane, _doc, b in calls[:head])
        for app in (port, jax_app):
            app.flush()
        assert not port._pending
        if min_wave > rows:
            assert port._staged_ops == rows and port.dispatches == 0
        rest = calls[head:]
        cut = len(rest) // 2
        _feed((port, jax_app), rest[:cut], flush_every=5)
        _feed((port, jax_app), rest[cut:] + last)
        assert len(port._pending) == N_DOCS
        done = threading.Event()
        errors = []

        def finalize():
            try:
                port.finalize()
            except BaseException as exc:  # noqa: BLE001 — asserted below
                errors.append(exc)
            done.set()

        worker = threading.Thread(target=finalize, daemon=True)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive() and done.is_set() and not errors
        jax_app.finalize()
        _assert_same(port, jax_app, streams, waves=False)
        port.close()
        assert not port._async
        more = [_box("z", 1, [("ins", 0, "after"), ("rem", 0, 2)])]
        _feed((port,), [("array", "late", b) for b in more])
        assert port._pending
        port.flush()
        assert not port._pending
        assert port.get_text("t", "late") == "ter"
    finally:
        port.close()


# ----------------------------------------------------------- checkpoint


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_checkpoint_with_boxcars_recorded(tmp_path, async_dispatch):
    """``save_applier_checkpoint`` with boxcars recorded saves them
    applied (its ``finalize`` packs them); the loaded farm takes the rest
    of the stream and ends as a JAX farm fed it all. With the loaded
    farm's first boxcars only recorded, its coverage and restart window
    read as those of the JAX farm loaded from the same files."""
    streams = _streams(SEEDS[0])
    port, jax_app = _farms(streams, async_dispatch=async_dispatch)
    # a dict-lane boxcar opens each doc; the ones before the cut are
    # array boxcars, left recorded
    calls = _calls(streams, LANES["dict_first"])
    half = len(calls) // 2 + (len(calls) // 2 % 4 == 0)
    assert calls[half - 1][0] == "array"
    try:
        _feed((port, jax_app), calls[:half], flush_every=4)
        assert port._pending
        save_applier_checkpoint(port, str(tmp_path / "farm"))
        assert not port._pending
    finally:
        port.close()
    log = _log(streams)
    loaded = load_applier_checkpoint(str(tmp_path / "farm"), device="cpu")
    jax_loaded = jax_load_applier_checkpoint(str(tmp_path / "farm"),
                                             kernel="xla")
    for app in (loaded, jax_loaded):
        app.set_replay_source(lambda t, d: log[d])
    cut = half + N_DOCS + 1
    _feed((loaded, jax_app, jax_loaded), calls[half:cut])
    assert loaded._pending
    for doc in streams:
        for read in ("applied_seq", "first_seq", "restore_gap"):
            assert getattr(loaded, read)("t", doc) == \
                getattr(jax_loaded, read)("t", doc), (doc, read)
    assert any(loaded.restore_gap("t", doc)[1] is not None
               for doc in streams)
    _feed((loaded, jax_app, jax_loaded), calls[cut:])
    for app in (loaded, jax_app, jax_loaded):
        app.finalize()
    _assert_same(loaded, jax_app, streams, counters=False)


# ------------------------------------------------------ property values


@pytest.mark.parametrize("values", [
    [1, True, 1, "1", 0, False, 0.0, -0.0, 0, "x", True],
    [{"a": 1}, 2, [1, 2], 2, {"a": 1}, "é", "é", 2.5, 2.5, 7],
])
def test_value_ids_equal_the_tables(values):
    """The ingest's memo of scalar values answers the ids the property
    table gives the same values in the same order (1, True and "1", 0.0
    and -0.0 each their own); swapping the table starts a new memo."""
    from fluidframework_tpu_torch.ops.doc_state import PropTable

    app = GpuDocumentApplier(device="cpu", max_docs=2, max_slots=8,
                             ops_per_dispatch=4)
    table = PropTable()
    assert [app._intern_val(v) for v in values] == \
        [table.intern_val(v) for v in values]
    assert app.prop_table.snapshot() == table.snapshot()
    app.prop_table = PropTable.load({"keys": [], "vals": ["x", 1]})
    assert [app._intern_val(v) for v in (1, "x", True)] == [1, 0, 2]
