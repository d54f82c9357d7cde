"""Farm checkpoints of the port against the JAX package's, on the CPU.

``service/gpu_applier.py::save_applier_checkpoint`` and
``load_applier_checkpoint`` keep the JAX package's format: the same
``.json`` keys, the same ``.npz`` members (int32, ``overflow`` bool), the
alternating ``.g0``/``.g1`` generations and the legacy single ``.npz``.
These tests load the committed golden checkpoint into the port, move
checkpoints both ways between the packages (every doc's text, properties,
applied and first seqs, anchors and restore windows must agree, and what
each package writes back must be equal member by member), and check the
crash-atomic generations, a warm restart that keeps ingesting the live
stream, the restore window across a save/load/save/load cycle, and that a
checkpoint of a failed async applier raises before writing.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.load_gen import run_inproc as jax_run_inproc
from fluidframework_tpu.service.tpu_applier import TpuDocumentApplier
from fluidframework_tpu.service.tpu_applier import (
    load_applier_checkpoint as jax_load,
)
from fluidframework_tpu.service.tpu_applier import (
    save_applier_checkpoint as jax_save,
)
from fluidframework_tpu_torch.protocol.messages import (
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    channel_stream,
    load_applier_checkpoint,
    save_applier_checkpoint,
)
from fluidframework_tpu_torch.service.load_gen import run_inproc
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.synthetic import (
    CHANNEL_ID,
    DS_ID,
    SyntheticEditor,
)
from tests.test_torch_applier import _to_port

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
RUN = dict(n_docs=8, clients_per_doc=2, ops_per_client=24, batch_size=8,
           flush_every=64)
GEOMETRY = dict(max_docs=8, max_slots=256, ops_per_dispatch=8)
DOCS = [f"doc{d}" for d in range(RUN["n_docs"])]


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLDEN, "expected.json")) as fh:
        return json.load(fh)


def _golden(tmp_path, meta_edit=None) -> str:
    shutil.copy(os.path.join(GOLDEN, "applier_ckpt.npz"),
                str(tmp_path / "applier_ckpt.npz"))
    with open(os.path.join(GOLDEN, "applier_ckpt.json")) as fh:
        meta = json.load(fh)
    if meta_edit is not None:
        meta_edit(meta)
    with open(str(tmp_path / "applier_ckpt.json"), "w") as fh:
        json.dump(meta, fh)
    return str(tmp_path / "applier_ckpt")


def test_golden_checkpoint_loads(tmp_path, expected):
    applier = load_applier_checkpoint(_golden(tmp_path), device="cpu",
                                      ops_per_dispatch=8)
    assert applier.get_text("t", "ckdoc") == expected["ckpt_text"]
    assert applier.applied_seq("t", "ckdoc") == expected["ckpt_applied_seq"]
    assert applier.get_properties_at("t", "ckdoc", 0).get("em") is True


def test_golden_checkpoint_loads_legacy_meta(tmp_path, expected):
    """Without the coverage keys the doc restores unanchored with an
    unknown applied seq: the summarizer refuses until coverage is proven."""

    def drop(meta):
        for key in ("applied_seq", "first_seq", "anchored"):
            meta.pop(key, None)

    applier = load_applier_checkpoint(_golden(tmp_path, drop), device="cpu",
                                      ops_per_dispatch=8)
    assert applier.get_text("t", "ckdoc") == expected["ckpt_text"]
    assert applier.applied_seq("t", "ckdoc") == 0
    assert not applier.is_anchored("t", "ckdoc")


# ------------------------------------------------ across the two packages

def _msg(cls, mtype, seq: int, contents: dict):
    return cls(client_id="annotator", sequence_number=seq,
               minimum_sequence_number=0, client_sequence_number=1,
               reference_sequence_number=seq - 1, type=mtype,
               contents=contents)


def _source_checkpoint(writer: str, seed: int, tmp_path) -> str:
    """A checkpoint written by ``writer``'s package after a run_inproc of
    ``seed``, with a property, an anchor, and restore windows in it (it is
    the second save of a save/load cycle)."""
    if writer == "port":
        app = GpuDocumentApplier(device="cpu", **GEOMETRY)
        run_inproc(seed=seed, array_lane=True, applier=app, **RUN)
        msg_cls, mtype = SequencedDocumentMessage, MessageType.OPERATION
        save, load, kw = save_applier_checkpoint, load_applier_checkpoint, \
            {"device": "cpu"}
    else:
        from fluidframework_tpu.protocol.messages import (
            MessageType as JaxMessageType,
        )
        from fluidframework_tpu.protocol.messages import (
            SequencedDocumentMessage as JaxMessage,
        )

        app = TpuDocumentApplier(kernel="xla", **GEOMETRY)
        jax_run_inproc(seed=seed, array_lane=True, applier=app, **RUN)
        msg_cls, mtype = JaxMessage, JaxMessageType.OPERATION
        save, load, kw = jax_save, jax_load, {"kernel": "xla"}
    seq = app.applied_seq("bench", "doc0") + 1
    app.ingest("bench", "doc0", _msg(msg_cls, mtype, seq, {}),
               {"type": 2, "start": 0, "end": 1, "props": {"bold": True}})
    app.mark_anchored("bench", "doc1")
    app.mark_anchored("bench", "doc2")
    first = str(tmp_path / f"{writer}-first")
    save(app, first)
    again = load(first, **kw)
    again.mark_anchored("bench", "doc2")  # discharges doc2's window
    for doc in ("doc1", "doc2"):  # both move past the first save
        seq = again.applied_seq("bench", doc) + 1
        again.ingest("bench", doc, _msg(msg_cls, mtype, seq, {}),
                     {"type": 2, "start": 0, "end": 1, "props": {"em": 1}})
    second = str(tmp_path / f"{writer}-second")
    save(again, second)
    return second


def _doc_view(app, doc: str) -> tuple:
    text = app.get_text("bench", doc)
    props = app.get_properties_at("bench", doc, 0) if text else None
    return (text, props, app.applied_seq("bench", doc),
            app.first_seq("bench", doc), app.is_anchored("bench", doc),
            app.restore_gap("bench", doc))


def _files(path: str) -> tuple[dict, dict]:
    with open(path + ".json") as fh:
        meta = json.load(fh)
    with np.load(f"{path}.g{meta['gen']}.npz") as data:
        arrays = {k: data[k] for k in data.files}
    return meta, arrays


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer, seed):
    path = _source_checkpoint(writer, seed, tmp_path)
    port = load_applier_checkpoint(path, device="cpu")
    jax = jax_load(path, kernel="xla")
    views = {doc: _doc_view(jax, doc) for doc in DOCS}
    for doc in DOCS:
        assert _doc_view(port, doc) == views[doc], doc
    assert views["doc0"][1] == {"bold": True}
    # doc1's window from the first restore keeps its older low bound;
    # doc2's was discharged, so its window opens at this load
    text1, _, applied1, _, anchored1, gap1 = views["doc1"]
    assert anchored1 and gap1 == (applied1 - 1, None)
    _, _, applied2, _, anchored2, gap2 = views["doc2"]
    assert anchored2 and gap2 == (applied2, None)
    assert any(v[0] for v in views.values())
    # what each package writes back is the same checkpoint
    save_applier_checkpoint(port, str(tmp_path / "port-out"))
    jax_save(jax, str(tmp_path / "jax-out"))
    port_meta, port_arrays = _files(str(tmp_path / "port-out"))
    jax_meta, jax_arrays = _files(str(tmp_path / "jax-out"))
    assert port_meta == jax_meta
    assert list(port_arrays) == list(jax_arrays)
    for name, want in jax_arrays.items():
        got = port_arrays[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert port_arrays["overflow"].dtype == np.bool_
    assert port_arrays["length"].dtype == np.int32


def test_multi_shard_placement_loads_like_jax(tmp_path):
    """A checkpoint whose placement has two shards (rows shard-major)
    loads as the JAX applier loads it without a mesh; a doc placed after
    the load lands on the same row in both."""
    app = TpuDocumentApplier(kernel="xla", **GEOMETRY)
    jax_run_inproc(seed=3, array_lane=True, applier=app,
                   **dict(RUN, n_docs=4))
    path = str(tmp_path / "ck")
    jax_save(app, path)
    with open(path + ".json") as fh:
        meta = json.load(fh)
    half = GEOMETRY["max_docs"] // 2
    rows = meta["placement"]["map"]
    meta["placement"] = {"n_shards": 2, "slots_per_shard": half,
                         "map": {k: list(divmod(r * half + s, half))
                                 for k, (r, s) in rows.items()}}
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh)
    port = load_applier_checkpoint(path, device="cpu")
    jax = jax_load(path, kernel="xla")
    assert port.placement.n_shards == 2
    for doc in DOCS[:4]:
        assert port.get_text("bench", doc) == jax.get_text("bench", doc)
    assert port.slot_of("bench", "late") == jax.slot_of("bench", "late")


# ----------------------------------------------------- the port's own file

def _farm(seed: int, n_rounds: int = 3):
    """A port LocalServer with two synthetic editors on each of two docs."""
    server = LocalServer()
    rng = random.Random(seed)
    conns = []
    for doc in ("a", "b"):
        for _ in range(2):
            conn, editor = server.connect("t", doc), SyntheticEditor(rng)
            conn.on_ops = lambda batch, e=editor, me=conn.client_id: [
                e.observe(m) for m in batch if m.client_id != me]
            conns.append((conn, editor))

    def rounds(n):
        for _ in range(n):
            for conn, editor in conns:
                conn.submit(editor.next_ops(4))

    rounds(n_rounds)
    return server, rounds


def _feed(app, server, doc: str, after: int = 0) -> None:
    for m in channel_stream(server, "t", doc, DS_ID, CHANNEL_ID):
        if m.sequence_number > after:
            app.ingest("t", doc, m, m.contents)


def test_generations_alternate_and_tmp_never_loaded(tmp_path):
    server, rounds = _farm(1)
    app = GpuDocumentApplier(device="cpu", max_docs=4, max_slots=64,
                             ops_per_dispatch=4)
    _feed(app, server, "a")
    path = str(tmp_path / "farm")
    gens = []
    for _ in range(3):
        save_applier_checkpoint(app, path)
        with open(path + ".json") as fh:
            gens.append(json.load(fh)["gen"])
    assert gens == [0, 1, 0]
    assert sorted(os.listdir(tmp_path)) == ["farm.g0.npz", "farm.g1.npz",
                                            "farm.json"]
    text = app.get_text("t", "a")
    # a kill between the array write and the .json rename: the other
    # generation holds newer arrays and stray .tmp files lie about, but
    # the .json still names the consistent pair
    rounds(2)
    _feed(app, server, "a", after=app.applied_seq("t", "a"))
    newer = str(tmp_path / "newer")
    save_applier_checkpoint(app, newer)
    assert app.get_text("t", "a") != text
    shutil.copy(newer + ".g0.npz", path + ".g1.npz")
    for stray in (path + ".g1.npz.tmp", path + ".json.tmp"):
        with open(stray, "wb") as fh:
            fh.write(b"torn")
    loaded = load_applier_checkpoint(path, device="cpu")
    assert loaded.get_text("t", "a") == text


def test_warm_restart_keeps_ingesting(tmp_path):
    """Save a fenced farm, load it as a new (async) applier, and feed it
    the live stream where the saved one left off: no replay, no
    escalation, the same texts as an applier that never stopped."""
    server, rounds = _farm(2)
    app = GpuDocumentApplier(device="cpu", max_docs=4, max_slots=64,
                             ops_per_dispatch=4)
    app.set_replay_source(lambda t, d: [])
    for doc in ("a", "b"):
        _feed(app, server, doc)
    path = str(tmp_path / "farm")
    save_applier_checkpoint(app, path)
    revived = load_applier_checkpoint(path, device="cpu",
                                      async_dispatch=True)
    revived.set_replay_source(lambda t, d: [])
    try:
        for doc in ("a", "b"):
            assert revived.get_text("t", doc) == app.get_text("t", doc)
        seen = {doc: revived.applied_seq("t", doc) for doc in ("a", "b")}
        rounds(3)
        for doc in ("a", "b"):
            _feed(revived, server, doc, after=seen[doc])
        revived.finalize()
        assert revived.host_escalations == 0
        for doc in ("a", "b"):
            whole = GpuDocumentApplier(device="cpu", max_docs=4,
                                       max_slots=64, ops_per_dispatch=4)
            _feed(whole, server, doc)
            assert revived.get_text("t", doc) == whole.get_text("t", doc)
            assert revived.first_seq("t", doc) == whole.first_seq("t", doc)
    finally:
        revived.close()


def test_restore_window_survives_checkpoint_cycle(tmp_path):
    """A save/load cycle keeps a pending restart window's older low
    bound (the applier half of the summarizer's restart-window gate), in
    both packages alike on one stream."""
    from fluidframework_tpu.protocol.messages import (
        MessageType as JaxMessageType,
    )
    from fluidframework_tpu.protocol.messages import (
        SequencedDocumentMessage as JaxMessage,
    )

    # four phases of three inserts at the front (valid whichever ops an
    # applier missed): before, downtime, late, after the second restore
    stream = [JaxMessage(
        client_id="c", sequence_number=seq, minimum_sequence_number=0,
        client_sequence_number=seq, reference_sequence_number=seq - 1,
        type=JaxMessageType.OPERATION,
        contents={"type": 0, "pos": 0, "text": f"{seq} "})
        for seq in range(1, 13)]
    phases = [3, 6, 9, 12]

    def part(lo, hi):
        return [m for m in stream if lo < m.sequence_number <= hi]

    gaps = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            make = lambda: GpuDocumentApplier(  # noqa: E731
                device="cpu", max_docs=4, max_slots=64, ops_per_dispatch=8)
            save, load, kw = save_applier_checkpoint, \
                load_applier_checkpoint, {"device": "cpu"}
            conv = _to_port
        else:
            make = lambda: TpuDocumentApplier(  # noqa: E731
                kernel="xla", max_docs=4, max_slots=64, ops_per_dispatch=8)
            save, load, kw, conv = jax_save, jax_load, {"kernel": "xla"}, \
                (lambda m: m)

        def feed(app, msgs):
            for m in msgs:
                m = conv(m)
                app.ingest("t", "doc", m, m.contents)

        app = make()
        feed(app, part(0, phases[0]))
        app.mark_anchored("t", "doc")
        save(app, str(tmp_path / f"{pkg}-a"))
        # the downtime ops are never ingested; the feed resumes late
        app2 = load(str(tmp_path / f"{pkg}-a"), **kw)
        seen = [app2.restore_gap("t", "doc")]
        feed(app2, part(phases[1], phases[2]))
        seen.append(app2.restore_gap("t", "doc"))
        save(app2, str(tmp_path / f"{pkg}-b"))
        app3 = load(str(tmp_path / f"{pkg}-b"), **kw)
        seen.append(app3.restore_gap("t", "doc"))
        feed(app3, part(phases[2], phases[3]))
        seen.append(app3.restore_gap("t", "doc"))
        seen.append(app3.is_anchored("t", "doc"))
        gaps[pkg] = seen
    assert gaps["port"] == gaps["jax"]
    lo = gaps["port"][0][0]
    assert lo == phases[0]
    assert gaps["port"][1] == (lo, phases[1] + 1)
    assert gaps["port"][2] == (lo, None)  # the older low bound survived
    assert gaps["port"][3] == (lo, phases[2] + 1)


def test_checkpoint_of_failed_async_applier_raises(tmp_path):
    """A worker exception stored by an async applier raises from the
    save (through finalize) before any file is written."""
    server, _ = _farm(5)
    app = GpuDocumentApplier(device="cpu", max_docs=4, max_slots=64,
                             ops_per_dispatch=4, async_dispatch=True)

    def plane(seam, **info):
        if seam == "applier.stage.staged":
            raise RuntimeError("worker died mid-wave")

    app.fault_plane = plane
    try:
        _feed(app, server, "a")
        app.flush()
        with pytest.raises(RuntimeError, match="worker died mid-wave"):
            save_applier_checkpoint(app, str(tmp_path / "farm"))
        assert os.listdir(tmp_path) == []
    finally:
        app.close()
