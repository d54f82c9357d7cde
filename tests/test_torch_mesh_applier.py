"""The port's doc-sharded mesh lane against the JAX package's, on the CPU.

Twins of ``tests/test_mesh_applier.py`` (1/2/4/8-shard fuzz, overflow
escalation, the force_wide lane, async with min-wave, staging bytes,
buffers flat over 100 waves, checkpoint re-sharding) and of
``tests/test_tpu_applier.py::test_applier_on_virtual_mesh``. The port's
shards sit on ``["cpu"] * n`` (a device list that repeats one device);
the JAX package's on the forced virtual CPU devices of
``tests/conftest.py``. Each case feeds both packages the same seeded
soups and holds them exactly: every doc's text, every state field row for
row, the placement map, and the counters ``dispatches``, ``mesh_waves``,
``mesh_active_shards`` and ``mesh_staged_bytes``. The soups are built once
for the module. The mesh construction's refusals and the sharded steps of
``parallel/sharded_apply.py`` are tested here too.
"""

import types

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
import torch

from fluidframework_tpu.ops.opgen import generate_batch_ops
from fluidframework_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fluidframework_tpu.service.tpu_applier import (
    TpuDocumentApplier,
    channel_stream,
)
from fluidframework_tpu.service.tpu_applier import (
    load_applier_checkpoint as jax_load,
)
from fluidframework_tpu.service.tpu_applier import (
    save_applier_checkpoint as jax_save,
)
from fluidframework_tpu_torch.ops.apply import OP_FIELDS
from fluidframework_tpu_torch.ops.doc_state import FIELDS, DocState
from fluidframework_tpu_torch.parallel import (
    make_mesh,
    make_sharded_packed_step,
    make_sharded_step,
)
from fluidframework_tpu_torch.parallel.mesh import Mesh, virtual_devices
from fluidframework_tpu_torch.parallel.sharded_apply import (
    shard_state,
    unshard_state,
)
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    load_applier_checkpoint,
    save_applier_checkpoint,
)
from tests.test_mesh_applier import DOCS, SEEDS, _build_soup
from tests.test_torch_applier import _to_port

GEO = dict(max_docs=16, max_slots=256, ops_per_dispatch=8)
COUNTERS = ("dispatches", "mesh_waves", "mesh_active_shards",
            "mesh_staged_bytes", "host_escalations")


@pytest.fixture(scope="module")
def soup():
    """seed -> ({doc: JAX messages}, {doc: port messages}, texts)."""
    out = {}
    for seed in SEEDS:
        server, texts = _build_soup(seed)
        jmsgs = {d: list(channel_stream(server, "t", d, "default", "text"))
                 for d in DOCS}
        out[seed] = (jmsgs, {d: [_to_port(m) for m in ms]
                             for d, ms in jmsgs.items()}, texts)
    return out


def _port_mesh(n: int) -> Mesh:
    return make_mesh(n, devices=virtual_devices(n, "cpu"))


def _feed_all(app, msgs: dict) -> None:
    for d in DOCS:
        for m in msgs[d]:
            app.ingest("t", d, m, m.contents)
    app.finalize()


def _pair(soup_entry, n_shards: int, **geo):
    """A JAX and a port mesh applier fed the same soup."""
    jmsgs, pmsgs, _ = soup_entry
    geo = {**GEO, **geo}
    jax_app = TpuDocumentApplier(mesh=jax_make_mesh(n_shards, seg_shards=1),
                                 **geo)
    port_app = GpuDocumentApplier(mesh=_port_mesh(n_shards), **geo)
    for app, msgs in ((jax_app, jmsgs), (port_app, pmsgs)):
        app.set_replay_source(lambda t, d, msgs=msgs: msgs[d])
        _feed_all(app, msgs)
    return jax_app, port_app


def _assert_same(jax_app, port_app, texts=None, docs=DOCS, counters=True):
    for d in docs:
        text = port_app.get_text("t", d)
        assert text == jax_app.get_text("t", d), d
        if texts is not None:
            assert text == texts[d], d
    port_state = port_app.state
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(port_state, f).numpy(),
            np.asarray(getattr(jax_app.state, f)), err_msg=f)
    assert port_app.placement.snapshot() == jax_app.placement.snapshot()
    for name in COUNTERS if counters else ():
        assert getattr(port_app, name) == getattr(jax_app, name), name


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_matches_jax_fuzz(soup, seed, n_shards):
    jax_app, port_app = _pair(soup[seed], n_shards)
    _assert_same(jax_app, port_app, soup[seed][2])
    assert port_app.host_escalations == 0
    # every mesh dispatch rode the per-shard staging lane
    assert port_app.mesh_waves == port_app.dispatches > 0
    # shards are where the mesh put them, and the dense lane agrees
    assert [s.device.type for s in port_app._shards] == ["cpu"] * n_shards
    local = GpuDocumentApplier(device="cpu", **GEO)
    _feed_all(local, soup[seed][1])
    for d in DOCS:
        assert port_app.get_text("t", d) == local.get_text("t", d)
    assert local.mesh_waves == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_overflow_escalation_matches_jax(soup, seed):
    """A slot budget far below the soup's live segment count forces the
    overflow → host-escalation flip on the mesh path."""
    jax_app, port_app = _pair(soup[seed], 4, max_docs=8, max_slots=8)
    assert port_app.host_escalations > 0
    _assert_same(jax_app, port_app, soup[seed][2])


def test_mesh_force_wide_lane_matches_jax(soup):
    """The chaos force_wide seam routes mesh waves down the int32 wide
    sharded lane."""
    jmsgs, pmsgs, texts = soup[0]
    apps = []
    for cls, msgs, mesh in (
            (TpuDocumentApplier, jmsgs, jax_make_mesh(2, seg_shards=1)),
            (GpuDocumentApplier, pmsgs, _port_mesh(2))):
        app = cls(mesh=mesh, **GEO)
        app.fault_plane = lambda point, **kw: (
            "force_wide" if point == "applier.dispatch" else None)
        _feed_all(app, msgs)
        apps.append(app)
    _assert_same(*apps, texts)
    assert apps[1].wide_dispatches == apps[1].dispatches > 0
    assert apps[1].mesh_waves == apps[1].dispatches


@pytest.mark.parametrize("seed", SEEDS)
def test_mesh_async_min_wave_matches_jax(soup, seed):
    """Async + min-wave: the mesh path rides the same worker thread and
    min_wave_ops hold-off as the dense lane."""
    jmsgs, pmsgs, texts = soup[seed]
    kw = dict(async_dispatch=True, min_wave_ops=16, **GEO)
    jax_app = TpuDocumentApplier(mesh=jax_make_mesh(4, seg_shards=1), **kw)
    port_app = GpuDocumentApplier(mesh=_port_mesh(4), **kw)
    try:
        _feed_all(jax_app, jmsgs)
        _feed_all(port_app, pmsgs)
        _assert_same(jax_app, port_app, texts)
        assert port_app.host_escalations == 0
    finally:
        jax_app.close()
        port_app.close()


def test_mesh_staging_bytes_scale_with_active_shards(soup):
    """One active doc stages exactly one shard's compact buffers per
    wave, far below the dense global wave."""
    K = 8
    geo = dict(max_docs=64, max_slots=64, ops_per_dispatch=K)
    jmsgs, pmsgs, _ = soup[0]
    jax_app = TpuDocumentApplier(mesh=jax_make_mesh(8, seg_shards=1), **geo)
    port_app = GpuDocumentApplier(mesh=_port_mesh(8), **geo)
    for app, msgs in ((jax_app, jmsgs), (port_app, pmsgs)):
        for m in msgs[DOCS[0]]:
            app.ingest("t", DOCS[0], m, m.contents)
        app.finalize()
    _assert_same(jax_app, port_app, docs=DOCS[:1])
    sps = port_app.placement.slots_per_shard
    per_shard = sps * K * OP_FIELDS * 2 + sps * 2 * 4  # wave16 + bases
    assert port_app.mesh_waves > 0
    assert port_app.mesh_active_shards == port_app.mesh_waves
    assert port_app.mesh_staged_bytes == port_app.mesh_waves * per_shard
    assert per_shard * 8 <= 64 * K * OP_FIELDS * 4


def _msg(seq, msn):
    return types.SimpleNamespace(sequence_number=seq,
                                 reference_sequence_number=max(seq - 1, 0),
                                 minimum_sequence_number=msn,
                                 client_id="c0")


def _buffers(app) -> int:
    """The applier's own buffers: pinned staging sets, resident zero
    shards and shard states."""
    return (sum(len(pool) for pool in app._stage_pool)
            + sum(len(z) for z in app._zero_shards.values())
            + len(app._shards))


def test_mesh_buffers_flat_over_100_waves():
    """Across 100 mesh waves the applier's buffer count stays flat after
    warm-up (the counterpart of the JAX test's live device arrays), and
    both packages end in the same state."""
    geo = dict(max_docs=8, max_slots=32, ops_per_dispatch=4)
    jax_app = TpuDocumentApplier(mesh=jax_make_mesh(4, seg_shards=1), **geo)
    port_app = GpuDocumentApplier(mesh=_port_mesh(4), **geo)
    docs = [f"d{i}" for i in range(4)]
    baseline = None
    for app in (jax_app, port_app):
        seq = 0
        for wave in range(100):
            for doc in docs:
                seq += 1
                app.ingest("t", doc, _msg(seq, max(seq - 4, 0)),
                           {"type": 0, "pos": 0, "text": "x"})
                seq += 1
                app.ingest("t", doc, _msg(seq, max(seq - 4, 0)),
                           {"type": 1, "start": 0, "end": 1})
            app.flush()
            if app is port_app and wave == 9:
                baseline = _buffers(app)
    assert port_app.mesh_waves >= 100
    assert _buffers(port_app) == baseline
    assert not port_app.state.overflow.any()
    _assert_same(jax_app, port_app, docs=docs)


def test_mesh_checkpoint_restore_resharded(tmp_path, soup):
    """A mesh applier's checkpoint reloads re-sharded onto a mesh of the
    same docs axis, and a mesh of another shard count refuses it with the
    JAX package's message."""
    _jmsgs, pmsgs, texts = soup[0]
    geo = dict(max_docs=8, max_slots=128, ops_per_dispatch=8)
    a = GpuDocumentApplier(mesh=_port_mesh(2), **geo)
    _feed_all(a, pmsgs)
    path = str(tmp_path / "ck")
    save_applier_checkpoint(a, path)
    b = load_applier_checkpoint(path, mesh=_port_mesh(2))
    assert len(b._shards) == 2 and b._shards[0].num_docs == 4
    for d in DOCS:
        assert b.get_text("t", d) == texts[d], d
    with pytest.raises(ValueError) as port_err:
        load_applier_checkpoint(path, mesh=_port_mesh(4))
    with pytest.raises(ValueError) as jax_err:
        jax_load(path, mesh=jax_make_mesh(4, seg_shards=1))
    assert str(port_err.value) == str(jax_err.value)
    # and the JAX package's own mesh checkpoint loads into the port's mesh
    j = TpuDocumentApplier(mesh=jax_make_mesh(2, seg_shards=1), **geo)
    _feed_all(j, _jmsgs)
    jax_save(j, str(tmp_path / "jck"))
    c = load_applier_checkpoint(str(tmp_path / "jck"), mesh=2, device="cpu")
    _assert_same(j, c, texts, counters=False)


def test_applier_on_virtual_mesh():
    """Twin of test_tpu_applier.py::test_applier_on_virtual_mesh: four
    docs through the client stack on an 8-shard mesh route through the
    real placement table."""
    from fluidframework_tpu.driver import LocalDocumentServiceFactory
    from fluidframework_tpu.loader import Loader
    from fluidframework_tpu.service import LocalServer

    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    docs = [f"doc{i}" for i in range(4)]
    strings = {}
    for d in docs:
        c = loader.resolve("t", d)
        s = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s.insert_text(0, f"content of {d}")
        strings[d] = s
    geo = dict(max_docs=8, max_slots=64, ops_per_dispatch=4)
    jax_app = TpuDocumentApplier(mesh=jax_make_mesh(8, seg_shards=1), **geo)
    port_app = GpuDocumentApplier(mesh=8, device="cpu", **geo)
    assert port_app.placement.n_shards == 8
    for d in docs:
        msgs = list(channel_stream(server, "t", d, "default", "text"))
        for app, ms in ((jax_app, msgs), (port_app, map(_to_port, msgs))):
            for m in ms:
                app.ingest("t", d, m, m.contents)
            app.finalize()
    shards = {port_app.placement.lookup("t", d)[0] for d in docs}
    assert len(shards) > 1, "docs all hashed to one shard"
    _assert_same(jax_app, port_app, {d: strings[d].get_text() for d in docs},
                 docs=docs)


# ------------------------------------------------------------ the mesh


def test_make_mesh_refuses_missing_cards(monkeypatch):
    """Without a device list the mesh takes cards only: too few raises,
    it never shrinks or falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh()
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        GpuDocumentApplier(max_docs=8, max_slots=16, mesh=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="machine has 2"):
        make_mesh(4)


def test_mesh_geometry_and_refusals():
    mesh = make_mesh(devices=virtual_devices(4, "cpu"), seg_shards=2)
    assert mesh.shape == {"docs": 2, "seg": 2}
    assert mesh.shard_devices(1) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="not divisible by seg_shards"):
        make_mesh(devices=virtual_devices(3), seg_shards=2)
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(2, devices=virtual_devices(3))
    with pytest.raises(ValueError, match="not divisible by the mesh"):
        GpuDocumentApplier(max_docs=6, max_slots=16, mesh=4, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        GpuDocumentApplier(max_docs=8, max_slots=16, mesh=_port_mesh(2),
                           device="cpu")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_steps_match_jax(n_shards):
    """``make_sharded_step`` and ``make_sharded_packed_step`` against the
    JAX steps on a two-wave opgen stream: every state field and both
    stats."""
    import jax
    import jax.numpy as jnp

    from fluidframework_tpu.ops.apply import pack_wave_rows
    from fluidframework_tpu.ops.doc_state import DocState as JaxDocState
    from fluidframework_tpu.parallel.sharded_apply import (
        make_sharded_packed_step as jax_packed,
    )
    from fluidframework_tpu.parallel.sharded_apply import (
        make_sharded_step as jax_step,
    )
    from fluidframework_tpu.parallel.sharded_apply import (
        shard_state as jax_shard_state,
    )

    D, S, K = 8, 64, 6
    stream = generate_batch_ops(np.random.default_rng(5), D, 2 * K,
                                remove_fraction=0.3, annotate_fraction=0.2,
                                max_insert=5)
    jmesh = jax_make_mesh(n_shards, seg_shards=1)
    pmesh = _port_mesh(n_shards)
    jstate = jax_shard_state(
        jax.vmap(lambda _: JaxDocState.empty(S))(jnp.arange(D)), jmesh)
    pstates = shard_state(DocState.empty(D, S, device="cpu"), pmesh)
    jfn, pfn = jax_step(jmesh, donate=False), make_sharded_step(pmesh)
    jpacked, _ = jax_packed(jmesh, donate=False)
    ppacked, _ = make_sharded_packed_step(pmesh)
    for k, wave in enumerate((stream[:, :K], stream[:, K:])):
        if k == 0:
            jstate, jstats = jfn(jstate, jnp.asarray(wave))
            pstates, pstats = pfn(pstates, torch.from_numpy(wave.copy()))
        else:
            flat = wave.reshape(-1, OP_FIELDS)
            lens = np.full(D, K)
            packed, sb, tb = pack_wave_rows(flat, np.arange(D) * K, lens)
            w16 = packed.reshape(D, K, OP_FIELDS).astype(np.int16)
            bases = np.stack([sb, tb], axis=1).astype(np.int32)
            jstate, jstats = jpacked(jstate, jnp.asarray(w16),
                                     jnp.asarray(bases))
            pstates, pstats = ppacked(pstates, torch.from_numpy(w16),
                                      torch.from_numpy(bases))
        got = unshard_state(pstates)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)
        assert {k: int(v) for k, v in pstats.items()} == \
            {k: int(v) for k, v in jstats.items()}
    assert int(pstats["applied_ops"]) > 0
    assert len(pstates) == n_shards
