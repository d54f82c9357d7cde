"""The port's segment-sharded giant-doc apply against the JAX package's.

Twins of ``tests/test_long_doc_apply.py``: on the same opgen streams the
port's ``parallel/long_doc.py`` (a giant doc's 8 seg shards as the rows of
one ``DocState`` on the CPU) must give the JAX single-chip kernel's live
rows AND the JAX sharded apply's rows and per-shard counts (``shard_map``
over the 8 forced CPU devices), through watermark rebalancing, past a
single shard's budget, and refuse a doc that outgrows the whole mesh. The
port's prefix and position resolution are held against the JAX functions
inside ``shard_map``, and the dense plain lane is shown unchanged by the
giant-doc hooks of ``ops/apply._apply_core``.
"""

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
import torch

from fluidframework_tpu.ops.opgen import generate_batch_ops
from fluidframework_tpu_torch.ops.apply import (
    F_CLIENT,
    F_REFSEQ,
    _apply_core,
    _visibility,
    apply_ops_batch_ref,
    compact_batch,
    wave_min_seq,
)
from fluidframework_tpu_torch.ops.doc_state import (
    FIELDS,
    DocState,
    state_from_numpy,
)
from fluidframework_tpu_torch.parallel.long_doc import (
    rebalance_shards,
    sharded_apply_ops,
    sharded_resolve_position,
    sharded_visible_prefix,
)
from tests.test_long_doc_apply import (
    N_SHARDS,
    S_GLOBAL,
    S_LOCAL,
    SLOT_FIELDS,
    _live_rows,
    _run_chunked_with_rebalancing,
    _run_pair,
)


def _ops(seed: int, n_ops: int, **mix) -> np.ndarray:
    """The stream ``_run_pair`` and the giant-doc tests generate."""
    rng = np.random.default_rng(seed)
    return generate_batch_ops(rng, 1, n_ops, max_insert=6, **mix)[0]


def _rows(state: DocState) -> list:
    return _live_rows({f: getattr(state, f).numpy() for f in SLOT_FIELDS},
                      state.count.numpy())


def _port_single(ops: np.ndarray) -> list:
    """The port's plain single-doc apply at S_GLOBAL, then zamboni."""
    t = torch.from_numpy(ops.copy())[None]
    state = apply_ops_batch_ref(DocState.empty(1, S_GLOBAL, device="cpu"), t)
    state = compact_batch(state, wave_min_seq(t))
    assert not bool(state.overflow[0])
    return _rows(state)


def _port_sharded(ops: np.ndarray, chunk: int = 0):
    """The port's giant-doc apply over N_SHARDS x S_LOCAL, in one wave or
    in chunks with the JAX tests' watermark rebalancing between them.
    Returns (state, rebalances)."""
    state = DocState.empty(N_SHARDS, S_LOCAL, device="cpu")
    t = torch.from_numpy(ops.copy())
    chunk = chunk or len(ops)
    watermark = S_LOCAL - 3 * chunk
    rebalances = 0
    for i in range(0, len(ops), chunk):
        state = sharded_apply_ops(state, t[i:i + chunk])
        assert not state.overflow.any(), f"overflow at op {i}"
        counts = state.count.numpy()
        if chunk < len(ops) and counts.max() > watermark:
            arrays = {f: getattr(state, f).numpy()
                      for f in FIELDS if f not in ("count", "overflow")}
            arrays, new_counts = rebalance_shards(arrays, counts)
            arrays.update(count=new_counts,
                          overflow=np.zeros(N_SHARDS, np.bool_))
            state = state_from_numpy(arrays, "cpu")
            rebalances += 1
    return state, rebalances


def _port_rows(ops: np.ndarray, chunk: int = 0):
    """(rows, counts, rebalances) of ``_port_sharded``."""
    state, rebalances = _port_sharded(ops, chunk)
    return _rows(state), state.count.numpy().copy(), rebalances


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sharded_apply_matches_single_chip(seed):
    ops = _ops(seed, 48, remove_fraction=0.3, annotate_fraction=0.1)
    jax_ref, jax_rows, jax_counts = _run_pair(seed, n_ops=48)
    rows, counts, _ = _port_rows(ops)
    assert rows == jax_rows == jax_ref == _port_single(ops)
    np.testing.assert_array_equal(counts, jax_counts)


def test_heavy_stream_with_watermark_rebalancing():
    """Mid-doc inserts pile onto the boundary-owning shard; chunked apply
    with the JAX tests' watermark rebalances and still tracks the
    single-chip kernel."""
    import jax.numpy as jnp

    ops = _ops(7, 96, remove_fraction=0.15, annotate_fraction=0.05)
    jax_ref, jax_rows, jax_counts, jax_rebalances = \
        _run_chunked_with_rebalancing(jnp.asarray(ops))
    rows, counts, rebalances = _port_rows(ops, chunk=8)
    assert rows == jax_rows == jax_ref == _port_single(ops)
    np.testing.assert_array_equal(counts, jax_counts)
    assert rebalances == jax_rebalances >= 1
    assert (counts > 0).sum() > 1


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_giant_doc_exceeds_single_shard_budget(seed):
    """One doc whose live segment count exceeds a single shard's S_LOCAL
    survives only through cross-shard rebalancing, row for row."""
    import jax.numpy as jnp

    ops = _ops(seed, 128, remove_fraction=0.08, annotate_fraction=0.05)
    jax_ref, jax_rows, jax_counts, jax_rebalances = \
        _run_chunked_with_rebalancing(jnp.asarray(ops))
    rows, counts, rebalances = _port_rows(ops, chunk=8)
    assert len(rows) > S_LOCAL
    assert rows == jax_rows == jax_ref == _port_single(ops)
    np.testing.assert_array_equal(counts, jax_counts)
    assert rebalances == jax_rebalances >= 1
    assert counts.max() <= S_LOCAL


def test_rebalance_refuses_when_doc_outgrows_whole_mesh():
    from fluidframework_tpu.parallel.long_doc import (
        rebalance_shards as jax_rebalance,
    )

    arrays = {"length": np.ones((2, 4), np.int32)}
    counts = np.array([5, 5], np.int32)
    with pytest.raises(ValueError, match="cannot fit") as port_err:
        rebalance_shards(arrays, counts)
    with pytest.raises(ValueError) as jax_err:
        jax_rebalance(arrays, counts)
    assert str(port_err.value) == str(jax_err.value)


def test_prefix_and_resolve_match_jax():
    """``sharded_visible_prefix`` and ``sharded_resolve_position`` on a
    rebalanced giant doc, against the JAX functions in ``shard_map``, at
    every visible position (and one past the end), from two
    perspectives."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fluidframework_tpu.ops.doc_state import DocState as JaxDocState
    from fluidframework_tpu.parallel.long_doc import (
        sharded_resolve_position as jax_resolve,
    )
    from fluidframework_tpu.parallel.long_doc import (
        sharded_visible_prefix as jax_prefix,
    )
    from fluidframework_tpu.parallel.mesh import make_mesh, shard_map

    ops = _ops(3, 64, remove_fraction=0.25, annotate_fraction=0.05)
    state, rebalances = _port_sharded(ops, chunk=8)
    assert rebalances >= 1
    arrays = {f: getattr(state, f).numpy() for f in FIELDS}
    jstate = JaxDocState(**{f: jnp.asarray(a) for f, a in arrays.items()})
    mesh = make_mesh(N_SHARDS, seg_shards=N_SHARDS)
    seg = P("seg")
    specs = JaxDocState(**{f: seg for f in FIELDS})

    def body(st, ref, client, pos):
        local = jax.tree.map(lambda a: a[0], st)
        _, _, cum, total = jax_prefix(local, ref, client, local.count)
        slot, off, found = jax_resolve(local, pos, ref, client, local.count)
        return cum[None], total, slot, off, found

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P(), P(), P()),
                           out_specs=(seg, P(), P(), P(), P()),
                           check_vma=False))
    last = ops[-1]
    for ref, client in ((int(last[3]), int(last[5])), (20, 1)):
        col = torch.full((N_SHARDS, 1), ref, dtype=torch.int32)
        cl = torch.full((N_SHARDS, 1), client, dtype=torch.int32)
        _, _, cum, total = sharded_visible_prefix(state, col, cl, state.count)
        jcum, jtotal, *_ = fn(jstate, ref, client, 0)
        np.testing.assert_array_equal(cum.numpy(), np.asarray(jcum))
        assert int(total[0, 0]) == int(jtotal) > 0
        for pos in range(int(jtotal) + 1):
            got = sharded_resolve_position(state, pos, col, cl, state.count)
            want = fn(jstate, ref, client, pos)[2:]
            assert [int(x) for x in got] == [int(x) for x in want], pos


def test_dense_plain_lane_unchanged_by_the_hooks():
    """The giant-doc hooks at their neutral values (the doc's own prefix,
    insert everywhere, no cross-row reduction) give the default body's
    state, op for op, and the plain lane still equals the JAX
    ``apply_ops_batch`` on a batch of docs."""
    import jax.numpy as jnp

    from fluidframework_tpu.ops.apply import apply_ops_batch as jax_apply
    from fluidframework_tpu.ops.doc_state import DocState as JaxDocState

    D, S, K = 6, 48, 24
    ops = generate_batch_ops(np.random.default_rng(11), D, K,
                             remove_fraction=0.3, annotate_fraction=0.2,
                             max_insert=5)
    t = torch.from_numpy(ops)
    hooked = state = DocState.empty(D, S, device="cpu")
    for k in range(K):
        op = t[:, k]
        vis, vlen, cum = _visibility(hooked, op[:, F_REFSEQ:F_REFSEQ + 1],
                                     op[:, F_CLIENT:F_CLIENT + 1],
                                     count=hooked.count)
        total = vlen.sum(-1, keepdim=True, dtype=torch.int32)
        hooked = _apply_core(hooked, op, prefix=(vis, vlen, cum, total),
                             insert_here=torch.ones((D, 1), dtype=torch.bool),
                             reduce_any=lambda x: x)
        state = _apply_core(state, op)
        for f in FIELDS:
            assert torch.equal(getattr(hooked, f), getattr(state, f)), (k, f)
    empty = JaxDocState.empty(S)
    jstate = jax_apply(JaxDocState(**{
        f: jnp.tile(getattr(empty, f)[None],
                    (D,) + (1,) * getattr(empty, f).ndim)
        for f in FIELDS}), jnp.asarray(ops))
    plain = apply_ops_batch_ref(DocState.empty(D, S, device="cpu"), t)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plain, f).numpy(),
                                      np.asarray(getattr(jstate, f)), f)
        assert torch.equal(getattr(plain, f), getattr(state, f)), f
