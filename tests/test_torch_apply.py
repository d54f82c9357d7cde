"""The port's plain apply, zamboni and wave codec against the JAX package.

The same seeded numpy streams (those of test_pallas_apply.py::_run_pair)
go through JAX ``apply_ops_batch`` (XLA), ``pallas_apply_ops_batch`` in
interpret mode, and the port's ``apply_ops_batch_ref``; every field must
agree exactly (integer fields, tolerance 0). Inputs reach the port through
``state_from_numpy``. The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import apply as japply
from fluidframework_tpu.ops.doc_state import DocState as JDocState
from fluidframework_tpu.ops.opgen import generate_batch_ops, generate_doc_ops
from fluidframework_tpu.ops.pallas_apply import pallas_apply_ops_batch
from fluidframework_tpu_torch.ops import apply as tapply
from fluidframework_tpu_torch.ops import cuda_apply
from fluidframework_tpu_torch.ops.doc_state import (
    FIELDS,
    DocState,
    state_from_numpy,
    state_to_numpy,
)

# name -> (seed, geometry, generator mix), as in test_pallas_apply.py
STREAMS = {
    "seed0": (0, dict(D=16, S=64, K=24),
              dict(remove_fraction=0.3, annotate_fraction=0.15, max_insert=6)),
    "seed1": (1, dict(D=16, S=64, K=24),
              dict(remove_fraction=0.3, annotate_fraction=0.15, max_insert=6)),
    "seed2": (2, dict(D=16, S=64, K=24),
              dict(remove_fraction=0.3, annotate_fraction=0.15, max_insert=6)),
    "seed9_annotate_heavy": (9, dict(D=16, S=64, K=24),
                             dict(remove_fraction=0.15, annotate_fraction=0.5,
                                  max_insert=4)),
    "seed4_overflow": (4, dict(D=8, S=16, K=32),
                       dict(remove_fraction=0.4, annotate_fraction=0.1,
                            max_insert=8)),
}


def _np_state(jstate) -> dict:
    return {f: np.asarray(getattr(jstate, f)) for f in FIELDS}


def _jax_empty(D, S):
    return jax.vmap(lambda _: JDocState.empty(S))(jnp.arange(D))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(input state, ops, XLA result, Pallas-interpret result) as numpy."""
    seed, geo, gen = STREAMS[name]
    rng = np.random.default_rng(seed)
    state = _jax_empty(geo["D"], geo["S"])
    ops = generate_batch_ops(rng, geo["D"], geo["K"], **gen)
    xla = japply.apply_ops_batch(state, jnp.asarray(ops))
    pallas = pallas_apply_ops_batch(state, jnp.asarray(ops), interpret=True)
    return _np_state(state), ops, _np_state(xla), _np_state(pallas)


def _assert_state_equal(got: DocState, want: dict, ctx=""):
    got = state_to_numpy(got)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], f"{ctx} {f}")


def _port_apply(name):
    state0, ops, _, _ = _jax_run(name)
    return tapply.apply_ops_batch_ref(state_from_numpy(state0, "cpu"),
                                      torch.from_numpy(ops))


@pytest.mark.parametrize("name", list(STREAMS))
def test_plain_apply_matches_jax_xla(name):
    _assert_state_equal(_port_apply(name), _jax_run(name)[2], name)


@pytest.mark.parametrize("name", list(STREAMS))
def test_plain_apply_matches_pallas_interpret(name):
    _assert_state_equal(_port_apply(name), _jax_run(name)[3], name)


def test_overflow_stream_really_overflows():
    # tiny slot budget: splits overflow the docs; the flags must match
    flags = state_to_numpy(_port_apply("seed4_overflow"))["overflow"]
    assert flags.any()
    np.testing.assert_array_equal(flags, _jax_run("seed4_overflow")[2]
                                  ["overflow"])


@pytest.mark.parametrize("name", list(STREAMS))
def test_cpu_wrapper_takes_plain_version(name):
    """On CPU tensors the kernel's wrapper is its plain version and does
    not count a launch."""
    state0, ops, want, _ = _jax_run(name)
    before = cuda_apply.LAUNCHES
    got = cuda_apply.apply_ops_batch(state_from_numpy(state0, "cpu"),
                                     torch.from_numpy(ops))
    assert cuda_apply.LAUNCHES == before
    _assert_state_equal(got, want, name)


def _two_waves(seed, D, S, K, gen):
    """Two consecutive K-op waves per doc (the second continues each doc's
    seq, length and arena), so the second starts from a carried state."""
    rng = np.random.default_rng(seed)
    w1 = np.zeros((D, K, japply.OP_FIELDS), np.int32)
    w2 = np.zeros_like(w1)
    for d in range(D):
        w1[d], length, used = generate_doc_ops(rng, K, **gen)
        w2[d], _, _ = generate_doc_ops(rng, K, start_seq=K, start_len=length,
                                       arena_base=used, **gen)
    return w1, w2


@pytest.mark.parametrize("name", list(STREAMS))
def test_carried_state_wave_matches_jax(name):
    """A wave applied to a non-empty state carried over from the JAX
    package (apply + zamboni of an earlier wave), then zamboni: apply,
    ``compact_batch`` and ``wave_min_seq`` all agree with their twins."""
    seed, geo, gen = STREAMS[name]
    D, S, K = geo["D"], geo["S"], geo["K"]
    w1, w2 = _two_waves(100 + seed, D, S, K, gen)
    j = japply.compact_batch(
        japply.apply_ops_batch(_jax_empty(D, S), jnp.asarray(w1)),
        japply.wave_min_seq(jnp.asarray(w1)))
    carried = _np_state(j)
    j_applied = japply.apply_ops_batch(j, jnp.asarray(w2))
    j_floor = np.asarray(japply.wave_min_seq(jnp.asarray(w2)))
    j_compacted = japply.compact_batch(j_applied, jnp.asarray(j_floor))

    t_applied = tapply.apply_ops_batch_ref(state_from_numpy(carried, "cpu"),
                                           torch.from_numpy(w2))
    _assert_state_equal(t_applied, _np_state(j_applied), "apply")
    t_floor = tapply.wave_min_seq(torch.from_numpy(w2))
    np.testing.assert_array_equal(t_floor.numpy(), j_floor)
    _assert_state_equal(tapply.compact_batch(t_applied, t_floor),
                        _np_state(j_compacted), "compact")


def _staged_rows(seed, n_docs=6, max_rows=12):
    """Concatenated per-doc staged rows with ragged run lengths, including
    system-client rows and one real client id of 32767 (wide escape)."""
    rng = np.random.default_rng(seed)
    chunks, lens = [], []
    for d in range(n_docs):
        n = int(rng.integers(1, max_rows + 1))
        ops, _, _ = generate_doc_ops(rng, n, start_seq=int(rng.integers(0, 50)),
                                     annotate_fraction=0.2,
                                     arena_base=int(rng.integers(0, 500)))
        chunks.append(ops)
        lens.append(n)
    flat = np.concatenate(chunks)
    flat[1, japply.F_CLIENT] = japply.SYSTEM_CLIENT
    flat[-1, japply.F_CLIENT] = japply.PACK_SYSTEM
    lens_a = np.array(lens)
    return flat, np.cumsum(lens_a) - lens_a, lens_a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_and_unpack_match_jax(seed):
    flat, starts, lens_a = _staged_rows(seed)
    want = japply.pack_wave_rows(flat, starts, lens_a)
    got = tapply.pack_wave_rows(flat, starts, lens_a)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    packed, seq_base, text_base = got
    # the real id 32767 is forced out of int16 range (the wide lane)
    assert packed[-1, japply.F_CLIENT] > 32767
    packed[-1, japply.F_CLIENT] = 5
    # scatter into a [D, K] wave with NOOP padding, as the applier does
    D, K = len(lens_a) + 2, int(lens_a.max()) + 3
    doc_idx = np.repeat(np.arange(len(lens_a)), lens_a)
    pos_idx = np.arange(len(flat)) - np.repeat(starts, lens_a)
    wave16 = np.zeros((D, K, japply.OP_FIELDS), np.int16)
    wave16[doc_idx, pos_idx] = packed
    bases = np.zeros((D, 2), np.int32)
    bases[:len(lens_a), 0] = seq_base
    bases[:len(lens_a), 1] = text_base
    want_wave = np.asarray(japply.unpack_wave16(jnp.asarray(wave16),
                                                jnp.asarray(bases)))
    got_wave = tapply.unpack_wave16(torch.from_numpy(wave16),
                                    torch.from_numpy(bases))
    assert got_wave.dtype == torch.int32
    np.testing.assert_array_equal(got_wave.numpy(), want_wave)
    np.testing.assert_array_equal(
        tapply.wave_min_seq(got_wave).numpy(),
        np.asarray(japply.wave_min_seq(jnp.asarray(want_wave))))


def test_make_op_matches_jax():
    args = dict(type=japply.OP_ANNOTATE, pos=3, end=9, seq=11, ref_seq=7,
                client=2, text_len=0, text_start=0, msn=5, flags=0, key=4,
                val=-1)
    np.testing.assert_array_equal(tapply.make_op(**args),
                                  japply.make_op(**args))
