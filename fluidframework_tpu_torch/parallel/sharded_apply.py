"""Doc-sharded batched apply: the farm's one device step.

JAX counterpart: ``fluidframework_tpu/parallel/sharded_apply.py``.
Documents are independent CRDTs, so the 'docs' mesh axis is pure data
parallelism: each shard applies its own docs' sequenced ops (the analog of
one Kafka partition's DocumentLambda loop, lambdas-driver
document-router/documentLambda.ts).

``apply_wave`` is the only code that runs a wave on a shard's state, for a
farm of one shard as for each shard of a mesh: ``unpack_wave16`` (a packed
int16 wave with its bases), ``ops/cuda_apply.apply_ops_batch`` (the CUDA
kernel B1 on CUDA tensors, the plain version on the CPU), then
``compact_batch`` at the wave's own ``wave_min_seq``. It computes no
statistics.

A sharded state is a list of per-shard ``DocState``s, shard-major (shard
``s`` holds global rows ``[s * sps, (s + 1) * sps)``), each on its shard's
device (``mesh.shard_device(s)``). ``make_sharded_step`` and
``make_sharded_packed_step`` are the JAX steps' twins: they run
``apply_wave`` on each shard in shard order on that device's current
stream, then sum the JAX ``psum``'s scalar stats (applied-op count,
overflow count) over the shards. Dropped as TPU/XLA artifacts:
``shard_map`` and ``NamedSharding`` (the list is the sharding), donation
(the kernel writes a new state; the old one is freed when the caller drops
it), the jaxpr contracts, and the ``trace_hook`` recompile counter
(nothing is traced).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence, Union

import torch

from ..ops import cuda_apply
from ..ops.apply import (
    F_TYPE,
    OP_NOOP,
    compact_batch,
    unpack_wave16,
    wave_min_seq,
)
from ..ops.doc_state import FIELDS, DocState
from .mesh import Mesh

Shards = Sequence[torch.Tensor]
_NO_SCOPE = nullcontext()


def profiler_scope(name: str, on: bool):
    """A profiler scope named ``name`` while tracing, else nothing. It is
    a function-scope event: a user annotation (``record_function``) would
    also lay a range over the step's kernels on the card's timeline,
    which a reader of the card's busy time would count as busy."""
    return (torch._C._profiler._RecordFunctionFast(name) if on
            else _NO_SCOPE)


def apply_wave(state: DocState, wave: torch.Tensor,
               bases: Optional[torch.Tensor] = None,
               traced: bool = False) -> DocState:
    """One wave's step on one shard's state, returning the new state.
    ``wave`` is a packed int16 ``[D, K, OP_FIELDS]`` wave with its int32
    ``[D, 2]`` ``bases`` (``ops/apply.unpack_wave16`` wire format), or a
    NOOP-padded int32 wave when ``bases`` is None, each op carrying its
    deli msn in F_MSN. While ``traced``, profiler scopes name the stages:
    ``applier.unpack``, ``applier.apply``, ``applier.compact``."""
    if bases is not None:
        with profiler_scope("applier.unpack", traced):
            wave = unpack_wave16(wave, bases)
    with profiler_scope("applier.apply", traced):
        state = cuda_apply.apply_ops_batch(state, wave)
    with profiler_scope("applier.compact", traced):
        return compact_batch(state, wave_min_seq(wave))


def shard_state(state: DocState, mesh: Mesh) -> list:
    """Split a ``[D, S]`` state into the mesh's contiguous per-shard
    states, shard-major, each copied onto its shard's device."""
    n = mesh.shape["docs"]
    if state.num_docs % n:
        raise ValueError(f"{state.num_docs} docs not divisible by the "
                         f"mesh's docs axis ({n})")
    sps = state.num_docs // n
    return [DocState(**{f: getattr(state, f)[s * sps:(s + 1) * sps].to(
        mesh.shard_device(s), copy=True) for f in FIELDS})
        for s in range(n)]


def unshard_state(shards: Sequence[DocState], device=None) -> DocState:
    """The inverse of ``shard_state``: the shards' rows concatenated in
    shard order on ``device`` (default: the first shard's)."""
    device = shards[0].device if device is None else torch.device(device)
    return DocState(**{f: torch.cat([getattr(s, f).to(device)
                                     for s in shards]) for f in FIELDS})


def _per_shard(x: Union[torch.Tensor, Shards], mesh: Mesh) -> list:
    """A ``[D, ...]`` input cut into the mesh's row blocks on their
    devices, or a list of per-shard blocks as it is."""
    if not isinstance(x, torch.Tensor):
        return list(x)
    n = mesh.shape["docs"]
    return [blk.to(mesh.shard_device(s))
            for s, blk in enumerate(torch.chunk(x, n))]


def _run(mesh: Mesh, states, waves):
    """``apply_wave`` on each shard in shard order, ``waves`` holding each
    shard's arguments; stats summed on the first shard's device (the JAX
    ``psum`` over 'docs'). A packed wave's F_TYPE is the op type as
    unpacked, so the applied count reads it as it came."""
    if len(states) != mesh.shape["docs"] or len(waves) != len(states):
        raise ValueError(f"{len(states)} state shards and {len(waves)} "
                         f"wave shards for a {mesh.shape['docs']}-shard "
                         "mesh")
    out = [apply_wave(state, *args) for state, args in zip(states, waves)]
    home = out[0].device
    stats = {
        "applied_ops": torch.stack([
            (args[0][..., F_TYPE] != OP_NOOP).sum(dtype=torch.int32).to(home)
            for args in waves]).sum(),
        "overflow_docs": torch.stack([
            state.overflow.sum(dtype=torch.int32).to(home)
            for state in out]).sum(),
    }
    return out, stats


def make_sharded_step(mesh: Mesh):
    """``step(states, ops) -> (states', stats)``: ``states`` the shard
    list, ``ops`` int32 ``[D, K, OP_FIELDS]`` (NOOP-padded, each op
    carrying its deli msn in F_MSN) or its per-shard blocks; ``stats``
    holds 0-dim int32 tensors ``applied_ops`` and ``overflow_docs``."""

    def step(states: Sequence[DocState], ops):
        return _run(mesh, states, [(w,) for w in _per_shard(ops, mesh)])

    return step


def make_sharded_packed_step(mesh: Mesh):
    """The mesh lane's step pair ``(packed_fn, wide_fn)``:

    ``packed_fn(states, wave16, bases) -> (states', stats)`` takes the
    int16-delta packed wave (``ops/apply.unpack_wave16`` wire format) with
    int32 ``[D, 2]`` per-doc bases, each as a ``[D, ...]`` tensor or its
    per-shard blocks; ``wide_fn(states, wave)`` is the int32 escape lane
    (giant docs, huge windows, chaos force_wide). Each shard unpacks and
    applies ONLY its own rows."""

    def packed_fn(states: Sequence[DocState], wave16, bases):
        return _run(mesh, states, list(zip(_per_shard(wave16, mesh),
                                           _per_shard(bases, mesh))))

    def wide_fn(states: Sequence[DocState], wave):
        return _run(mesh, states, [(w,) for w in _per_shard(wave, mesh)])

    return packed_fn, wide_fn
