"""Segment-sharded apply for giant single documents (the SP analog).

JAX counterpart: ``fluidframework_tpu/parallel/long_doc.py``. The
reference bounds per-query cost on long documents with per-block partial
length sums (merge-tree partialLengths.ts:62), a prefix-sum cache over
B-tree blocks. Sharding one doc's slot arrays over seg shards makes that
a segmented prefix sum: each shard cumsums its local visible lengths, and
every shard adds the exclusive sum of its predecessors' totals. Position
resolution is then a local search plus a vote across shards. (SURVEY
§5.7.)

The port has no ``shard_map``: a giant doc's seg shards are the leading
axis of ONE ``DocState`` ``[n_seg, S_LOCAL]`` on one device, in
shard-major logical order, with ``count`` the per-shard used counts. The
JAX package's three scalar collectives over the 'seg' axis become
reductions over that axis: the ``all_gather`` of shard totals an
exclusive cumsum, the insert-owner ``pmin`` a min, the abort ``pmax`` an
any. Everything else is the plain apply body (``ops/apply._apply_core``),
run as PyTorch on the state's device. Placing seg shards on separate
devices is not part of the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.apply import (
    F_CLIENT,
    F_POS,
    F_REFSEQ,
    _apply_core,
    _first_true,
    _visibility,
    compact_batch,
    wave_min_seq,
)
from ..ops.doc_state import DocState


def _shard_ids(state: DocState) -> torch.Tensor:
    return torch.arange(state.num_docs, dtype=torch.int32,
                        device=state.device)


def sharded_visible_prefix(state: DocState, ref_seq, client, local_count):
    """Global exclusive prefix sum of visible lengths across the seg
    shards (rows) of one doc.

    ``ref_seq`` and ``client`` are [n_seg, 1] (the op's, on every row),
    ``local_count`` [n_seg]. Returns (vis, vlen, cum, total): cum[s, i]
    is the GLOBAL number of visible characters before local slot i of
    shard s; total ([n_seg, 1], equal on every row) is the doc's visible
    length."""
    vis, vlen, local_cum = _visibility(state, ref_seq, client,
                                       count=local_count)
    shard_totals = vlen.sum(-1, dtype=torch.int32)  # [n_seg]
    offset = torch.cumsum(shard_totals, 0, dtype=torch.int32) - shard_totals
    total = shard_totals.sum(dtype=torch.int32).expand(state.num_docs, 1)
    return vis, vlen, local_cum + offset[:, None], total


def sharded_resolve_position(state: DocState, pos, ref_seq, client,
                             local_count):
    """Resolve visible position → (global_slot, offset_in_slot, found),
    0-dim tensors. The distributed twin of MergeTree.resolve /
    getContainingSegment (mergeTree.ts:1656): each shard searches its
    slice against the global prefix, then a max-vote across shards picks
    the owner."""
    S = state.max_slots
    vis, vlen, cum, total = sharded_visible_prefix(
        state, ref_seq, client, local_count)
    inside = vis & (cum <= pos) & (pos < cum + vlen)
    has_local = inside.any(-1)
    j = _first_true(inside)  # [n_seg, 1]
    global_slot = _shard_ids(state) * S + j[:, 0]
    offset = pos - torch.gather(cum, 1, j.to(torch.int64))[:, 0]
    # exactly one shard can contain an interior position; max-vote selects it
    winner_slot = torch.where(has_local, global_slot, -1).max()
    winner_off = torch.where(has_local, offset, -1).max()
    return winner_slot, winner_off, (winner_slot >= 0) & (pos < total[0, 0])


def sharded_apply_op(state: DocState, op: torch.Tensor) -> DocState:
    """Apply ONE sequenced op (int32 [OP_FIELDS]) to a giant doc whose
    seg shards are the rows of ``state``.

    Insert ownership: the op inserts at the EARLIEST global boundary
    (same tie-break as unsharded). Shard-local free tails carry cum ==
    their shard's end offset, so the earliest boundary's shard is exactly
    the min over (shard, slot) keys among shards holding any boundary —
    content boundaries and the append point fall out of one rule."""
    n, S = state.num_docs, state.max_slots
    ops = op.expand(n, -1)
    vis, vlen, cum, total = sharded_visible_prefix(
        state, ops[:, F_REFSEQ:F_REFSEQ + 1], ops[:, F_CLIENT:F_CLIENT + 1],
        state.count)
    boundary = cum >= op[F_POS]
    has_b = boundary.any(-1)
    key = torch.where(has_b, _shard_ids(state) * S + _first_true(boundary)[
        :, 0], 1 << 30)
    insert_here = (has_b & (key.min() == key))[:, None]

    def reduce_any(x):
        return x.any(0, keepdim=True)

    return _apply_core(state, ops, prefix=(vis, vlen, cum, total),
                       insert_here=insert_here, reduce_any=reduce_any)


def sharded_apply_ops(state: DocState, ops: torch.Tensor) -> DocState:
    """Apply K sequenced ops (int32 [K, OP_FIELDS]) to a sharded giant
    doc, in order, then run zamboni on each shard at the wave's msn floor
    (compaction is per shard: packing never crosses shard boundaries, so
    global segment order stays shard-major)."""
    for k in range(ops.shape[0]):
        state = sharded_apply_op(state, ops[k])
    return compact_batch(state, wave_min_seq(ops).expand(state.num_docs))


def rebalance_shards(arrays: dict, counts) -> tuple[dict, np.ndarray]:
    """Host-side shard rebalancing for a giant doc.

    Mid-doc inserts always land on the shard owning the boundary, so hot
    spots fill one shard while neighbors sit empty; when a shard nears
    capacity the host redistributes the logical segment sequence evenly
    and resumes (the dynamic analog of the reference's B-tree node
    splits, mergeTree.ts:2509 — rebalancing IS the split, done in bulk).

    ``arrays``: field → np.ndarray[n_shards, S_LOCAL(, P)] in shard-major
    logical order with per-shard ``counts``. Returns evenly re-packed
    arrays + new counts. Pure numpy: this runs between device steps, like
    the applier's escalation path."""
    n_shards = len(counts)
    total = int(np.sum(counts))
    per = -(-total // n_shards)  # ceil: even spread
    cap = next(iter(arrays.values())).shape[1]
    if per > cap:
        # an even spread no longer fits: the doc outgrew the WHOLE seg
        # mesh, not one hot shard — silent out-of-bounds packing here
        # would corrupt shard-major order, so refuse loudly (the caller's
        # move is a bigger mesh or larger per-shard slot arrays)
        raise ValueError(
            f"doc has {total} live segments but the seg mesh holds "
            f"{n_shards} x {cap}; rebalancing cannot fit "
            f"{per} per shard")
    out = {f: np.zeros_like(a) for f, a in arrays.items()}
    new_counts = np.zeros(n_shards, np.int32)
    # concatenate live rows in logical order once
    live = {f: np.concatenate([a[s, : counts[s]] for s in range(n_shards)])
            for f, a in arrays.items()}
    at = 0
    for s in range(n_shards):
        take = min(per, total - at)
        for f in out:
            out[f][s, :take] = live[f][at:at + take]
        new_counts[s] = take
        at += take
    return out, new_counts
