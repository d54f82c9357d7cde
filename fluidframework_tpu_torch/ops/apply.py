"""Batched merge-tree delta-apply: the plain PyTorch versions.

JAX counterpart: ``fluidframework_tpu/ops/apply.py`` (``make_op``,
``_visibility``, ``_apply_core``, ``apply_ops_batch``, ``compact_batch``,
``wave_min_seq``, ``unpack_wave16``, ``pack_wave_rows``). Where the JAX
package writes one doc and lifts it with ``vmap``/``scan``, these
functions take the doc dimension D first and loop over the K ops of a
wave.

``apply_ops_batch_ref`` is the plain version of the hand-written CUDA
kernel (``ops/cuda_apply.py``, ``csrc/apply.cu``): the CPU tests hold it
against the JAX package, and the kernel is held against it on the card.

Server-side invariants that make the apply simple: ops arrive in sequence
order, so every existing stamp is below the incoming seq — the
concurrent-insert tie-break reduces to inserting at the EARLIEST boundary,
overlapping removes keep the earliest stamp, and annotate LWW-per-key is
an in-order overwrite of the per-slot property table. Every op carries the
msn deli stamped on it (F_MSN), so zamboni compaction runs after each wave
at the exact collaboration-window floor.
"""

from __future__ import annotations

import numpy as np
import torch

from .doc_state import NO_KEY, NO_SEQ, SLOT_FIELDS, DocState

NO_CLIENT = -1
NO_VAL = -1  # annotate value id meaning "delete this key"

# op vector layout (int32[OP_FIELDS])
OP_NOOP = 0
OP_INSERT = 1
OP_REMOVE = 2
OP_ANNOTATE = 3
(
    F_TYPE,
    F_POS,
    F_END,
    F_SEQ,
    F_REFSEQ,
    F_CLIENT,
    F_TLEN,
    F_TSTART,
    F_MSN,
    F_FLAGS,
    F_KEY,
    F_VAL,
) = range(12)
OP_FIELDS = 12

#: interned id for server/system-originated stamps (never collides with
#: the dense per-doc client table, which grows upward from 0)
SYSTEM_CLIENT = (1 << 30) - 1

#: int16 packed-wave sentinel standing in for SYSTEM_CLIENT on the wire
PACK_SYSTEM = 32767

#: msn given to NOOP padding by ``unpack_wave16``: far below any real msn,
#: so padding never lifts the per-doc zamboni floor (a max)
NOOP_MSN = -(1 << 20)


def make_op(
    type: int,
    pos: int = 0,
    end: int = 0,
    seq: int = 0,
    ref_seq: int = 0,
    client: int = 0,
    text_len: int = 0,
    text_start: int = 0,
    msn: int = 0,
    flags: int = 0,
    key: int = 0,
    val: int = 0,
) -> np.ndarray:
    v = np.zeros(OP_FIELDS, np.int32)
    v[F_TYPE], v[F_POS], v[F_END] = type, pos, end
    v[F_SEQ], v[F_REFSEQ], v[F_CLIENT] = seq, ref_seq, client
    v[F_TLEN], v[F_TSTART] = text_len, text_start
    v[F_MSN], v[F_FLAGS] = msn, flags
    v[F_KEY], v[F_VAL] = key, val
    return v


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dim, 0 where there is none
    (``jnp.argmax`` on a bool mask; ``torch.argmax`` refuses bool)."""
    return torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True).to(
        torch.int32)


def _masked_sum(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Sum of ``a`` where ``mask``, per doc, kept int32 ([D, 1])."""
    return torch.where(mask, a, 0).sum(-1, keepdim=True, dtype=torch.int32)


def _visibility(state: DocState, ref_seq, client, count=None):
    """Per-slot visibility at each doc's op perspective → (vis, vlen, cum).

    ``ref_seq`` and ``client`` are [D, 1]. ``cum`` is the exclusive prefix
    sum of visible lengths (int32, as in the JAX package). ``count`` [D]
    overrides ``state.count`` for callers whose rows are shards of a
    larger doc (``parallel/long_doc.py`` passes the local counts)."""
    if count is None:
        count = state.count
    S = state.max_slots
    idx = torch.arange(S, dtype=torch.int32, device=state.device)
    in_use = idx[None, :] < count[:, None]
    ins_seen = (state.ins_client == client) | (state.ins_seq <= ref_seq)
    removed = (state.rem_seq != NO_SEQ) & (
        (state.rem_client_a == client)
        | (state.rem_client_b == client)
        | (state.rem_seq <= ref_seq)
    )
    vis = in_use & ins_seen & ~removed
    vlen = torch.where(vis, state.length, 0)
    cum = torch.cumsum(vlen, dim=-1, dtype=torch.int32) - vlen
    return vis, vlen, cum


def _shifted(a: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor
             ) -> torch.Tensor:
    """out[i] = a[i-1] where d1, a[i-2] where d2, else a[i], along the
    slot dim; the shifts wrap around like ``jnp.roll`` (callers never
    select a wrapped value)."""
    if a.ndim == 3:
        d1, d2 = d1[..., None], d2[..., None]
    return torch.where(d1, torch.roll(a, 1, dims=1),
                       torch.where(d2, torch.roll(a, 2, dims=1), a))


def _apply_core(state: DocState, op: torch.Tensor, prefix=None,
                insert_here=True, reduce_any=None) -> DocState:
    """Apply one op per doc (``op`` int32 [D, OP_FIELDS]) to every doc.

    The unified insert/remove/annotate body of the JAX ``_apply_core``: a
    single visibility/prefix-sum pass and a single shift-by-0/1/2 rebuild
    cover both potential splits and the insert shift. An op creates at
    most two new slots, so every output slot is one of a[o], a[o-1],
    a[o-2], plus point patches at the split and insert indices.

    Rows are independent docs unless a caller says otherwise. The
    segment-sharded giant-doc path (``parallel/long_doc.py``), whose rows
    are one doc's seg shards, passes ``prefix`` = (vis, vlen, cum, total)
    with the GLOBAL prefix, masks the insert to the boundary-owning row
    with ``insert_here`` ([D, 1] bool), and supplies ``reduce_any`` (an
    any over the rows) so a capacity or shape problem on ANY shard aborts
    the op on EVERY shard."""
    S = state.max_slots
    P = state.max_props

    def col(f):
        return op[:, f:f + 1]  # [D, 1]

    if prefix is None:
        vis, vlen, cum = _visibility(state, col(F_REFSEQ), col(F_CLIENT))
        total = vlen.sum(-1, keepdim=True, dtype=torch.int32)
    else:
        vis, vlen, cum, total = prefix
    count = state.count[:, None]

    typ = col(F_TYPE)
    is_ins = typ == OP_INSERT
    is_rem = typ == OP_REMOVE
    is_ann = typ == OP_ANNOTATE
    active = is_ins | is_rem | is_ann
    pos, end = col(F_POS), col(F_END)
    seq, client = col(F_SEQ), col(F_CLIENT)
    p2 = torch.where(is_ins, pos, end)

    bad_shape = torch.where(is_ins, pos > total, (end > total) | (end <= pos))
    inc = cum + vlen

    # a split happens iff the position falls STRICTLY inside a visible
    # segment (exact on the pre-split state)
    inside1 = vis & (cum < pos) & (pos < inc)
    inside2 = vis & (cum < p2) & (p2 < inc)
    s1_raw = inside1.any(-1, keepdim=True)
    s2_raw = ~is_ins & inside2.any(-1, keepdim=True)
    ins_here = is_ins & insert_here
    needed = (s1_raw.to(torch.int32) + s2_raw.to(torch.int32)
              + ins_here.to(torch.int32))
    refused = bad_shape | (count + needed > S)
    bad = active & (refused if reduce_any is None else reduce_any(refused))
    ok = active & ~bad
    s1 = s1_raw & ok
    s2 = s2_raw & ok
    do_ins = ins_here & ok

    j1 = _first_true(inside1)
    j2 = _first_true(inside2)
    c1 = _masked_sum(inside1, cum)
    c2 = _masked_sum(inside2, cum)
    o1 = pos - c1
    o2 = p2 - c2
    l1 = _masked_sum(inside1, state.length)
    ts1 = _masked_sum(inside1, state.text_start)
    l2 = _masked_sum(inside2, state.length)
    ts2 = _masked_sum(inside2, state.text_start)
    same = s1 & s2 & (j1 == j2)  # both splits inside one segment

    s1i = s1.to(torch.int32)
    # earliest boundary (unused slots keep cum == total, so an append at
    # the end resolves to the first free slot)
    idx0 = _first_true(cum >= pos)
    p_ins = torch.where(s1, j1 + 1, idx0)  # new insert slot
    p_n1 = torch.where(do_ins, p_ins + 1, j1 + 1)  # tail half of split 1
    p_h2 = j2 + s1i  # original j2 (head half of split 2), shifted past n1
    p_n2 = j2 + 1 + s1i  # tail half of split 2

    i = torch.arange(S, dtype=torch.int32, device=state.device)[None, :]
    # shift = how many new slots sit at/before each output index
    delta = ((s1 & (i >= p_n1)).to(torch.int32)
             + (s2 & (i >= p_n2)).to(torch.int32)
             + (do_ins & (i >= p_ins)).to(torch.int32))
    d1 = delta == 1
    d2 = delta == 2
    head1_at = s1 & (i == j1)
    n1_at = s1 & (i == p_n1)
    h2_at = s2 & ~same & (i == p_h2)
    n2_at = s2 & (i == p_n2)
    new_at = do_ins & (i == p_ins)

    tlen = col(F_TLEN)
    new_vals = {
        "length": torch.where(tlen > 0, tlen, 1),
        "text_start": col(F_TSTART),
        "flags": col(F_FLAGS),
        "ins_seq": seq,
        "ins_client": client,
        "rem_seq": NO_SEQ,
        "rem_client_a": NO_CLIENT,
        "rem_client_b": NO_CLIENT,
    }
    # length/text_start patches for the four split-derived slots; later
    # patches win, as in the JAX rebuild
    n1_len = torch.where(same, o2 - o1, l1 - o1)
    patches = {
        "length": [(head1_at, o1), (n1_at, n1_len), (h2_at, o2),
                   (n2_at, l2 - o2)],
        "text_start": [(n1_at, ts1 + o1), (n2_at, ts2 + o2)],
    }
    st = {}
    for name in SLOT_FIELDS:
        out = _shifted(getattr(state, name), d1, d2)
        for mask, val in patches.get(name, ()):
            out = torch.where(mask, val, out)
        st[name] = torch.where(new_at, new_vals[name], out)
    for name, fill in (("prop_key", NO_KEY), ("prop_val", 0)):
        out = _shifted(getattr(state, name), d1, d2)
        st[name] = torch.where(new_at[..., None], fill, out)

    # ---- remove/annotate target mask, on SHIFTED perspective arrays (no
    # second prefix pass). The insert slot never matters here: do_ins
    # excludes is_rem/is_ann.
    vis_out = _shifted(vis, d1, d2)
    cum_out = _shifted(cum, d1, d2)
    cum_out = torch.where(n1_at, c1 + o1, cum_out)
    cum_out = torch.where(n2_at, c2 + o2, cum_out)
    vlen_out = torch.where(vis_out, st["length"], 0)
    covered = vis_out & (cum_out >= pos) & (cum_out + vlen_out <= end)
    rm = is_rem & ~bad & covered
    rem_seq, rca, rcb = st["rem_seq"], st["rem_client_a"], st["rem_client_b"]
    fresh = rm & (rem_seq == NO_SEQ)
    # overlap: ops apply in seq order so the existing stamp is the
    # earliest; just record this client as an additional remover
    over = rm & (rem_seq != NO_SEQ)
    add_b = over & (rca != client) & (rcb == NO_CLIENT)
    third = over & (rca != client) & (rcb != client) & (rcb != NO_CLIENT)

    # ---- annotate: per-key LWW write (val == NO_VAL deletes the key);
    # the first matching entry, else the first empty one
    key, val = col(F_KEY)[..., None], col(F_VAL)[..., None]  # [D, 1, 1]
    an = is_ann & ~bad & covered
    prop_key, prop_val = st["prop_key"], st["prop_val"]
    match = prop_key == key  # [D, S, P]
    has_key = match.any(-1)
    empty = prop_key == NO_KEY
    has_empty = empty.any(-1)
    tgt = torch.where(has_key, _first_true(match)[..., 0],
                      _first_true(empty)[..., 0])
    is_delete = col(F_VAL) == NO_VAL
    do_write = an & (has_key | (~is_delete & has_empty))
    lanes = torch.arange(P, dtype=torch.int32, device=state.device)
    onehot = (lanes == tgt[..., None]) & do_write[..., None]
    # a slot that needs a (P+1)th distinct key cannot hold it → escalate
    table_full = (an & ~has_key & ~has_empty & ~is_delete).any(-1)
    del_row = is_delete[..., None]

    grew = s1i + s2.to(torch.int32) + do_ins.to(torch.int32)
    return DocState(
        length=st["length"],
        text_start=st["text_start"],
        flags=st["flags"],
        ins_seq=st["ins_seq"],
        ins_client=st["ins_client"],
        rem_seq=torch.where(fresh, seq, rem_seq),
        rem_client_a=torch.where(fresh, client, rca),
        rem_client_b=torch.where(add_b, client, rcb),
        prop_key=torch.where(onehot, torch.where(del_row, NO_KEY, key),
                             prop_key),
        prop_val=torch.where(onehot, torch.where(del_row, 0, val), prop_val),
        count=state.count + grew[:, 0],
        overflow=(state.overflow | third.any(-1) | table_full | bad[:, 0]),
    )


def apply_ops_batch_ref(state: DocState, ops: torch.Tensor) -> DocState:
    """Apply a NOOP-padded wave (int32 [D, K, OP_FIELDS]) to D docs, each
    doc's K ops in order: the plain version of the CUDA kernel, and the
    port of JAX ``apply_ops_batch`` / ``pallas_apply_ops_batch``."""
    for k in range(ops.shape[1]):
        state = _apply_core(state, ops[:, k, :])
    return state


def wave_min_seq(ops: torch.Tensor) -> torch.Tensor:
    """Per-doc zamboni floor for a [D, K, OP_FIELDS] wave: the msn of the
    LAST real op applied to each doc. msn is monotone per doc and NOOP
    padding carries a lower msn, so this is the max over the wave. Using
    the wave's own msn keeps compaction safe while later-sequenced ops are
    still staged on the host."""
    return ops[..., F_MSN].amax(dim=-1)


def unpack_wave16(wave16: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Widen a packed int16 [D, K, F] delta wave plus its int32 [D, 2]
    (seq_base, text_base) to the kernel's int32 field layout."""
    w = wave16.to(torch.int32)
    typ = w[..., F_TYPE]
    seq = bases[:, :1] + w[..., F_SEQ]
    ref = seq - w[..., F_REFSEQ]
    msn = torch.where(typ == OP_NOOP, NOOP_MSN, seq - w[..., F_MSN])
    client = w[..., F_CLIENT]
    client = torch.where(client == PACK_SYSTEM, SYSTEM_CLIENT, client)
    tstart = bases[:, 1:] + w[..., F_TSTART]
    return torch.stack(
        [typ, w[..., F_POS], w[..., F_END], seq, ref, client,
         w[..., F_TLEN], tstart, msn, w[..., F_FLAGS],
         w[..., F_KEY], w[..., F_VAL]], dim=-1)


def pack_wave_rows(flat, starts, lens_a):
    """Host-side twin of ``unpack_wave16`` over concatenated staged rows.

    ``flat`` is int32 [n, OP_FIELDS] (all docs' rows back to back),
    ``starts``/``lens_a`` delimit each doc's run. Returns
    ``(packed int64 [n, F], seq_base [m], text_base [m])``; the caller
    checks the int16 range and scatters ``packed`` into its wave
    buffers. Bases: seq of the doc's first row; min text_start over its
    insert rows (text_start of non-inserts is unused — packed 0)."""
    seq_base = flat[starts, F_SEQ]
    is_ins = flat[:, F_TYPE] == OP_INSERT
    tstart_or_inf = np.where(is_ins, flat[:, F_TSTART], np.int64(2 ** 62))
    text_base = np.minimum.reduceat(tstart_or_inf, starts)
    text_base = np.where(text_base == 2 ** 62, 0, text_base).astype(np.int64)

    n = len(flat)
    seq = flat[:, F_SEQ].astype(np.int64)
    seq_base_row = np.repeat(seq_base.astype(np.int64), lens_a)
    text_base_row = np.repeat(text_base, lens_a)
    packed = np.empty((n, OP_FIELDS), np.int64)
    packed[:, F_TYPE] = flat[:, F_TYPE]
    packed[:, F_POS] = flat[:, F_POS]
    packed[:, F_END] = flat[:, F_END]
    packed[:, F_SEQ] = seq - seq_base_row
    packed[:, F_REFSEQ] = seq - flat[:, F_REFSEQ]
    client = flat[:, F_CLIENT]
    # a REAL interned id of 32767 would collide with the sentinel and be
    # re-attributed to the system client on unpack: force it onto the
    # wide path via an out-of-range value
    packed[:, F_CLIENT] = np.where(
        client == SYSTEM_CLIENT, PACK_SYSTEM,
        np.where(client == PACK_SYSTEM, np.int64(1) << 40, client))
    packed[:, F_TLEN] = flat[:, F_TLEN]
    packed[:, F_TSTART] = np.where(
        is_ins, flat[:, F_TSTART] - text_base_row, 0)
    packed[:, F_MSN] = seq - flat[:, F_MSN]
    packed[:, F_FLAGS] = flat[:, F_FLAGS]
    packed[:, F_KEY] = flat[:, F_KEY]
    packed[:, F_VAL] = flat[:, F_VAL]
    return packed, seq_base, text_base


def compact_batch(state: DocState, min_seq: torch.Tensor) -> DocState:
    """Zamboni: per doc, drop slots whose remove seq ≤ ``min_seq`` [D] (no
    future perspective can see them; ref mergeTree.ts:1455) and re-pack
    the kept slots in order."""
    S = state.max_slots
    i = torch.arange(S, dtype=torch.int32, device=state.device)[None, :]
    in_use = i < state.count[:, None]
    drop = in_use & (state.rem_seq != NO_SEQ) & (
        state.rem_seq <= min_seq[:, None])
    keep = in_use & ~drop
    # kept slots first, in order (the keys are distinct; stable anyway)
    order = torch.argsort(torch.where(keep, i, S + i), dim=-1, stable=True)
    new_count = keep.sum(-1, dtype=torch.int32)
    live = i < new_count[:, None]

    def g(a, fill):
        if a.ndim == 3:
            idx = order[..., None].expand(-1, -1, a.shape[-1])
            return torch.where(live[..., None], torch.gather(a, 1, idx), fill)
        return torch.where(live, torch.gather(a, 1, order), fill)

    return DocState(
        length=g(state.length, 0),
        text_start=g(state.text_start, 0),
        flags=g(state.flags, 0),
        ins_seq=g(state.ins_seq, 0),
        ins_client=g(state.ins_client, NO_CLIENT),
        rem_seq=g(state.rem_seq, NO_SEQ),
        rem_client_a=g(state.rem_client_a, NO_CLIENT),
        rem_client_b=g(state.rem_client_b, NO_CLIENT),
        prop_key=g(state.prop_key, NO_KEY),
        prop_val=g(state.prop_val, 0),
        count=new_count,
        overflow=state.overflow,
    )
