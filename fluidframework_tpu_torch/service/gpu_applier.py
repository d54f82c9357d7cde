"""GpuDocumentApplier: the batched server-side merge-tree replica farm.

JAX counterpart: ``fluidframework_tpu/service/tpu_applier.py::
TpuDocumentApplier``, its doc-sharded mesh lane included, with
``save_applier_checkpoint`` / ``load_applier_checkpoint`` writing and
reading the JAX package's checkpoint format byte for byte.
The service keeps thousands of documents as ONE device-resident
structure-of-arrays batch (``ops/doc_state.DocState`` with a leading doc
dimension) and applies every sequenced merge-tree op to it in waves of up
to K ops per doc.

The batch lives as a list of shard states, shard-major. Without a mesh
there is one shard on ``device``. With ``mesh=`` (a ``parallel.mesh.Mesh``,
or an int: that many shards on the cards, or on ``[device] * n`` when
``device`` is named) the docs axis is cut into the mesh's docs shards, each
on its own device (several may share one), and ``DocPlacement`` routes a
doc to a (shard, slot) whose global row is ``shard * slots_per_shard +
slot``. Every wave takes one dispatch lane, whatever the shard count.

Ingest records each array boxcar by reference (``ingest_array_batch``)
and does nothing else with it; a flush first packs every boxcar recorded
since the last one (``_pack``): its bookkeeping (coverage, client
interning, the text arena, property interning) in arrival order, and its
op rows in one columnar pass, one chunk a doc. The dict lane
(``ingest_batch``) packs what is recorded first, then stages its rows as
it goes. A dispatch then has two halves. The host half
(``_stage_wave``, ``_stage_rows``) packs the wave's rows
(``ops/apply.pack_wave_rows``) into int16 deltas plus int32 per-doc bases,
and scatters each ACTIVE shard's rows into its [docs per shard, K, 12]
block of one of two rotating sets of pinned host buffers, with its
[docs per shard, 2] bases; each block is copied to its shard's device with
``non_blocking`` on the applier's stream there. An inactive shard gets a
zero block already resident on its device. With one shard that is one
[D, K, 12] wave and [D, 2] bases, and nothing is sorted; with several the
wave's docs are first sorted by shard, so each shard's rows are one slice
(staged bytes scale with active shards, never with ``max_docs``). A wave
whose deltas escape int16 (a giant doc, a huge window, the chaos
``force_wide`` seam) ships at full int32 width instead, without bases.
The device half (``_execute_wave``) runs ``parallel/sharded_apply.
apply_wave`` (unpack → ``ops/cuda_apply.apply_ops_batch``, the
hand-written CUDA kernel → ``compact_batch`` at ``wave_min_seq``) on each
shard's stream and records a CUDA event after it on each. With
``overlap`` on (the default) nothing waits for the card, so the host
stages wave N+1 while wave N runs; with it off every step is fenced.
Dropped from the JAX mesh lane as TPU/XLA artifacts: ``NamedSharding``
assembly, donation, the Pallas tile rule (docs per shard % 8) and the
staging thread pool (the copies are asynchronous already).

Fences, all on CUDA events recorded on the applier's streams (one stream
and one event a step for each distinct device of the farm):
- a staging set is handed out again only after the event of the step
  that consumed it has completed (``_rotate_stage_buffers``), and that
  wait comes before the set is zeroed: the pinned memory may still be
  the source of an in-flight copy;
- ``_drain_device`` waits for the last step's event (escalation, the
  width flip of a forced wide wave, ``finalize``, ``close``);
- every read of device state (the overflow poll, ``get_text``,
  ``get_tree``, ``get_properties_at``, ``slot_count``) runs with the
  applier's streams current on the reading thread (``_on_streams``), so
  its device→host copy is ordered after every step enqueued there. State
  tensors are made and freed on those streams, so the caching allocator
  never hands a block to another stream while a step still reads it.

With ``async_dispatch`` a worker thread owns staging, execution and the
periodic overflow poll (it defers escalation to the caller's next sync
point); the caller's thread only records boxcars and stages chunks
under a lock, packing at ``flush`` and ``finalize``.
``min_wave_ops`` holds the worker back until that many ops are staged
(unless draining). An exception on the worker is stored and re-raised by
the next ``flush``, ``finalize`` or ``close``; a dead worker never leaves
``finalize`` waiting.

Semantics guardrails (as in the JAX package):
- Ops ingest ONLY from the sequenced stream, so the server-side invariants
  hold (every stamp below the incoming seq; tie-break = earliest
  boundary — see ops/apply.py).
- Anything the kernel does not model (slot capacity, a third concurrent
  remover, a full property table) sets the doc's sticky overflow flag.
  The flags are polled every ``overflow_check_every`` dispatches and
  before any read; a flagged doc is replayed from its authoritative op log
  (``set_replay_source``) on the scalar oracle (``mergetree/``) and stays
  on the host from then on.
- Every staged op carries the msn deli stamped on it, so zamboni runs
  after every wave at the exact collaboration-window floor.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import ExitStack
from dataclasses import replace
from typing import Optional, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..mergetree.client import MergeTreeClient
from ..obs import get_registry
from ..ops.apply import (
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
    OP_ANNOTATE,
    OP_FIELDS,
    OP_INSERT,
    OP_REMOVE,
    SYSTEM_CLIENT,
    pack_wave_rows,
)
from ..ops.doc_state import (
    FIELDS,
    FLAG_MARKER,
    NO_KEY,
    NO_SEQ,
    DocState,
    PropTable,
    TextArena,
    decode_state,
    merge_settled_runs,
    state_from_numpy,
)
from ..parallel.mesh import Mesh, make_mesh, virtual_devices
from ..parallel.placement import DocPlacement
from ..parallel.sharded_apply import (
    apply_wave,
    profiler_scope,
    shard_state,
    unshard_state,
)
from ..protocol.messages import MessageType
from ..utils.affinity import blocking
from ..utils.telemetry import SPANS, tracing
from .array_batch import KIND_ANNOTATE
from .scriptorium import channel_stream  # noqa: F401  (torch-free home)

MARKER_GLYPH = "￼"  # arena placeholder byte for markers (flags classify)

INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1

_ONE_JSON_TEXT = (int, str, bool)  # one JSON text a (type, value)

# the farm's spans (utils/telemetry.SPANS)
INGEST_SPAN = SPANS.name_id("applier.ingest")
PACK_SPAN = SPANS.name_id("applier.pack")
TAKE_SPAN = SPANS.name_id("applier.take")
STAGE_SPAN = SPANS.name_id("applier.stage")
EXECUTE_SPAN = SPANS.name_id("applier.execute")
SYNC_SPAN = SPANS.name_id("applier.sync")
REPACK_SPAN = SPANS.name_id("applier.repack")


def _one_key(props) -> bool:
    """Whether an annotate's props take the columnar pass: one key (an
    annotate of several keys is one device op a key, on the per-op
    lane)."""
    return props is not None and len(props) == 1


def _takes_per_op(box) -> bool:
    """Whether an array boxcar has an annotate the columnar pass does not
    take (``_one_key``)."""
    props = box.props
    return any(props is None or not _one_key(props[i]) for i in
               np.flatnonzero(np.asarray(box.kind) == KIND_ANNOTATE).tolist())


def repack_watermark(max_slots: int, ops_per_dispatch: int) -> int:
    """A doc counted above this many slots before a wave is repacked
    first: S − 2K. An op row makes at most two slots, so a doc at or
    under it takes a whole wave of K rows without reaching S."""
    return max_slots - 2 * ops_per_dispatch


def repack_ceiling(max_slots: int, ops_per_dispatch: int) -> int:
    """The most slots a repack should leave a doc with: S − 4K. At two
    slots a row, a doc at or under it takes at least K more rows, a whole
    wave, before it passes the watermark again. A doc that merges to
    more (a lagging client holds the msn back, or its props differ run by
    run) is repacked again only once it has grown 2K slots, a wave's
    worth, past what the repack left (the thrash guard: never every
    wave); if it fills S first, the kernel's flag sends it to the host,
    the last resort. A farm where this is not positive (S ≤ 4K) repacks
    nothing: a doc there that outgrows S escalates."""
    return max_slots - 4 * ops_per_dispatch


_TORCH_DTYPE = {np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


class _StagedWave:
    """The output of the stage half of a dispatch: device-resident input
    tensors plus what the execute half needs to run and account for the
    wave. Holding one of these means the wave's ops have LEFT the staged
    dict but have not yet been issued to the device."""

    __slots__ = ("wide", "arrays", "n", "nbytes", "flip")

    def __init__(self, wide: bool, arrays: list, n: int, nbytes: int,
                 flip: int):
        self.wide = wide        # int32 escape lane (range / force_wide)
        self.arrays = arrays    # each shard's device inputs, a tuple a shard
        self.n = n              # op rows in the wave
        self.nbytes = nbytes    # host bytes staged
        self.flip = flip        # which staging-buffer set holds the wave


class GpuDocumentApplier:
    """Maintains [D, S] doc states, fed by sequenced op streams, on one
    device or over a mesh's docs shards. ``device`` defaults to ``cuda``
    and raises without a card; ``device="cpu"`` runs the plain PyTorch
    versions. ``mesh`` is a ``Mesh`` (then ``device`` stays None) or an
    int shorthand for a docs-only mesh of that many shards."""

    #: chaos seam: forced device escalations — the int32 wide dispatch
    #: path and the overflow-to-host flip — so the rare lanes run under a
    #: soak, not only when a doc organically exceeds int16 / device
    #: capacity. A callable ``(seam, **info) -> directive``; None =
    #: disarmed, one branch.
    fault_plane = None

    def __init__(
        self,
        max_docs: Optional[int] = None,
        max_slots: Optional[int] = None,
        ops_per_dispatch: Optional[int] = None,
        overflow_check_every: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        async_dispatch: bool = False,
        min_wave_ops: Optional[int] = None,
        overlap: Optional[bool] = None,
        mesh: Union[Mesh, int, None] = None,
    ):
        cfg = Config.from_env()
        self.max_docs = (max_docs if max_docs is not None
                         else cfg.applier_max_docs)
        self.max_slots = (max_slots if max_slots is not None
                          else cfg.applier_max_slots)
        self.K = (ops_per_dispatch if ops_per_dispatch is not None
                  else cfg.applier_ops_per_dispatch)
        # reading the overflow flags is a device→host sync, so flush()
        # polls them only every N dispatches. Deferral is safe: the flag
        # is sticky and escalation replays the doc from its log; reads and
        # finalize() always check first.
        self.overflow_check_every = (
            overflow_check_every if overflow_check_every is not None
            else cfg.applier_overflow_check_every)
        self._dispatches_since_check = 0
        # an int mesh is shorthand for a docs-only mesh of that many
        # shards: over the cards (raising if there are too few), or all on
        # the named device
        if isinstance(mesh, int):
            mesh = make_mesh(mesh, devices=None if device is None
                             else virtual_devices(mesh, device))
        elif mesh is not None and device is not None:
            raise ValueError("a Mesh names its own devices: pass mesh= or "
                             "device=, not both")
        self._mesh = mesh
        self._lane = "dense" if mesh is None else "mesh"  # metrics label
        # the doc→shard routing table (partition-router role): shard s
        # owns the contiguous state rows [s * sps, (s + 1) * sps)
        if mesh is not None:
            n_shards = mesh.shape["docs"]
            if self.max_docs % n_shards:
                raise ValueError(
                    f"max_docs={self.max_docs} not divisible by the mesh's "
                    f"docs axis ({n_shards})")
            self.placement = DocPlacement(
                n_shards=n_shards, slots_per_shard=self.max_docs // n_shards)
            self._shard_devices = [mesh.shard_device(s)
                                   for s in range(n_shards)]
            self.device = self._shard_devices[0]
        else:
            self.device = resolve_device(device)
            self.placement = DocPlacement(n_shards=1,
                                          slots_per_shard=self.max_docs)
            self._shard_devices = [self.device]
        # the applier's own streams, one per distinct device: every copy,
        # step and state read of this farm is ordered on them (none on
        # the CPU); _stream is the first device's
        self._streams = {d: torch.cuda.Stream(device=d)
                         for d in dict.fromkeys(self._shard_devices)
                         if d.type == "cuda"}
        self._stream = self._streams.get(self.device)
        sps = self.max_docs // len(self._shard_devices)
        with self._on_streams():
            # the farm's state, one DocState a shard, shard-major
            self._shards = [DocState.empty(sps, self.max_slots, device=d)
                            for d in self._shard_devices]
        # a mesh farm's staging counters: per-wave staged bytes scale
        # with ACTIVE shards, never with max_docs
        self.mesh_waves = 0
        self.mesh_active_shards = 0
        self.mesh_staged_bytes = 0
        # per-device resident zero blocks, reused every wave for INACTIVE
        # shards (no host allocation, no copy); a farm of one shard has
        # none
        self._zero_shards: dict = {}
        self.arenas = [TextArena() for _ in range(self.max_docs)]
        self.prop_table = PropTable()  # shared across docs; ids are dense
        # (table, {(type, value): id}): see _intern_val
        self._val_memo = (self.prop_table, {})
        # per-doc dense client interning (collision-free by construction)
        self._client_ids: dict[int, dict[str, int]] = {}
        # staged device ops per slot: a list of int32 [n, OP_FIELDS]
        # chunks (one per dict-lane batch, one per slot a pack);
        # _staged_ops is the row count
        self._staged: dict[int, list] = {}
        self._staged_ops = 0
        # array boxcars (SequencedArrayBatch) recorded since the last
        # pack, per slot in arrival order, and the slot of each in global
        # arrival order (property ids are global, so the pack interns in
        # that order)
        self._pending: dict[int, list] = {}
        self._arrivals: list[int] = []
        self._host_docs: dict[int, MergeTreeClient] = {}  # escalated docs
        self._doc_keys: dict[int, tuple[str, str]] = {}
        # the host replay source: fn(tenant, doc) -> iterable of
        # CHANNEL-LEVEL sequenced merge-tree messages
        self._replay_log = None
        # coverage tracking for summary writers: _applied_seq = highest
        # ingested seq per slot; _first_seq = first ingested seq per slot;
        # _anchored = slots whose state provably covers the doc's WHOLE
        # history (a caller's coverage proof). _restore_applied and
        # _post_restore_first carry a checkpoint restore's window, which
        # the summarizer must see closed (restore_gap);
        # load_applier_checkpoint opens it, mark_anchored discharges it.
        # Recorded boxcars enter them when the pack takes them; until
        # then the readers add them from _pending.
        self._applied_seq: dict[int, int] = {}
        self._first_seq: dict[int, int] = {}
        self._anchored: set[int] = set()
        self._restore_applied: dict[int, int] = {}
        self._post_restore_first: dict[int, int] = {}
        # ---- overlap-staged dispatch (stage/execute split) ----
        # Two rotating sets of pinned host staging buffers: wave N+1
        # scatters into one set while the other's copy (wave N) may still
        # be in flight — _rotate_stage_buffers fences a set's last step
        # before handing it out again.
        self._overlap = overlap if overlap is not None else cfg.applier_overlap
        self._stage_pool: tuple = ({}, {})
        self._stage_inflight: list = [None, None]
        self._stage_flip = 0
        # the last step's completion events, one per device: query() is
        # the non-blocking "device still executing" probe of the overlap
        # accounting; _drain_device() waits on them at seams
        self._exec_markers: list = []
        self.stage_seconds = 0.0
        self.stage_overlap_seconds = 0.0
        self.stage_bytes = 0
        self.exec_seconds = 0.0
        self.waves_staged = 0
        self.last_wave_hops: Optional[tuple[float, float]] = None
        self._last_stage_wall: Optional[float] = None
        self._registry = None
        self.dispatches = 0
        self.wide_dispatches = 0
        self.ops_applied = 0
        self.host_escalations = 0
        # ops applied on host replicas that no wave applied: an escalated
        # doc's replay past its last dispatched row, and what follows it
        self.host_ops_applied = 0
        # the repack (zamboni's merge of settled neighbours) at a slot
        # watermark: _bound is an upper bound on each doc's slot count
        # (the count at the last read, 2 a row dispatched since);
        # _applied_msn and _dispatched_seq are the msn and seq of each
        # doc's last dispatched row (msn -1: none since the farm was made
        # or loaded, so nothing is known settled)
        self._watermark = repack_watermark(self.max_slots, self.K)
        self._ceiling = repack_ceiling(self.max_slots, self.K)
        self._bound = np.zeros(self.max_docs, np.int64)
        # the thrash guard: a doc whose last repack left it above the
        # ceiling is repacked again only past this count (0: no such doc)
        self._retry_at = np.zeros(self.max_docs, np.int64)
        self._applied_msn = np.full(self.max_docs, -1, np.int64)
        self._dispatched_seq = np.zeros(self.max_docs, np.int64)
        self.doc_repacks = np.zeros(self.max_docs, np.int64)  # by row
        self.repack_slots_in = 0
        self.repack_slots_out = 0
        self.repack_escalations = 0
        # async: docs the worker found over the watermark before a wave,
        # and the wave's taken chunks: the worker waits (_repack_done)
        # until the caller repacks them at its next sync point; _paused
        # holds the worker off while the caller does
        self._repack_slots: set[int] = set()
        self._repack_taken: dict = {}
        self._repack_done = threading.Event()
        self._repack_done.set()
        self._paused = False
        # async mode: a worker thread owns wave building, the copy and
        # dispatch, so the ordering pipeline never waits on the card. The
        # worker is the ONLY state mutator; the caller's thread stages
        # chunks under the lock and escalates at sync points (the worker
        # defers overflow escalation to `_overflow_slots`).
        self._async = async_dispatch
        # below this many staged ops the worker holds off dispatching
        # (unless draining): a step costs about the same whether waves are
        # full or nearly empty
        self._min_wave = (min_wave_ops if min_wave_ops is not None
                          else cfg.applier_min_wave_ops)
        self._draining = False
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        if async_dispatch:
            self._wake = threading.Event()
            self._idle = threading.Event()
            self._idle.set()
            self._stop = False
            self._overflow_slots: set[int] = set()
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="gpu-applier")
            self._worker.start()

    # ------------------------------------------------------------- ingest

    def slot_of(self, tenant_id: str, document_id: str) -> int:
        """Global state row of a doc: the placement's (shard, slot)
        flattened shard-major, so rows route to their owning shard."""
        shard, slot = self.placement.place(tenant_id, document_id)
        row = shard * self.placement.slots_per_shard + slot
        self._doc_keys.setdefault(row, (tenant_id, document_id))
        return row

    def ingest(self, tenant_id: str, document_id: str, msg,
               wire_op: dict) -> None:
        """Stage one sequenced merge-tree wire op for batched apply."""
        self.ingest_batch(tenant_id, document_id, [(msg, wire_op)])

    def ingest_batch(self, tenant_id: str, document_id: str,
                     pairs: list) -> None:
        """Stage a broadcast batch of (sequenced message, wire op) pairs of
        one doc, in seq order. Staging is tuple appends; one array per
        batch. Recorded array boxcars are packed first: they arrived
        before it, and property ids are global."""
        traced = tracing()
        span = SPANS.begin(INGEST_SPAN) if traced else None
        try:
            if self._pending:
                self._pack()
            slot = self.slot_of(tenant_id, document_id)
            if pairs:
                # sequenced stream ⇒ pairs arrive in seq order; the last
                # is max
                self._cover(slot, pairs[0][0].sequence_number,
                            pairs[-1][0].sequence_number)
            if self.fault_plane is not None and slot not in self._host_docs:
                if self.fault_plane("applier.ingest", slot=slot) \
                        == "escalate_host":
                    # forced overflow-to-host flip: same path a doc takes
                    # when it outgrows device capacity — replays the
                    # authoritative log into a host replica, then applies
                    # this batch host-side below
                    self._escalate(slot, None, None)
            if slot in self._host_docs:
                for msg, wire_op in pairs:
                    self._apply_host(slot, msg, wire_op)
                return
            staged = []
            table = self._client_ids.setdefault(slot, {})
            arena = self.arenas[slot]
            # hot-loop locals: plain inserts/removes (the bulk of real
            # traffic) stage inline without the _stage_op dispatch
            append = staged.append
            arena_append = arena.append
            table_get = table.get
            for i, (msg, wire_op) in enumerate(pairs):
                if type(wire_op) is not dict:
                    ok = False
                else:
                    cid = msg.client_id
                    if cid is None:
                        client = SYSTEM_CLIENT
                    else:
                        client = table_get(cid)
                        if client is None:
                            client = len(table)
                            table[cid] = client
                    t = wire_op.get("type")
                    if t == 0 and "marker" not in wire_op \
                            and not wire_op.get("props"):
                        text = wire_op.get("text") or ""
                        append((OP_INSERT, wire_op["pos"], 0,
                                msg.sequence_number,
                                msg.reference_sequence_number, client,
                                len(text), arena_append(text),
                                msg.minimum_sequence_number, 0, 0, 0))
                        continue
                    if t == 1:
                        append((OP_REMOVE, wire_op["start"], wire_op["end"],
                                msg.sequence_number,
                                msg.reference_sequence_number, client, 0, 0,
                                msg.minimum_sequence_number, 0, 0, 0))
                        continue
                    ok = self._stage_op(
                        staged, arena, wire_op, msg.sequence_number,
                        msg.reference_sequence_number, client,
                        msg.minimum_sequence_number)
                if not ok:
                    # escalation replays the authoritative log (which already
                    # holds this batch) and discards partial staging
                    self._escalate(slot, msg, wire_op)
                    for msg2, wire_op2 in pairs[i + 1:]:
                        self._apply_host(slot, msg2, wire_op2)
                    return
            if staged:
                self._push_chunk(slot, np.asarray(staged, np.int32))
                if traced:
                    SPANS.count("applier.ingest.direct_rows", len(staged))
        finally:
            if span is not None:
                SPANS.end(span)

    def ingest_array_batch(self, tenant_id: str, document_id: str,
                           batch) -> None:
        """Record a SequencedArrayBatch (``service/array_batch.py``) by
        reference for the next flush, and do nothing else with it: the
        flush's ``_pack`` does the bookkeeping of every recorded boxcar
        (coverage, client interning, the arena append, the annotates'
        property interning) in arrival order and packs their op rows in
        one columnar pass. A doc already on the host applies the boxcar
        there at once."""
        traced = tracing()
        span = SPANS.begin(INGEST_SPAN) if traced else None
        try:
            slot = self.slot_of(tenant_id, document_id)
            if not batch.n:
                return
            if slot in self._host_docs:
                self._cover(slot, batch.base_seq, batch.last_seq)
                self._apply_host_batch(slot, batch)
                return
            with self._lock:
                group = self._pending.get(slot)
                if group is None:
                    self._pending[slot] = [batch]
                else:
                    group.append(batch)
                self._arrivals.append(slot)
            if traced:
                SPANS.count("applier.ingest.deferred", 1)
        finally:
            if span is not None:
                SPANS.end(span)

    def _cover(self, slot: int, first: int, last: int) -> None:
        """Coverage of ingested seqs ``first`` to ``last`` of doc
        ``slot``."""
        if self._applied_seq.get(slot, 0) < last:
            self._applied_seq[slot] = last
        self._first_seq.setdefault(slot, first)
        if slot in self._restore_applied:
            self._post_restore_first.setdefault(slot, first)

    def _apply_host_batch(self, slot: int, batch) -> None:
        """Apply an array boxcar to doc ``slot``'s host replica."""
        box = batch.boxcar
        for i in range(batch.n):
            self._apply_host(slot, batch.message(i), box.wire_op(i))

    def _intern_val(self, value) -> int:
        """``prop_table.intern_val`` behind a memo of scalar values. The
        table canonicalises every value through ``json.dumps``, which
        costs more than the rest of a boxcar's ingest; an int, str or
        bool has one JSON text a (type, value), so the memo answers the
        id the table would. Other values go to the table."""
        table = self.prop_table
        if self._val_memo[0] is not table:  # a checkpoint load swaps it
            self._val_memo = (table, {})
        if type(value) not in _ONE_JSON_TEXT:
            return table.intern_val(value)
        memo = self._val_memo[1]
        key = (type(value), value)
        vid = memo.get(key)
        if vid is None:
            vid = memo[key] = table.intern_val(value)
        return vid

    def _pack(self) -> None:
        """Take every recorded array boxcar off the record and do what
        its arrival asks: coverage, for all of them at once as they
        leave; then the columnar pass (``_pack_run``). Where a boxcar
        cannot take that pass, the boxcars go in global arrival order
        instead (``_pack_in_order``). Takes the lock to swap the record
        and to stage the rows (the async worker reads the staged
        chunks)."""
        with self._lock:
            pending, self._pending = self._pending, {}
            arrivals, self._arrivals = self._arrivals, []
            for slot, group in pending.items():
                self._cover(slot, group[0].base_seq,
                            max([b.last_seq for b in group]))
        if not pending:
            return
        span = SPANS.begin(PACK_SPAN, request=True) if tracing() else None
        try:
            total = self._pack_run(pending, arrivals)
            if total is None:
                total = self._pack_in_order(pending, arrivals)
        finally:
            if span is not None:
                SPANS.end(span)
        if span is not None:
            SPANS.count("applier.ingest.packed_rows", total)

    def _pack_run(self, pending: dict, arrivals: list) -> Optional[int]:
        """The columnar pass over recorded boxcars ``pending`` (slot →
        its batches in arrival order; ``arrivals``: the slot of each
        boxcar in global arrival order): one concatenation a field, seqs,
        clients and arena starts by repeat, annotate keys and values in
        one assignment. Clients are interned and texts appended to the
        arena a doc at a time, property keys and values in global arrival
        order, so every id and offset is the one a pack of each boxcar at
        its arrival gives. Each slot gets one contiguous chunk after
        whatever it has staged already. Returns the rows staged; or None,
        having changed nothing, when an annotate carries other than one
        prop key (that boxcar takes the per-op lane)."""
        groups = list(pending.items())
        batches = [b for _slot, group in groups for b in group]
        b = len(batches)
        boxes = [x.boxcar for x in batches]
        ns = np.fromiter([x.n for x in batches], np.int64, b)
        ends = np.cumsum(ns)
        starts = ends - ns
        total = int(ends[-1])
        kinds = np.concatenate([bx.kind for bx in boxes])
        ann = np.flatnonzero(kinds == KIND_ANNOTATE)
        box_of = np.searchsorted(ends, ann, side="right")
        props = []
        for i, r in zip(box_of.tolist(), (ann - starts[box_of]).tolist()):
            p = boxes[i].props
            p = None if p is None else p[r]
            if not _one_key(p):
                return None
            props.append(p)
        clients, arena_starts = [], []
        for slot, group in groups:
            table = self._client_ids.setdefault(slot, {})
            arena_append = self.arenas[slot].append
            for x in group:
                box = x.boxcar
                clients.append(table.setdefault(box.client_id, len(table)))
                arena_starts.append(arena_append(box.text))
        rows = np.zeros((total, OP_FIELDS), np.int32)
        # wire kinds (0 ins, 1 rem, 2 ann) → op codes (1, 2, 3)
        rows[:, F_TYPE] = kinds.astype(np.int32) + 1
        rows[:, F_POS] = np.concatenate([bx.a for bx in boxes])
        rows[:, F_END] = np.concatenate([bx.b for bx in boxes])
        base = np.fromiter([x.base_seq for x in batches], np.int64, b)
        rows[:, F_SEQ] = (np.repeat(base - starts, ns)
                          + np.arange(total, dtype=np.int64))
        rows[:, F_REFSEQ] = np.concatenate([bx.rseq for bx in boxes])
        rows[:, F_CLIENT] = np.repeat(np.asarray(clients, np.int64), ns)
        rows[:, F_MSN] = np.concatenate([x.msns for x in batches])
        # a boxcar's n + 1 text offsets close with its text's length; the
        # closing ones are no row's
        offs = np.concatenate([bx.text_off for bx in boxes])
        opens = np.ones(len(offs), bool)
        opens[ends + np.arange(b)] = False
        rows[:, F_TLEN] = np.diff(offs)[opens[:-1]]
        rows[:, F_TSTART] = np.repeat(np.asarray(arena_starts, np.int64),
                                      ns) + offs[opens]
        if props:
            # the boxcars' arrival indices, grouped as the rows are: a
            # stable sort of the arrivals by their slot's group
            rank = {slot: g for g, (slot, _group) in enumerate(groups)}
            arrival = np.argsort(np.fromiter(
                [rank[slot] for slot in arrivals], np.int64, b),
                kind="stable")
            keys, vals = [0] * len(props), [0] * len(props)
            intern_key = self.prop_table.intern_key
            for j in np.argsort(arrival[box_of], kind="stable").tolist():
                (k, v), = props[j].items()
                keys[j] = intern_key(k)
                vals[j] = NO_VAL if v is None else self._intern_val(v)
            rows[ann, F_KEY] = keys
            rows[ann, F_VAL] = vals
        with self._lock:
            lo = 0
            for (slot, _group), hi in zip(groups, ends[np.cumsum(
                    [len(group) for _slot, group in groups]) - 1].tolist()):
                self._staged.setdefault(slot, []).append(rows[lo:hi])
                lo = hi
            self._staged_ops += total
        return total

    def _pack_in_order(self, pending: dict, arrivals: list) -> int:
        """``_pack`` where a boxcar cannot take the columnar pass: the
        boxcars in global arrival order, a boxcar whose annotates carry
        other than one prop key on the per-op lane (``ingest_batch``), one
        of a doc on the host applied there (a doc the per-op lane sent
        there), and each run of boxcars between such through
        ``_pack_run``. Returns the rows the runs staged."""
        boxcars = {slot: iter(group) for slot, group in pending.items()}
        total = 0
        run, order = {}, []
        for slot in arrivals:
            batch = next(boxcars[slot])
            host = slot in self._host_docs
            if host or _takes_per_op(batch.boxcar):
                if run:
                    total += self._pack_run(run, order)
                    run, order = {}, []
                if host:
                    self._apply_host_batch(slot, batch)
                else:
                    box = batch.boxcar
                    self.ingest_batch(*self._doc_keys[slot], [
                        (batch.message(i), box.wire_op(i))
                        for i in range(batch.n)])
                continue
            run.setdefault(slot, []).append(batch)
            order.append(slot)
        if run:
            total += self._pack_run(run, order)
        return total

    def _push_chunk(self, slot: int, chunk: np.ndarray) -> None:
        """Append a staged [n, OP_FIELDS] chunk of the dict lane (with
        _pack_run, the ONLY staging-count mutation points besides
        _take_wave_locked/_drop_staged)."""
        with self._lock:
            self._staged.setdefault(slot, []).append(chunk)
            self._staged_ops += len(chunk)

    def _drop_staged(self, slot: int) -> None:
        """Discard a slot's staged chunks (escalation path: the replay
        holds them), keeping the staged-op count consistent. Recorded
        boxcars are packed first, so that their bookkeeping (coverage,
        the doc's clients and arena, property ids) stands as if each had
        been staged at its arrival."""
        if slot in self._pending:
            self._pack()
        with self._lock:
            dropped = self._staged.pop(slot, None)
            if dropped:
                self._staged_ops -= sum(len(c) for c in dropped)

    def _stage_op(self, staged, arena, w, seq, ref, client, msn) -> bool:
        """Append a wire op's device tuples (ops/apply field order).
        Returns False when the kernel does not model the op."""
        t = w.get("type")
        if t == 0:  # insert
            pos = w["pos"]
            if w.get("marker") is not None:
                start = arena.append(MARKER_GLYPH)
                tlen = 1
                staged.append((OP_INSERT, pos, 0, seq, ref, client,
                               1, start, msn, FLAG_MARKER, 0, 0))
            else:
                text = w.get("text") or ""
                start = arena.append(text)
                tlen = len(text)
                staged.append((OP_INSERT, pos, 0, seq, ref, client,
                               tlen, start, msn, 0, 0, 0))
            props = w.get("props")
            if props:
                # insert-with-props: at the insert's OWN perspective the
                # visible span [pos, pos+len) is exactly the new slot, so
                # follow-up annotates stamp precisely it
                self._stage_annotate(
                    staged, pos, pos + tlen, props, seq, ref, client, msn)
            return True
        if t == 1:  # remove
            staged.append((OP_REMOVE, w["start"], w["end"], seq, ref, client,
                           0, 0, msn, 0, 0, 0))
            return True
        if t == 2:  # annotate
            self._stage_annotate(staged, w["start"], w["end"], w["props"],
                                 seq, ref, client, msn)
            return True
        if t == 3:  # group: all-or-nothing (partial staging is discarded
            # by _escalate if a sub-op is unsupported)
            return all(
                self._stage_op(staged, arena, sub, seq, ref, client, msn)
                for sub in w["ops"])
        if t == "interval":
            return True  # interval metadata: no effect on text content
        return False

    def _stage_annotate(self, staged, start, end, props, seq, ref, client,
                        msn) -> None:
        # one device op per key; in-order apply gives per-key LWW
        intern_key = self.prop_table.intern_key
        intern_val = self.prop_table.intern_val
        for k, v in props.items():
            staged.append((OP_ANNOTATE, start, end, seq, ref, client, 0, 0,
                           msn, 0, intern_key(k),
                           NO_VAL if v is None else intern_val(v)))

    # -------------------------------------------------------------- flush

    def flush(self) -> int:
        """Dispatch every staged op to the device in [D, K] waves.

        In async mode this only wakes the worker (after re-raising a
        stored worker exception); in sync mode it dispatches inline and
        returns the op rows dispatched. Either way the card is fenced only
        by the periodic overflow poll or by ``finalize()``/queries."""
        if self._async:
            self._check_worker()
            if self._pending:
                self._pack()
            if self._repack_slots:
                self._pause_and_repack()
            self._wake.set()
            return 0
        return self._flush_sync()

    def _flush_sync(self) -> int:
        if self._pending:
            self._pack()
        total = 0
        with self._on_streams():
            while self._staged:
                total += self._dispatch_wave(self._take_wave_locked())
        self.ops_applied += total
        if self._dispatches_since_check >= self.overflow_check_every:
            self._check_overflow()
        return total

    def finalize(self) -> None:
        """Flush staged ops and fence the device: after this, every doc's
        state (or its host escalation) reflects everything ingested."""
        if self._async:
            if self._pending:
                self._pack()
            self._draining = True
            try:
                while True:
                    self._check_worker()
                    if self._repack_slots:
                        self._pause_and_repack()
                    self._wake.set()
                    with self._lock:
                        empty = not self._staged and not self._repack_slots
                    if empty and self._idle.is_set():
                        break
                    time.sleep(0.0005)
            finally:
                self._draining = False
            # the worker may have died after its last wave went idle
            self._check_worker()
            with self._lock:
                pending = sorted(self._overflow_slots)
                self._overflow_slots.clear()
            for slot in pending:
                if slot not in self._host_docs:
                    self._escalate(slot, None, None)
            self._drain_device()
            self._check_overflow()
            return
        self._flush_sync()
        self._drain_device()
        if self._dispatches_since_check:
            self._check_overflow()

    def close(self) -> None:
        """Stop and join the worker (async mode) and wait for the last
        step; re-raises a worker exception not yet raised. From then on
        the applier dispatches on the caller's thread (ops still staged
        go out at the next flush). Idempotent."""
        if self._worker is not None:
            self._stop = True
            self._wake.set()
            self._worker.join(timeout=60)
            if self._worker.is_alive():
                raise RuntimeError("applier worker did not stop in 60 s")
            self._worker = None
            self._async = False
            self._repack_held()
            # overflow the worker found but finalize never escalated: the
            # flags are sticky on the card, so the next read polls again
            self._dispatches_since_check = max(self._dispatches_since_check,
                                               1)
        self._drain_device()
        err, self._worker_error = self._worker_error, None
        if err is not None:
            raise err

    def _check_worker(self) -> None:
        """Re-raise a stored worker exception (once); after that, refuse
        to wait on the dead worker."""
        err, self._worker_error = self._worker_error, None
        if err is not None:
            raise err
        if not self._worker.is_alive():
            raise RuntimeError("the applier's worker thread is not running "
                               "(it died on an earlier error)")

    def _take_wave_locked(self):
        """Pop up to K staged op ROWS per doc (caller holds the lock, or
        is the only thread). Returns [(slot, chunk_list, row_count)] or
        None when nothing is staged; a chunk that does not fit is split by
        a view, keeping order. While tracing, a wave takes a request id
        here, which its stage, execute and card waits carry."""
        if not self._staged:
            return None
        span = None
        if tracing():
            SPANS.new_request()
            span = SPANS.begin(TAKE_SPAN)
        try:
            parts = []
            drained = []
            K = self.K
            for slot, chunks in self._staged.items():
                take, rest, count = [], None, 0
                for ci, ch in enumerate(chunks):
                    if count + len(ch) <= K:
                        take.append(ch)
                        count += len(ch)
                        continue
                    room = K - count
                    if room > 0:
                        take.append(ch[:room])
                        count = K
                        rest = [ch[room:]] + chunks[ci + 1:]
                    else:
                        rest = chunks[ci:]
                    break
                parts.append((slot, take, count))
                self._staged_ops -= count
                if rest is None:
                    drained.append(slot)
                else:
                    self._staged[slot] = rest
            for slot in drained:
                del self._staged[slot]
            return parts
        finally:
            if span is not None:
                SPANS.end(span)

    def _dispatch_wave(self, parts) -> int:
        """Stage then execute one wave (the caller has the applier's
        stream current). Overlap comes from the execute half being an
        asynchronous enqueue: the NEXT wave's stage half runs on the host
        while this wave runs on the card."""
        if self._ceiling > 0 and parts:
            parts = self._wave_check(parts)
        staged = self._stage_wave(parts)
        if staged is None:
            return 0
        return self._execute_wave(staged)

    # ------------------------------------------------------ async worker

    def _worker_loop(self) -> None:
        try:
            with self._on_streams():
                self._worker_run()
        except BaseException as exc:  # noqa: BLE001 — re-raised by the
            # caller's next flush/finalize/close
            self._worker_error = exc
        finally:
            self._idle.set()

    def _worker_run(self) -> None:
        while True:
            self._wake.wait()
            if self._stop:
                return
            with self._lock:
                if self._paused:
                    parts = None  # the caller repacks on its thread
                elif not self._draining and self._min_wave \
                        and self._staged_ops < self._min_wave:
                    parts = None
                else:
                    parts = self._take_wave_locked()
                if parts is None:
                    self._wake.clear()
                    self._idle.set()
                    continue
                self._idle.clear()
            n = self._dispatch_wave(parts)
            with self._lock:
                self.ops_applied += n
            if self._dispatches_since_check >= self.overflow_check_every:
                # poll from the worker (it owns the streams); defer the
                # escalation replay to the caller's next sync point
                self._dispatches_since_check = 0
                flags = self._overflow_flags()
                hit = {int(s) for s in np.nonzero(flags)[0]}
                if hit:
                    with self._lock:
                        self._overflow_slots |= hit
            time.sleep(0)  # yield to the staging thread

    # --------------------------------------------- stage / execute halves

    def _metrics(self):
        if self._registry is None:
            self._registry = get_registry()
        return self._registry

    def _on_streams(self) -> ExitStack:
        """A context that makes the applier's streams current on this
        thread, one per device (a no-op on the CPU)."""
        stack = ExitStack()
        for stream in self._streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    @property
    def state(self) -> DocState:
        """The whole farm's [D, S] state: the shards' rows concatenated on
        the first shard's device (a copy when there are several)."""
        if len(self._shards) == 1:
            return self._shards[0]
        with self._on_streams():
            return unshard_state(self._shards)

    def _locate(self, slot: int) -> tuple[DocState, int]:
        """The shard state holding global row ``slot``, and its row there."""
        sps = self.max_docs // len(self._shards)
        return self._shards[slot // sps], slot % sps

    def _overflow_flags(self) -> np.ndarray:
        """Every row's overflow flag (a device→host sync per device)."""
        span = SPANS.begin(SYNC_SPAN) if tracing() else None
        try:
            with self._on_streams():
                return np.concatenate([s.overflow.cpu().numpy()
                                       for s in self._shards])
        finally:
            if span is not None:
                SPANS.end(span)

    @blocking("event.synchronize() on the step that last consumed the "
              "target staging set — the rotation fence")
    def _rotate_stage_buffers(self) -> None:
        """Flip to the other staging set, waiting first for the STEP that
        last consumed it: its pinned memory is the source of a
        non-blocking copy, which is done only when that step's event has
        completed. By rotation the fenced wave is two dispatches old, so
        with the pipeline one wave deep the wait is a no-op — it only
        blocks when the card has fallen a full double buffer behind."""
        self._stage_flip ^= 1
        pending = self._stage_inflight[self._stage_flip]
        if pending is not None:
            span = SPANS.begin(SYNC_SPAN) if tracing() else None
            try:
                for event in pending:
                    event.synchronize()
            finally:
                if span is not None:
                    SPANS.end(span)
            self._stage_inflight[self._stage_flip] = None

    def _stage_buffer(self, shape: tuple, dtype) -> tuple:
        """A zeroed host staging buffer from the CURRENT rotation set, as
        (tensor, numpy view of it): pinned on the card's host so its copy
        can be asynchronous. Callers run _rotate_stage_buffers once per
        wave first — the zeroing must come after that fence."""
        pool = self._stage_pool[self._stage_flip]
        key = (shape, np.dtype(dtype).str)
        buf = pool.get(key)
        if buf is None:
            host = torch.empty(shape, dtype=_TORCH_DTYPE[np.dtype(dtype)],
                               pin_memory=self._stream is not None)
            buf = pool[key] = (host, host.numpy())
        buf[1].fill(0)
        return buf

    @blocking("event.synchronize() on the last step — the strict-wave-"
              "order fence at escalation and width-flip seams")
    def _drain_device(self) -> None:
        """Wait for the last enqueued step on every device. Escalation,
        force_wide and close must never act on a farm with a wave still
        executing."""
        span = SPANS.begin(SYNC_SPAN) if tracing() else None
        try:
            for event in self._exec_markers:
                event.synchronize()
        finally:
            if span is not None:
                SPANS.end(span)

    def _stage_wave(self, parts) -> Optional[_StagedWave]:
        """The HOST half of a dispatch: concat chunks → pack_wave_rows →
        scatter into the rotating pinned buffers → asynchronous copy on
        the applier's streams (``_stage_rows``). No compute is enqueued.
        One interval feeds ``stage_seconds`` and the ``applier.stage``
        span."""
        if parts is None:
            return None
        t0 = time.perf_counter()
        parts = [p for p in parts if p[2]]  # interval-only batches: no rows
        if not parts:
            return None
        span = SPANS.begin(STAGE_SPAN, t0) if tracing() else None
        try:
            staged = self._stage_rows(parts)
        finally:
            t1 = time.perf_counter()
            if span is not None:
                SPANS.end(span, t1)
        dt = t1 - t0
        if span is not None:
            # wave fill: op rows against the [D, K] rows a wave ships
            SPANS.count("applier.wave.rows", staged.n)
            SPANS.count("applier.wave.slots", self.max_docs * self.K)
        # overlap accounting: this stage half counts as HIDDEN time when
        # the previous step is still executing (query() is non-blocking,
        # so the measurement never perturbs the pipeline it measures)
        overlapped = any(not e.query() for e in self._exec_markers)
        self.waves_staged += 1
        self.stage_seconds += dt
        self.stage_bytes += staged.nbytes
        if overlapped:
            self.stage_overlap_seconds += dt
        reg = self._metrics()
        reg.inc("applier.stage.seconds", dt, lane=self._lane)
        reg.inc("applier.stage.bytes", staged.nbytes, lane=self._lane)
        reg.set_gauge("applier.stage.overlap_ratio",
                      self.stage_overlap_ratio(), lane=self._lane)
        # applier/stage hop: wall-clock stamp at stage completion —
        # _execute_wave closes the stage→execute leg
        self._last_stage_wall = time.time()
        if self.fault_plane is not None:
            # chaos seam: wave N+1 staged (popped from the staging dict,
            # copies enqueued) but NOT yet executed — a crash here must
            # lose nothing: restore replays it from the log
            self.fault_plane("applier.stage.staged", ops=staged.n)
        return staged

    def _stage_rows(self, parts) -> _StagedWave:
        """Pack the wave's rows once, scatter each ACTIVE shard's rows
        into its block of the next staging set and enqueue the block's
        copy to the shard's device; an inactive shard gets a zero block
        resident there. Rows route by the farm's own shard list, as
        ``_locate`` does: a farm loaded without a mesh from a checkpoint
        of several shards keeps one state."""
        n_shards = len(self._shards)
        sps = self.max_docs // n_shards
        if n_shards > 1:
            # each shard's docs, and so its rows, become one slice
            parts = sorted(parts, key=lambda p: p[0] // sps)
        chunks = [ch for _slot, take, _n in parts for ch in take]
        flat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        n = len(flat)
        lens_a = np.array([count for _s, _t, count in parts])
        starts = np.cumsum(lens_a) - lens_a
        slots_a = np.array([slot for slot, _t, _n in parts], np.int64)
        last = starts + lens_a - 1
        self._applied_msn[slots_a] = flat[last, F_MSN]
        self._dispatched_seq[slots_a] = flat[last, F_SEQ]
        packed, seq_base, text_base = pack_wave_rows(flat, starts, lens_a)

        force_wide = (
            self.fault_plane is not None
            and self.fault_plane("applier.dispatch", ops=n) == "force_wide")
        if force_wide:
            # the forced int32 lane is a different program: drain the
            # pipeline so the width flip never reorders around an
            # in-flight packed wave
            self._drain_device()
        wide = (force_wide or packed.min() < INT16_MIN
                or packed.max() > INT16_MAX)
        self._rotate_stage_buffers()
        if n_shards == 1:
            active, firsts = [0], [0]
        else:
            active, firsts = np.unique(slots_a // sps, return_index=True)
            active, firsts = active.tolist(), firsts.tolist()
            slots_a = slots_a % sps  # rows local to their shard
        doc_cuts = firsts + [len(parts)]
        row_cuts = starts[firsts].tolist() + [n]
        doc_idx = np.repeat(slots_a, lens_a)
        pos_idx = np.arange(n, dtype=np.int64) - np.repeat(starts, lens_a)
        # a field escaped int16: ship the wave at full int32 width
        rows = flat if wide else packed
        W, W_np = self._stage_buffer((len(active), sps, self.K, OP_FIELDS),
                                     np.int32 if wide else np.int16)
        nbytes = W_np.nbytes
        if not wide:
            B, B_np = self._stage_buffer((len(active), sps, 2), np.int32)
            nbytes += B_np.nbytes
        blocks = {}
        for i, shard in enumerate(active):
            r0, r1 = row_cuts[i], row_cuts[i + 1]
            W_np[i][doc_idx[r0:r1], pos_idx[r0:r1]] = rows[r0:r1]
            if wide:
                blocks[shard] = (W[i],)
                continue
            d0, d1 = doc_cuts[i], doc_cuts[i + 1]
            B_np[i][slots_a[d0:d1], 0] = seq_base[d0:d1]
            B_np[i][slots_a[d0:d1], 1] = text_base[d0:d1]
            blocks[shard] = (W[i], B[i])
        # asynchronous copies on the applier's streams (current on this
        # thread); on the CPU .to() returns the buffer itself
        arrays = [tuple(b.to(d, non_blocking=True) for b in blocks[s])
                  if s in blocks else self._zero_blocks(d, wide)
                  for s, d in enumerate(self._shard_devices)]
        if self._mesh is not None:
            self.mesh_waves += 1
            self.mesh_active_shards += len(active)
            self.mesh_staged_bytes += nbytes
        return _StagedWave(wide, arrays, n, nbytes, self._stage_flip)

    def _zero_blocks(self, device, wide: bool) -> tuple:
        """An inactive shard's inputs: zero blocks resident on its device,
        made once for every device of the farm."""
        tails = (((self.K, OP_FIELDS), torch.int32),) if wide else (
            ((self.K, OP_FIELDS), torch.int16), ((2,), torch.int32))
        out = []
        for tail, dtype in tails:
            zeros = self._zero_shards.get((tail, dtype))
            if zeros is None:
                shape = (self.max_docs // len(self._shards),) + tail
                zeros = self._zero_shards[(tail, dtype)] = {
                    d: torch.zeros(shape, dtype=dtype, device=d)
                    for d in dict.fromkeys(self._shard_devices)}
            out.append(zeros[device])
        return tuple(out)

    def _execute_wave(self, staged: _StagedWave) -> int:
        """The DEVICE half: enqueue the step on the applier's streams
        (current on the calling thread) behind the wave's copies, and
        record one completion event per device. With overlap on nothing
        waits; with it off the step is fenced before returning (the
        serialized behavior, kept for A/B). One interval feeds
        ``exec_seconds`` and the ``applier.execute`` span; while tracing,
        profiler scopes name the step's stages (unpack, apply, compact)."""
        t0 = time.perf_counter()
        span = SPANS.begin(EXECUTE_SPAN, t0) if tracing() else None
        on = span is not None
        try:
            with profiler_scope("applier.execute", on):
                self._enqueue_step(staged, on)
        finally:
            t1 = time.perf_counter()
            if span is not None:
                SPANS.end(span, t1)
        dt = t1 - t0
        self.exec_seconds += dt
        reg = self._metrics()
        reg.inc("applier.exec.seconds", dt, lane=self._lane)
        # applier/execute hop: the dispatch-split leg of the hop
        # breakdown, observed directly into the hop family and retained
        # as last_wave_hops for a host that forwards the stamps
        stage_wall = self._last_stage_wall
        exec_wall = time.time()
        if stage_wall is not None:
            ms = (exec_wall - stage_wall) * 1e3
            reg.observe("obs.hop.ms", ms, pair="stage_to_execute")
            reg.observe_windowed("obs.hop.window_ms", ms,
                                 pair="stage_to_execute")
            self.last_wave_hops = (stage_wall, exec_wall)
        self.dispatches += 1
        self._dispatches_since_check += 1
        if self.fault_plane is not None:
            # chaos seam: the wave is IN FLIGHT on the card and the next
            # wave is not yet staged — the other overlap-window order
            self.fault_plane("applier.stage.inflight", ops=staged.n)
        return staged.n

    def _enqueue_step(self, staged: _StagedWave, traced: bool) -> None:
        """Enqueue each shard's step (``apply_wave``) and the wave's
        completion events (a plain marker per device); fence them at once
        with overlap off."""
        if staged.wide:
            self.wide_dispatches += 1
        self._shards = [apply_wave(state, *args, traced=traced)
                        for state, args in zip(self._shards, staged.arrays)]
        if self._streams:
            ends = []
            for stream in self._streams.values():
                end = torch.cuda.Event()
                end.record(stream)
                ends.append(end)
            self._exec_markers = ends
            # the wave's staging set may be refilled only after this
            # step (and so its copies) completes: _rotate_stage_buffers
            # fences on it
            self._stage_inflight[staged.flip] = ends
            if not self._overlap:
                span = SPANS.begin(SYNC_SPAN) if traced else None
                try:
                    for end in ends:
                        end.synchronize()
                finally:
                    if span is not None:
                        SPANS.end(span)

    def stage_overlap_ratio(self) -> float:
        """staged-while-executing seconds / total stage seconds."""
        return (self.stage_overlap_seconds / self.stage_seconds
                if self.stage_seconds else 0.0)

    def _check_overflow(self) -> None:
        self._dispatches_since_check = 0
        flags = self._overflow_flags()
        for slot in np.nonzero(flags)[0]:
            if int(slot) not in self._host_docs:
                self._escalate(int(slot), None, None)

    # ------------------------------------------------------------- repack

    def _wave_check(self, parts) -> list:
        """Before a wave: when the wave could take one of its docs past S
        by the bounds (the count at the last read, 2 a row dispatched
        since), read every doc's count and flag in one copy a device and
        repack every unflagged doc counted past the watermark (or, its
        thrash guard armed, past its retry count): here on the caller's
        thread; the async worker hands them to the caller's next sync
        point and waits for it. Returns the wave's parts that go on (none,
        when the worker is stopped while it waits)."""
        slots = np.fromiter((p[0] for p in parts), np.int64, len(parts))
        rows = np.fromiter((p[2] for p in parts), np.int64, len(parts))
        if int((self._bound[slots] + 2 * rows).max()) > self.max_slots:
            counts, flags = self._read_counts()
            self._retry_at[counts <= self._ceiling] = 0  # shrank by itself
            # a flagged doc goes to the host at the overflow poll, as ever
            able = (self._applied_msn >= 0) & ~flags
            able[list(self._host_docs)] = False
            need = np.nonzero(able & (counts > np.maximum(
                self._watermark, self._retry_at)))[0]
            self._bound = counts
            if len(need) and threading.current_thread() is self._worker:
                parts = self._await_repack(need, parts)
            elif len(need):
                taken = {p[0]: p[1] for p in parts}
                self._bound[need] = self._repack(need, taken, counts[need])
        self._bound[slots] += 2 * rows
        return parts

    def _read_counts(self) -> tuple:
        """Every row's slot count and overflow flag, one device→host copy
        a device."""
        span = SPANS.begin(SYNC_SPAN) if tracing() else None
        try:
            with self._on_streams():
                both = np.concatenate(
                    [torch.stack([s.count, s.overflow.to(torch.int32)])
                     .cpu().numpy() for s in self._shards], axis=1)
        finally:
            if span is not None:
                SPANS.end(span)
        return both[0].astype(np.int64), both[1].astype(bool)

    def _await_repack(self, need: np.ndarray, parts: list) -> list:
        """The worker's half of a repack: hand the docs and the wave's
        taken chunks to the caller's next sync point, touch nothing until
        it has repacked them, then go on with the wave. Stopped while
        waiting, it gives the wave back to the staged rows."""
        with self._lock:
            self._repack_slots |= set(need.tolist())
            self._repack_taken = {p[0]: p[1] for p in parts}
            self._repack_done.clear()
            self._idle.set()  # no device work until the repack is done
        while not self._repack_done.wait(0.005):
            if self._stop:
                with self._lock:
                    self._repack_taken = {}
                    for slot, take, count in parts:
                        self._staged[slot] = take + self._staged.get(slot, [])
                        self._staged_ops += count
                return []
        return parts

    def _pause_and_repack(self) -> None:
        """The async lane's sync point for a repack: hold the worker off,
        wait until it is idle or waiting for the repack, repack on this
        thread, let it go again."""
        with self._lock:
            self._paused = True
        try:
            self._idle.wait()
            self._check_worker()
            self._repack_held()
        finally:
            with self._lock:
                self._paused = False
                if not self._repack_done.is_set():
                    self._idle.clear()  # the worker goes on with its wave
                    self._repack_done.set()
            self._wake.set()

    def _repack_held(self) -> None:
        """Repack the docs the worker handed over (the worker is waiting,
        idle or gone). Recorded boxcars stay recorded: they have no arena
        start yet, so the next pack appends them to the rebuilt arena."""
        with self._lock:
            held = sorted(self._repack_slots - self._host_docs.keys())
            self._repack_slots.clear()
            taken, self._repack_taken = self._repack_taken, {}
        if held:
            slots = np.array(held, np.int64)
            with self._on_streams():
                self._bound[slots] = self._repack(slots, taken)

    def _repack(self, slots: np.ndarray, taken: dict,
                counts: Optional[np.ndarray] = None) -> np.ndarray:
        """Merge the settled runs of docs ``slots`` (ascending, so shard
        by shard) in one gather, one numpy pass and one scatter, at each
        doc's msn of its last dispatched row (``ops/doc_state.py::
        merge_settled_runs``), and rebuild each doc's text arena from its
        slots, the text of its rows not yet applied (``taken``: slot → the
        chunks of a wave taken but not staged; then its staged chunks)
        after it. ``counts``: the docs' slot counts, if just read. Arms
        the thrash guard of each doc left above the ceiling. Returns the
        docs' slot counts afterwards."""
        traced = tracing()
        span = SPANS.begin(REPACK_SPAN) if traced else None
        try:
            if counts is None:
                counts = self._read_counts()[0][slots]
            width = max(int(counts.max()), 1)
            rows = self._gather_rows(slots, width)
            rows["count"] = counts.astype(np.int32)
            merged = merge_settled_runs(rows, self._applied_msn[slots])
            new_count = merged["count"]
            ok = new_count <= self._ceiling
            self._retry_at[slots] = np.where(
                ok, 0, new_count.astype(np.int64) + 2 * self.K)
            length = merged["length"]
            starts = np.cumsum(length, axis=1) - length
            merged["text_start"] = np.where(
                np.arange(width)[None, :] < new_count[:, None], starts, 0
            ).astype(np.int32)
            old_ts, old_len = rows["text_start"], rows["length"]
            for r, slot in enumerate(slots.tolist()):
                n = int(counts[r])
                old = self.arenas[slot].text()
                text = "".join([old[a:a + b] for a, b in zip(
                    old_ts[r, :n].tolist(), old_len[r, :n].tolist())])
                self._rebase_staged(slot, old, text, taken.get(slot, []))
            self._scatter_rows(slots, merged, width)
            slots_in, slots_out = int(counts.sum()), int(new_count.sum())
            self.doc_repacks[slots] += 1
            self.repack_slots_in += slots_in
            self.repack_slots_out += slots_out
            if traced:
                SPANS.count("applier.repack.docs", len(slots))
                SPANS.count("applier.repack.slots_in", slots_in)
                SPANS.count("applier.repack.slots_out", slots_out)
        finally:
            if span is not None:
                SPANS.end(span)
        return new_count.astype(np.int64)

    def _shard_groups(self, slots: np.ndarray) -> list:
        """``slots`` (ascending) as (shard, its rows there) pairs."""
        sps = self.max_docs // len(self._shards)
        shard_of = slots // sps
        return [(sh, slots[shard_of == sh] % sps)
                for sh in np.unique(shard_of).tolist()]

    def _gather_rows(self, slots: np.ndarray, width: int) -> dict:
        """The first ``width`` slots of rows ``slots``, every field but the
        count and flag, in one device→host copy a shard."""
        P = self._shards[0].max_props
        parts = {f: [] for f in FIELDS[:-2]}
        with self._on_streams():
            for sh, local in self._shard_groups(slots):
                state = self._shards[sh]
                idx = torch.from_numpy(local).to(state.device)
                flat = torch.cat([getattr(state, f)[idx, :width].flatten()
                                  for f in FIELDS[:-2]]).cpu().numpy()
                n = len(local) * width
                for f, a in zip(FIELDS[:-2], np.split(
                        flat, np.cumsum([n] * 8 + [n * P]))):
                    parts[f].append(a.reshape(
                        (len(local), width, P) if f.startswith("prop")
                        else (len(local), width)))
        return {f: np.concatenate(p) for f, p in parts.items()}

    def _scatter_rows(self, slots: np.ndarray, merged: dict,
                      width: int) -> None:
        """Write ``merged`` (``_gather_rows``'s fields and the count) back
        to rows ``slots``, in one host→device copy a shard."""
        with self._on_streams():
            lo = 0
            for sh, local in self._shard_groups(slots):
                hi = lo + len(local)
                state = self._shards[sh]
                idx = torch.from_numpy(local).to(state.device)
                flat = torch.from_numpy(np.concatenate(
                    [merged[f][lo:hi].ravel() for f in FIELDS[:-1]])
                ).to(state.device)
                at = 0
                for f in FIELDS[:-2]:
                    block = merged[f][lo:hi]
                    getattr(state, f)[idx, :width] = \
                        flat[at:at + block.size].view(block.shape)
                    at += block.size
                state.count[idx] = flat[at:]
                lo = hi

    def _rebase_staged(self, slot: int, old: str, text: str,
                       taken: list) -> None:
        """Make ``text`` (a repacked doc's slots' text, in slot order) the
        head of the doc's new arena, with the text of its rows not yet
        applied (``taken``, then its staged chunks) after it, and move
        those rows' offsets by the difference. The slots reference only
        text of dispatched rows, which the arena holds before any later
        row's."""
        chunks = list(taken) + self._staged.get(slot, [])
        inserts = [ch[:, F_TYPE] == OP_INSERT for ch in chunks]
        firsts = [int(ch[m, F_TSTART].min()) for ch, m in zip(chunks, inserts)
                  if m.any()]
        tail = min(firsts) if firsts else len(old)
        shift = len(text) - tail
        if shift:
            for ch, m in zip(chunks, inserts):
                ch[m, F_TSTART] += shift
        arena = TextArena()
        arena.append(text)
        if tail < len(old):
            arena.append(old[tail:])
        self.arenas[slot] = arena

    # ------------------------------------------------------------- queries

    def _sync(self, slot: int) -> None:
        """Flush + overflow-check before exposing a doc's state."""
        if self._async:
            self.finalize()
            return
        if self._staged.get(slot) or slot in self._pending:
            self.flush()
        if self._dispatches_since_check:
            self._check_overflow()

    def _row(self, slot: int) -> dict:
        """Doc ``slot``'s state fields as numpy arrays, read from its
        shard."""
        shard, row = self._locate(slot)
        with self._on_streams():
            return {f: getattr(shard, f)[row].cpu().numpy() for f in FIELDS}

    def slot_count(self, tenant_id: str, document_id: str) -> int:
        """Live device slots of a doc (bounded under churn by zamboni)."""
        shard, row = self._locate(self.slot_of(tenant_id, document_id))
        with self._on_streams():
            return int(shard.count[row])

    def get_text(self, tenant_id: str, document_id: str) -> str:
        slot = self.slot_of(tenant_id, document_id)
        self._sync(slot)
        if slot in self._host_docs:
            return self._host_docs[slot].get_text()
        row, arena = self._row(slot), self.arenas[slot]
        out = []
        for i in range(int(row["count"])):
            if row["rem_seq"][i] != NO_SEQ or row["flags"][i] & FLAG_MARKER:
                continue  # removed, or a marker (length, not text)
            out.append(arena.slice(int(row["text_start"][i]),
                                   int(row["length"][i])))
        return "".join(out)

    def get_tree(self, tenant_id: str, document_id: str) -> MergeTreeClient:
        """The doc decoded to an oracle replica (summaries, inspection)."""
        slot = self.slot_of(tenant_id, document_id)
        self._sync(slot)
        if slot in self._host_docs:
            return self._host_docs[slot]
        shard, row = self._locate(slot)
        with self._on_streams():
            tree = decode_state(shard, self.arenas[slot], self.prop_table,
                                doc=row)
        replica = MergeTreeClient(f"gpu-applier/{tenant_id}/{document_id}",
                                  blocked=False)
        replica.tree = tree
        # in-window stamps must translate back to wire client ids
        replica._ids.update(self._client_ids.get(slot, {}))
        return replica

    def get_properties_at(self, tenant_id: str, document_id: str,
                          pos: int) -> dict:
        """Properties of the visible character at ``pos`` (final
        perspective)."""
        slot = self.slot_of(tenant_id, document_id)
        self._sync(slot)
        if slot in self._host_docs:
            return self._host_docs[slot].get_properties_at(pos)
        row = self._row(slot)
        cum = 0
        for i in range(int(row["count"])):
            if row["rem_seq"][i] != NO_SEQ:
                continue
            length = int(row["length"][i])
            if cum <= pos < cum + length:
                return {self.prop_table.key(int(k)):
                        self.prop_table.val(int(v))
                        for k, v in zip(row["prop_key"][i],
                                        row["prop_val"][i]) if k != NO_KEY}
            cum += length
        raise IndexError(pos)

    def applied_seq(self, tenant_id: str, document_id: str) -> int:
        """Highest sequence number ingested for the doc (0 if none).
        Summary writers compare this against the stream's last channel op
        to refuse writing a summary from lagging device state. Counts the
        doc's recorded boxcars."""
        slot = self.slot_of(tenant_id, document_id)
        with self._lock:
            seq = self._applied_seq.get(slot, 0)
            group = self._pending.get(slot)
            if group:
                seq = max(seq, max([b.last_seq for b in group]))
        return seq

    def first_seq(self, tenant_id: str, document_id: str) -> int:
        """First sequence number ever ingested for the doc (0 if none),
        a recorded boxcar's included."""
        slot = self.slot_of(tenant_id, document_id)
        with self._lock:
            return self._first_seq.get(slot, self._first_recorded(slot, 0))

    def _first_recorded(self, slot: int, default):
        """The first seq of doc ``slot``'s recorded boxcars, else
        ``default`` (caller holds the lock)."""
        group = self._pending.get(slot)
        return group[0].base_seq if group else default

    def is_anchored(self, tenant_id: str, document_id: str) -> bool:
        """True when the slot's state provably covers the doc's whole
        history (see the coverage-tracking comment in __init__)."""
        return self.slot_of(tenant_id, document_id) in self._anchored

    def mark_anchored(self, tenant_id: str, document_id: str) -> None:
        """Record a coverage proof established by the caller (the
        summarizer's gate pass). Also discharges any pending
        restore-window condition — the proof subsumes it."""
        slot = self.slot_of(tenant_id, document_id)
        self._anchored.add(slot)
        self._restore_applied.pop(slot, None)
        self._post_restore_first.pop(slot, None)

    def restore_gap(self, tenant_id: str, document_id: str
                    ) -> Optional[tuple[int, Optional[int]]]:
        """(applied seq at checkpoint restore, first seq ingested since)
        for a restored slot, else None. Ops sequenced in between were
        never ingested — the summarizer refuses if the stream shows any."""
        slot = self.slot_of(tenant_id, document_id)
        with self._lock:
            if slot not in self._restore_applied:
                return None
            return (self._restore_applied[slot],
                    self._post_restore_first.get(
                        slot, self._first_recorded(slot, None)))

    # ---------------------------------------------------- host escalation

    def set_replay_source(self, fn) -> None:
        """``fn(tenant, doc)`` yields the doc's channel-level sequenced
        merge-tree messages from the start; escalation replays them."""
        self._replay_log = fn

    def _escalate(self, slot: int, msg, wire_op) -> None:
        """Rebuild the doc on the scalar oracle from its authoritative op
        log and continue host-side."""
        tenant_id, document_id = self._doc_keys[slot]
        # strict wave order at the escalation seam: the doc leaves the
        # device farm only after its last in-flight wave lands
        self._drain_device()
        if self._replay_log is None:
            # degrading to an empty replica would silently lose the doc
            raise RuntimeError(
                f"doc {tenant_id}/{document_id} needs host escalation but no "
                "replay source is configured (set_replay_source)")
        self.host_escalations += 1
        if self._retry_at[slot]:
            # its last repack could not bring it under the ceiling
            self.repack_escalations += 1
            if tracing():
                SPANS.count("applier.repack.escalated", 1)
        # before the doc turns host: its recorded boxcars pack as the farm's
        self._drop_staged(slot)
        replica = MergeTreeClient(f"gpu-applier/{tenant_id}/{document_id}")
        self._host_docs[slot] = replica
        dispatched = int(self._dispatched_seq[slot])
        for m in self._replay_log(tenant_id, document_id):
            if m.type == MessageType.OPERATION:
                replica.apply_msg(m, local=False)
                if m.sequence_number > dispatched:
                    self.host_ops_applied += 1
        self._applied_seq[slot] = max(self._applied_seq.get(slot, 0),
                                      replica.tree.current_seq)
        # deliberately NOT anchored: the applier cannot verify the replay
        # source yielded the doc's whole history — the summarizer gate
        # must re-prove coverage before trusting this replica
        self._anchored.discard(slot)
        if msg is not None:
            self._apply_host(slot, msg, wire_op)

    def _apply_host(self, slot: int, msg, wire_op) -> None:
        replica = self._host_docs[slot]
        if msg.sequence_number <= replica.tree.current_seq:
            return  # already covered by the escalation replay
        replica.apply_msg(replace(msg, contents=wire_op), local=False)
        self.host_ops_applied += 1


# ----------------------------------------------------------- checkpointing

def save_applier_checkpoint(applier: GpuDocumentApplier, path: str) -> dict:
    """Persist the applier's farm to disk in the JAX package's format
    (``tpu_applier.save_applier_checkpoint``): the [D, S] state arrays in
    ``<path>.g<gen>.npz`` and the host sidecars (text arenas, property
    interning, client tables, placement, escalated docs as oracle
    snapshots, coverage and restore windows) in ``<path>.json``. A warm
    restart loads this instead of replaying every doc's op log.

    Calls ``finalize()`` first, so the state is fenced (an async
    applier's worker is drained, and a stored worker exception raises
    here before anything is written). The state is read back on the
    applier's streams, shard by shard: rows stay shard-major, so the file
    is the JAX package's in either direction. Returns the save's costs:
    ``readback_seconds``
    (device to host), ``write_seconds`` (compress and write both files)
    and ``npz_bytes``."""
    applier.finalize()
    t0 = time.perf_counter()
    with applier._on_streams():
        arrays = {f: np.concatenate([getattr(s, f).cpu().numpy()
                                     for s in applier._shards])
                  for f in FIELDS}
    t1 = time.perf_counter()
    meta = {
        "max_docs": applier.max_docs,
        "max_slots": applier.max_slots,
        "arenas": [a.text() for a in applier.arenas],
        "prop_table": applier.prop_table.snapshot(),
        "client_ids": {str(k): v for k, v in applier._client_ids.items()},
        "doc_keys": {str(k): list(v) for k, v in applier._doc_keys.items()},
        "placement": applier.placement.snapshot(),
        "host_docs": {str(k): replica.snapshot()
                      for k, replica in applier._host_docs.items()},
        "host_doc_names": {str(k): applier._doc_keys[k]
                           for k in applier._host_docs},
        "applied_seq": {str(k): v
                        for k, v in applier._applied_seq.items()},
        "first_seq": {str(k): v for k, v in applier._first_seq.items()},
        "anchored": sorted(applier._anchored),
        # a still-pending restart window must survive the save, or a
        # save/load cycle would discharge an unverified window
        "restore_applied": {str(k): v
                            for k, v in applier._restore_applied.items()},
    }
    # crash-atomic commit: the arrays go to the other generation's file
    # (through a .tmp and a rename), and the .json, which names the
    # generation, is renamed into place last — the commit point. Until
    # then the previous consistent pair survives a kill.
    gen = 0
    try:
        with open(path + ".json") as f:
            gen = 1 - int(json.load(f).get("gen", 0))
    except (OSError, ValueError):
        pass
    meta["gen"] = gen
    npz_path = f"{path}.g{gen}.npz"
    with open(npz_path + ".tmp", "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(npz_path + ".tmp", npz_path)
    with open(path + ".json.tmp", "w") as f:
        json.dump(meta, f)
    os.replace(path + ".json.tmp", path + ".json")
    return {"readback_seconds": t1 - t0,
            "write_seconds": time.perf_counter() - t1,
            "npz_bytes": os.path.getsize(npz_path)}


def load_applier_checkpoint(path: str, **applier_kwargs
                            ) -> GpuDocumentApplier:
    """Rebuild a fenced applier from a checkpoint written by
    ``save_applier_checkpoint`` in either package. ``applier_kwargs`` go
    to ``GpuDocumentApplier`` (``device`` defaults to ``cuda``; ``mesh``
    re-shards the state over the mesh); the geometry comes from the file,
    so the pinned staging sets are sized by its ``max_docs``. The state
    tensors are made on the applier's streams.

    Without a mesh, a placement of several shards loads as the JAX
    applier loads it: rows stay shard-major on the one device. With a
    mesh, a placement of another shard count is refused (ValueError, the
    JAX text): shard-major rows would route every doc to the wrong
    shard."""
    with open(path + ".json") as f:
        meta = json.load(f)
    applier = GpuDocumentApplier(max_docs=meta["max_docs"],
                                 max_slots=meta["max_slots"],
                                 **applier_kwargs)
    placement = DocPlacement.load(meta["placement"])
    if applier._mesh is not None and \
            placement.n_shards != applier.placement.n_shards:
        applier.close()
        raise ValueError(
            f"checkpoint placement has {placement.n_shards} shards but "
            f"the mesh's docs axis is {applier.placement.n_shards}")
    # generation-named arrays (crash-atomic saver); plain ".npz" is the
    # legacy single-generation layout
    npz_path = (f"{path}.g{meta['gen']}.npz" if "gen" in meta
                else path + ".npz")
    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}
    with applier._on_streams():
        state = state_from_numpy(arrays, applier.device)
        applier._shards = (shard_state(state, applier._mesh)
                           if applier._mesh is not None else [state])
    applier._bound = np.asarray(arrays["count"], np.int64).reshape(-1).copy()
    for slot, text in enumerate(meta["arenas"]):
        arena = TextArena()
        if text:
            arena.append(text)
        applier.arenas[slot] = arena
    applier.prop_table = PropTable.load(meta["prop_table"])
    applier._client_ids = {int(k): dict(v)
                           for k, v in meta["client_ids"].items()}
    applier._doc_keys = {int(k): tuple(v)
                         for k, v in meta["doc_keys"].items()}
    applier.placement = placement
    for k, snap in meta["host_docs"].items():
        tenant_id, document_id = meta["host_doc_names"][k]
        applier._host_docs[int(k)] = MergeTreeClient.load(
            f"gpu-applier/{tenant_id}/{document_id}", snap)
    applier._applied_seq = {int(k): v for k, v in
                            meta.get("applied_seq", {}).items()}
    for slot, seq in applier._applied_seq.items():
        applier._dispatched_seq[slot] = seq  # the save finalized them
    applier._first_seq = {int(k): v for k, v in
                          meta.get("first_seq", {}).items()}
    # a checkpoint without an anchor set (written before coverage
    # tracking) restores unanchored: safe, never lossy
    applier._anchored = set(meta.get("anchored", []))
    # restored anchors are conditional: the summarizer also verifies that
    # no ops were sequenced in the restart window (restore_gap)
    applier._restore_applied = dict(applier._applied_seq)
    # a window the checkpoint itself left open keeps its older low bound,
    # so the gate inspects the union of both windows
    for k, v in meta.get("restore_applied", {}).items():
        slot = int(k)
        applier._restore_applied[slot] = min(
            v, applier._restore_applied.get(slot, v))
    return applier
