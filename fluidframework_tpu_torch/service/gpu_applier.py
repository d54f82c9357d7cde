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
there is one shard on ``device`` (the dense lane). With ``mesh=`` (a
``parallel.mesh.Mesh``, or an int: that many shards on the cards, or on
``[device] * n`` when ``device`` is named) the docs axis is cut into the
mesh's docs shards, each on its own device (several may share one), and
``DocPlacement`` routes a doc to a (shard, slot) whose global row is
``shard * slots_per_shard + slot``. A mesh wave stages only its ACTIVE
shards (``_stage_wave_mesh``): rows sorted by shard once, each active
shard scattered into its own pinned buffers and copied to its device;
inactive shards get a zero wave already resident there. The step
(``parallel/sharded_apply.make_sharded_packed_step``) then runs every
shard's unpack → B1 → zamboni on its device. Dropped from the JAX lane
as TPU/XLA artifacts: ``NamedSharding`` assembly, donation, the Pallas
tile rule (docs per shard % 8) and the staging thread pool (the copies
are asynchronous already).

A dispatch has two halves. The host half (``_stage_wave``) packs the
wave's rows (``ops/apply.pack_wave_rows``) into an int16 [D, K, 12] delta
wave plus int32 [D, 2] bases, scatters them into one of two rotating sets
of pinned host buffers and copies them to the card with ``non_blocking``
on the applier's own CUDA stream. The device half (``_execute_wave``)
enqueues ``unpack_wave16`` → ``ops/cuda_apply.apply_ops_batch`` (the
hand-written CUDA kernel) → ``compact_batch`` at ``wave_min_seq`` on the
same stream and records a CUDA event after it. A wave whose deltas escape
int16 ships at full int32 width instead and skips the unpack. With
``overlap`` on (the default) nothing waits for the card, so the host
stages wave N+1 while wave N runs; with it off every step is fenced.

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
point); the caller's thread only appends staged chunks under a lock.
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
from collections import deque
from contextlib import ExitStack
from dataclasses import replace
from typing import Optional, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..mergetree.client import MergeTreeClient
from ..obs import get_registry
from ..ops import cuda_apply
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
    compact_batch,
    pack_wave_rows,
    unpack_wave16,
    wave_min_seq,
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
    state_from_numpy,
)
from ..parallel.mesh import Mesh, make_mesh, virtual_devices
from ..parallel.placement import DocPlacement
from ..parallel.sharded_apply import (
    make_sharded_packed_step,
    shard_state,
    unshard_state,
)
from ..protocol.messages import MessageType
from ..utils.affinity import blocking

MARKER_GLYPH = "￼"  # arena placeholder byte for markers (flags classify)

INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1

_TORCH_DTYPE = {np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


def channel_stream(server, tenant_id: str, document_id: str,
                   ds_id: str, channel_id: str, from_seq: int = 0):
    """Extract one channel's merge-tree messages from the document's
    sequenced op log (scriptorium) — the applier's replay source and the
    scribe-replay entry point.

    Truncated logs raise (scriptorium.LogTruncatedError): with log
    retention active, a from-zero replay would silently rebuild WRONG
    state once ops behind an acked summary have been dropped. Reads go
    straight through a stateless ScriptoriumLambda over the db so
    inspecting a doc never lazily constructs its whole pipeline."""
    from .scriptorium import ScriptoriumLambda

    for m in ScriptoriumLambda(server.db).get_deltas(
            tenant_id, document_id, from_seq, 10**9):
        if m.type != MessageType.OPERATION:
            continue
        env = m.contents
        if not isinstance(env, dict) or env.get("kind") != "chanop":
            continue
        if env["address"] != ds_id:
            continue
        inner = env["contents"]
        if inner.get("address") != channel_id or "attach" in inner:
            continue
        yield replace(m, contents=inner["contents"])


class _StagedWave:
    """The output of the stage half of a dispatch: device-resident input
    tensors plus what the execute half needs to run and account for the
    wave. Holding one of these means the wave's ops have LEFT the staged
    dict but have not yet been issued to the device."""

    __slots__ = ("lane", "wide", "arrays", "n", "nbytes", "flip")

    def __init__(self, lane: str, wide: bool, arrays: tuple, n: int,
                 nbytes: int, flip: int):
        self.lane = lane        # "dense" | "mesh" (metrics label)
        self.wide = wide        # int32 escape lane (range / force_wide)
        self.arrays = arrays    # device tensors (mesh: per-shard lists)
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
        # mesh-lane staging counters: per-wave staged bytes scale with
        # ACTIVE shards, never with max_docs
        self.mesh_waves = 0
        self.mesh_active_shards = 0
        self.mesh_staged_bytes = 0
        self.mesh_stage_seconds = 0.0
        if mesh is not None:
            self._sharded_step = make_sharded_packed_step(mesh)
            # per-device resident zero shards, reused every wave for
            # INACTIVE shards (no host allocation, no copy)
            self._zero_shards: dict = {}
        self.arenas = [TextArena() for _ in range(self.max_docs)]
        self.prop_table = PropTable()  # shared across docs; ids are dense
        # per-doc dense client interning (collision-free by construction)
        self._client_ids: dict[int, dict[str, int]] = {}
        # staged device ops per slot: a list of int32 [n, OP_FIELDS]
        # chunks (one per ingested batch); _staged_ops is the row count
        self._staged: dict[int, list] = {}
        self._staged_ops = 0
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
        # (start, end) timing events of steps not yet folded into
        # exec_device_seconds, one pair per device a step
        self._timed_steps: deque = deque()
        self.stage_seconds = 0.0
        self.stage_overlap_seconds = 0.0
        self.stage_bytes = 0
        self.exec_seconds = 0.0
        # card time from each step's first enqueued launch to its end
        # (host gaps between the step's eager launches included)
        self.exec_device_seconds = 0.0
        self.waves_staged = 0
        self.last_wave_hops: Optional[tuple[float, float]] = None
        self._last_stage_wall: Optional[float] = None
        self._registry = None
        self.dispatches = 0
        self.wide_dispatches = 0
        self.ops_applied = 0
        self.host_escalations = 0
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
        batch."""
        slot = self.slot_of(tenant_id, document_id)
        if pairs:
            # sequenced stream ⇒ pairs arrive in seq order; the last is max
            self._applied_seq[slot] = max(
                self._applied_seq.get(slot, 0),
                pairs[-1][0].sequence_number)
            self._first_seq.setdefault(slot, pairs[0][0].sequence_number)
            if slot in self._restore_applied:
                self._post_restore_first.setdefault(
                    slot, pairs[0][0].sequence_number)
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

    def ingest_array_batch(self, tenant_id: str, document_id: str,
                           batch) -> None:
        """Stage a SequencedArrayBatch (``service/array_batch.py``) as ONE
        vectorised chunk: no per-op dicts, tuples or message objects.
        Annotates with other than one prop key take the per-op path."""
        slot = self.slot_of(tenant_id, document_id)
        box = batch.boxcar
        n = box.n
        if n == 0:
            return
        self._applied_seq[slot] = max(self._applied_seq.get(slot, 0),
                                      batch.base_seq + n - 1)
        self._first_seq.setdefault(slot, batch.base_seq)
        if slot in self._restore_applied:
            self._post_restore_first.setdefault(slot, batch.base_seq)

        def pairs():
            return [(batch.message(i), box.wire_op(i)) for i in range(n)]

        if slot in self._host_docs:
            for msg, wire_op in pairs():
                self._apply_host(slot, msg, wire_op)
            return
        kind = np.asarray(box.kind)
        ann_idx = np.nonzero(kind == 2)[0]  # wire kind 2 = annotate
        if len(ann_idx) and (
                box.props is None
                or any(len(box.props[int(i)] or {}) != 1 for i in ann_idx)):
            self.ingest_batch(tenant_id, document_id, pairs())
            return
        table = self._client_ids.setdefault(slot, {})
        client = table.get(box.client_id)
        if client is None:
            client = len(table)
            table[box.client_id] = client
        chunk = np.zeros((n, OP_FIELDS), np.int32)
        # wire kinds (0 ins, 1 rem, 2 ann) → device op codes (1, 2, 3)
        chunk[:, F_TYPE] = kind.astype(np.int32) + 1
        chunk[:, F_POS] = box.a
        chunk[:, F_END] = box.b
        chunk[:, F_SEQ] = batch.base_seq + np.arange(n, dtype=np.int64)
        chunk[:, F_REFSEQ] = box.rseq
        chunk[:, F_CLIENT] = client
        chunk[:, F_MSN] = batch.msns
        arena_start = self.arenas[slot].append(box.text)
        text_off = np.asarray(box.text_off)
        chunk[:, F_TLEN] = np.diff(text_off)
        chunk[:, F_TSTART] = arena_start + text_off[:-1]
        for i in ann_idx:
            (k, v), = box.props[int(i)].items()
            chunk[i, F_KEY] = self.prop_table.intern_key(k)
            chunk[i, F_VAL] = (NO_VAL if v is None
                               else self.prop_table.intern_val(v))
        self._push_chunk(slot, chunk)

    def _push_chunk(self, slot: int, chunk: np.ndarray) -> None:
        """Append a staged [n, OP_FIELDS] chunk (the ONLY staging-count
        mutation point besides _take_wave_locked/_drop_staged)."""
        with self._lock:
            self._staged.setdefault(slot, []).append(chunk)
            self._staged_ops += len(chunk)

    def _drop_staged(self, slot: int) -> None:
        """Discard a slot's staged chunks (escalation path), keeping the
        staged-op count consistent."""
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
            self._wake.set()
            return 0
        return self._flush_sync()

    def _flush_sync(self) -> int:
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
            self._draining = True
            try:
                while True:
                    self._check_worker()
                    self._wake.set()
                    with self._lock:
                        empty = not self._staged
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
            self._fold_step_times()
            self._check_overflow()
            return
        self._flush_sync()
        self._drain_device()
        self._fold_step_times()
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
            # overflow the worker found but finalize never escalated: the
            # flags are sticky on the card, so the next read polls again
            self._dispatches_since_check = max(self._dispatches_since_check,
                                               1)
        self._drain_device()
        self._fold_step_times()
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
        a view, keeping order."""
        if not self._staged:
            return None
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

    def _dispatch_wave(self, parts) -> int:
        """Stage then execute one wave (the caller has the applier's
        stream current). Overlap comes from the execute half being an
        asynchronous enqueue: the NEXT wave's stage half runs on the host
        while this wave runs on the card."""
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
                if not self._draining and self._min_wave \
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
        with self._on_streams():
            return np.concatenate([s.overflow.cpu().numpy()
                                   for s in self._shards])

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
            for event in pending:
                event.synchronize()
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
        for event in self._exec_markers:
            event.synchronize()

    def _fold_step_times(self) -> None:
        """Add completed steps' card times to exec_device_seconds. Runs
        only on the dispatching thread, or with the worker idle."""
        steps = self._timed_steps
        while steps and steps[0][1].query():
            start, end = steps.popleft()
            self.exec_device_seconds += start.elapsed_time(end) / 1e3

    def _stage_wave(self, parts) -> Optional[_StagedWave]:
        """The HOST half of a dispatch: concat chunks → pack_wave_rows →
        scatter into the rotating pinned buffers → asynchronous copy on
        the applier's stream. No compute is enqueued. In mesh mode the
        scatter targets compact per-shard buffers for ACTIVE shards only
        (``_stage_wave_mesh``), never an O(max_docs) host array."""
        if parts is None:
            return None
        t0 = time.perf_counter()
        parts = [p for p in parts if p[2]]  # interval-only batches: no rows
        if not parts:
            return None
        chunks = [ch for _slot, take, _n in parts for ch in take]
        flat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        n = len(flat)
        lens_a = np.array([count for _s, _t, count in parts])
        starts = np.cumsum(lens_a) - lens_a
        slots_a = np.array([slot for slot, _t, _n in parts], np.int64)
        doc_idx = np.repeat(slots_a, lens_a)
        pos_idx = np.arange(n, dtype=np.int64) - np.repeat(starts, lens_a)
        packed, seq_base, text_base = pack_wave_rows(flat, starts, lens_a)

        force_wide = (
            self.fault_plane is not None
            and self.fault_plane("applier.dispatch", ops=n) == "force_wide")
        if force_wide:
            # the forced int32 lane is a different program: drain the
            # pipeline so the width flip never reorders around an
            # in-flight packed wave
            self._drain_device()
        fits16 = (not force_wide and packed.min() >= INT16_MIN
                  and packed.max() <= INT16_MAX)
        self._rotate_stage_buffers()
        shape = (self.max_docs, self.K, OP_FIELDS)
        if self._mesh is not None:
            staged = self._stage_wave_mesh(
                flat, packed if fits16 else None, doc_idx, pos_idx,
                slots_a, seq_base, text_base, n)
        elif fits16:
            wave16, wave16_np = self._stage_buffer(shape, np.int16)
            wave16_np[doc_idx, pos_idx] = packed
            bases, bases_np = self._stage_buffer((self.max_docs, 2), np.int32)
            bases_np[slots_a, 0] = seq_base
            bases_np[slots_a, 1] = text_base
            # asynchronous copies on the applier's stream (current on
            # this thread); on the CPU .to() returns the buffer itself
            staged = _StagedWave(
                "dense", False, (wave16.to(self.device, non_blocking=True),
                                 bases.to(self.device, non_blocking=True)),
                n, wave16_np.nbytes + bases_np.nbytes, self._stage_flip)
        else:
            # a field escaped int16 (giant doc, huge window): ship the
            # wave at full int32 width
            wide, wide_np = self._stage_buffer(shape, np.int32)
            wide_np[doc_idx, pos_idx] = flat
            staged = _StagedWave(
                "dense", True, (wide.to(self.device, non_blocking=True),),
                n, wide_np.nbytes, self._stage_flip)
        dt = time.perf_counter() - t0
        # overlap accounting: this stage half counts as HIDDEN time when
        # the previous step is still executing (query() is non-blocking,
        # so the measurement never perturbs the pipeline it measures)
        overlapped = any(not e.query() for e in self._exec_markers)
        self.waves_staged += 1
        self.stage_seconds += dt
        self.stage_bytes += staged.nbytes
        if overlapped:
            self.stage_overlap_seconds += dt
        if self._mesh is not None:
            self.mesh_stage_seconds += dt
        reg = self._metrics()
        reg.inc("applier.stage.seconds", dt, lane=staged.lane)
        reg.inc("applier.stage.bytes", staged.nbytes, lane=staged.lane)
        reg.set_gauge("applier.stage.overlap_ratio",
                      self.stage_overlap_ratio(), lane=staged.lane)
        # applier/stage hop: wall-clock stamp at stage completion —
        # _execute_wave closes the stage→execute leg
        self._last_stage_wall = time.time()
        if self.fault_plane is not None:
            # chaos seam: wave N+1 staged (popped from the staging dict,
            # copies enqueued) but NOT yet executed — a crash here must
            # lose nothing: restore replays it from the log
            self.fault_plane("applier.stage.staged", ops=n)
        return staged

    def _stage_wave_mesh(self, flat, packed, doc_idx, pos_idx, slots_a,
                         seq_base, text_base, n: int) -> _StagedWave:
        """Mesh-lane stage: scatter the wave into per-ACTIVE-shard pinned
        buffers and copy each to its shard's device, so host staging
        cost and copied bytes are O(active shards · K), never
        O(max_docs). The wave's rows are sorted by shard ONCE (each
        shard's rows become a contiguous slice). ``packed=None`` ships
        the int32 wide wave (int16 range escape / chaos force_wide)."""
        sps = self.placement.slots_per_shard
        K = self.K
        row_shard, local_doc = self.placement.split_rows(doc_idx)
        order = np.argsort(row_shard, kind="stable")
        sorted_shard = row_shard[order]
        active = np.unique(sorted_shard)
        n_active = len(active)
        lo = np.searchsorted(sorted_shard, active, side="left")
        hi = np.searchsorted(sorted_shard, active, side="right")
        ld, pi = local_doc[order], pos_idx[order]
        wide = packed is None
        dtype = np.int32 if wide else np.int16
        rows = (flat if wide else packed)[order]
        W, W_np = self._stage_buffer((n_active, sps, K, OP_FIELDS), dtype)
        for i in range(n_active):
            a, b = lo[i], hi[i]
            W_np[i][ld[a:b], pi[a:b]] = rows[a:b]
        arrays = (self._mesh_assemble(
            {int(s): W[i] for i, s in enumerate(active)}, (K, OP_FIELDS),
            dtype),)
        staged_bytes = W_np.nbytes
        if not wide:
            B, B_np = self._stage_buffer((n_active, sps, 2), np.int32)
            doc_shard, local_slot = self.placement.split_rows(slots_a)
            dorder = np.argsort(doc_shard, kind="stable")
            sorted_doc_shard = doc_shard[dorder]
            dlo = np.searchsorted(sorted_doc_shard, active, side="left")
            dhi = np.searchsorted(sorted_doc_shard, active, side="right")
            ls = local_slot[dorder]
            sb, tb = seq_base[dorder], text_base[dorder]
            for i in range(n_active):
                da, db = dlo[i], dhi[i]
                B_np[i][ls[da:db], 0] = sb[da:db]
                B_np[i][ls[da:db], 1] = tb[da:db]
            arrays += (self._mesh_assemble(
                {int(s): B[i] for i, s in enumerate(active)}, (2,),
                np.int32),)
            staged_bytes += B_np.nbytes
        self.mesh_waves += 1
        self.mesh_active_shards += n_active
        self.mesh_staged_bytes += staged_bytes
        return _StagedWave("mesh", wide, arrays, n, staged_bytes,
                           self._stage_flip)

    def _mesh_assemble(self, shard_bufs: dict, tail: tuple,
                       dtype) -> list:
        """The per-shard device inputs of a mesh wave: each active shard's
        host block copied (``non_blocking``) to its device, and for every
        INACTIVE shard a zero block already resident on its device."""
        key = (np.dtype(dtype).str,) + tail
        zeros = self._zero_shards.get(key)
        if zeros is None:
            shape = (self.placement.slots_per_shard,) + tail
            zeros = self._zero_shards[key] = {
                d: torch.zeros(shape, dtype=_TORCH_DTYPE[np.dtype(dtype)],
                               device=d)
                for d in dict.fromkeys(self._shard_devices)}
        return [zeros[d] if s not in shard_bufs
                else shard_bufs[s].to(d, non_blocking=True)
                for s, d in enumerate(self._shard_devices)]

    def _execute_wave(self, staged: _StagedWave) -> int:
        """The DEVICE half: enqueue the step on the applier's streams
        (current on the calling thread) behind the wave's copies, and
        record one completion event per device. With overlap on nothing
        waits; with it off the step is fenced before returning (the
        serialized behavior, kept for A/B)."""
        t0 = time.perf_counter()
        starts = {}
        for device, stream in self._streams.items():
            starts[device] = torch.cuda.Event(enable_timing=True)
            starts[device].record(stream)
        if staged.wide:
            self.wide_dispatches += 1
        if staged.lane == "mesh":
            packed_fn, wide_fn = self._sharded_step
            fn = wide_fn if staged.wide else packed_fn
            self._shards, _stats = fn(self._shards, *staged.arrays)
        else:
            wave = (staged.arrays[0] if staged.wide
                    else unpack_wave16(*staged.arrays))
            state = cuda_apply.apply_ops_batch(self._shards[0], wave)
            self._shards = [compact_batch(state, wave_min_seq(wave))]
        if starts:
            ends = []
            for device, stream in self._streams.items():
                end = torch.cuda.Event(enable_timing=True)
                end.record(stream)
                ends.append(end)
                self._timed_steps.append((starts[device], end))
            self._exec_markers = ends
            # the wave's staging set may be refilled only after this
            # step (and so its copies) completes: _rotate_stage_buffers
            # fences on it
            self._stage_inflight[staged.flip] = ends
            if not self._overlap:
                for end in ends:
                    end.synchronize()
            self._fold_step_times()
        dt = time.perf_counter() - t0
        self.exec_seconds += dt
        reg = self._metrics()
        reg.inc("applier.exec.seconds", dt, lane=staged.lane)
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

    # ------------------------------------------------------------- queries

    def _sync(self, slot: int) -> None:
        """Flush + overflow-check before exposing a doc's state."""
        if self._async:
            self.finalize()
            return
        if self._staged.get(slot):
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
        to refuse writing a summary from lagging device state."""
        return self._applied_seq.get(self.slot_of(tenant_id, document_id), 0)

    def first_seq(self, tenant_id: str, document_id: str) -> int:
        """First sequence number ever ingested for the doc (0 if none)."""
        return self._first_seq.get(self.slot_of(tenant_id, document_id), 0)

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
        if slot not in self._restore_applied:
            return None
        return (self._restore_applied[slot],
                self._post_restore_first.get(slot))

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
        replica = MergeTreeClient(f"gpu-applier/{tenant_id}/{document_id}")
        self._host_docs[slot] = replica
        self._drop_staged(slot)
        for m in self._replay_log(tenant_id, document_id):
            if m.type == MessageType.OPERATION:
                replica.apply_msg(m, local=False)
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
