"""GpuDocumentApplier: the batched server-side merge-tree replica farm.

JAX counterpart: ``fluidframework_tpu/service/tpu_applier.py::
TpuDocumentApplier``, its dense lane. The service keeps thousands of
documents as ONE device-resident structure-of-arrays batch
(``ops/doc_state.DocState`` with a leading doc dimension) and applies every
sequenced merge-tree op to it in waves of up to K ops per doc.

Each wave is staged on the host (``_stage_wave``: the rows of every doc
packed by ``ops/apply.pack_wave_rows`` into an int16 [D, K, 12] delta wave
plus int32 [D, 2] bases) and copied to the card, where one step runs
``unpack_wave16`` → ``ops/cuda_apply.apply_ops_batch`` (the hand-written
CUDA kernel) → ``compact_batch`` at ``wave_min_seq``. A wave whose deltas
escape int16 ships at full int32 width instead and skips the unpack.

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

Not ported yet (see ROADMAP.md): the async worker thread, overlapping
staging with execution on a CUDA stream with pinned double buffers, the
mesh lane, checkpoints, the chaos seams and the metrics registry. Here the
host→device copy of a wave is synchronous.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Union

import numpy as np
import torch

from ..config import ApplierConfig
from ..device import resolve_device
from ..mergetree.client import MergeTreeClient
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
)
from ..parallel.placement import DocPlacement
from ..protocol.messages import MessageType, SequencedDocumentMessage

MARKER_GLYPH = "￼"  # arena placeholder byte for markers (flags classify)

INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1


def _array_message(batch, i: int) -> SequencedDocumentMessage:
    """Op ``i`` of a sequenced array batch as a message, read from the
    batch's arrays alone (the client seq plays no part in the merge)."""
    box = batch.boxcar
    return SequencedDocumentMessage(
        client_id=box.client_id,
        sequence_number=batch.base_seq + i,
        minimum_sequence_number=int(batch.msns[i]),
        client_sequence_number=0,
        reference_sequence_number=int(box.rseq[i]),
        type=MessageType.OPERATION,
        contents=None,
    )


def _array_wire_op(box, i: int) -> dict:
    """Op ``i`` of an array boxcar as a merge-tree wire op."""
    k = int(box.kind[i])
    if k == 0:
        return {"type": 0, "pos": int(box.a[i]),
                "text": box.text[int(box.text_off[i]):
                                 int(box.text_off[i + 1])]}
    if k == 1:
        return {"type": 1, "start": int(box.a[i]), "end": int(box.b[i])}
    return {"type": 2, "start": int(box.a[i]), "end": int(box.b[i]),
            "props": dict(box.props[i]) if box.props else {}}


class GpuDocumentApplier:
    """Maintains [D, S] doc states on one device, fed by sequenced op
    streams. ``device`` defaults to ``cuda`` and raises without a card;
    ``device="cpu"`` runs the plain PyTorch versions."""

    def __init__(
        self,
        max_docs: Optional[int] = None,
        max_slots: Optional[int] = None,
        ops_per_dispatch: Optional[int] = None,
        overflow_check_every: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        cfg = ApplierConfig.from_env()
        self.device = resolve_device(device)
        self.max_docs = max_docs if max_docs is not None else cfg.max_docs
        self.max_slots = max_slots if max_slots is not None else cfg.max_slots
        self.K = (ops_per_dispatch if ops_per_dispatch is not None
                  else cfg.ops_per_dispatch)
        # reading the overflow flags is a device→host sync, so flush()
        # polls them only every N dispatches. Deferral is safe: the flag
        # is sticky and escalation replays the doc from its log; reads and
        # finalize() always check first.
        self.overflow_check_every = (
            overflow_check_every if overflow_check_every is not None
            else cfg.overflow_check_every)
        self._dispatches_since_check = 0
        self.placement = DocPlacement(n_shards=1,
                                      slots_per_shard=self.max_docs)
        self.state = DocState.empty(self.max_docs, self.max_slots,
                                    device=self.device)
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
        self._applied_seq: dict[int, int] = {}
        self._first_seq: dict[int, int] = {}
        # the host replay source: fn(tenant, doc) -> iterable of
        # CHANNEL-LEVEL sequenced merge-tree messages
        self._replay_log = None
        self.dispatches = 0
        self.wide_dispatches = 0
        self.ops_applied = 0
        self.host_escalations = 0

    # ------------------------------------------------------------- ingest

    def slot_of(self, tenant_id: str, document_id: str) -> int:
        """State row of a doc (the one-shard placement's slot)."""
        shard, slot = self.placement.place(tenant_id, document_id)
        row = shard * self.placement.slots_per_shard + slot
        self._doc_keys.setdefault(row, (tenant_id, document_id))
        return row

    def _intern_client(self, slot: int, client_id: Optional[str]) -> int:
        if client_id is None:
            return SYSTEM_CLIENT
        table = self._client_ids.setdefault(slot, {})
        cid = table.get(client_id)
        if cid is None:
            cid = len(table)
            table[client_id] = cid
        return cid

    def ingest(self, tenant_id: str, document_id: str, msg,
               wire_op: dict) -> None:
        """Stage one sequenced merge-tree wire op for batched apply."""
        self.ingest_batch(tenant_id, document_id, [(msg, wire_op)])

    def ingest_batch(self, tenant_id: str, document_id: str,
                     pairs: list) -> None:
        """Stage a batch of (sequenced message, wire op) pairs of one doc,
        in seq order. Staging is tuple appends; one array per batch."""
        slot = self.slot_of(tenant_id, document_id)
        if pairs:
            self._applied_seq[slot] = max(
                self._applied_seq.get(slot, 0),
                pairs[-1][0].sequence_number)
            self._first_seq.setdefault(slot, pairs[0][0].sequence_number)
        if slot in self._host_docs:
            for msg, wire_op in pairs:
                self._apply_host(slot, msg, wire_op)
            return
        staged = []
        arena = self.arenas[slot]
        for i, (msg, wire_op) in enumerate(pairs):
            ok = type(wire_op) is dict and self._stage_op(
                staged, arena, wire_op, msg.sequence_number,
                msg.reference_sequence_number,
                self._intern_client(slot, msg.client_id),
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
        """Stage a sequenced array batch (``service/array_batch.py``, or
        anything with its fields) as ONE vectorised chunk. It reads
        ``boxcar.{n, kind, a, b, rseq, text, text_off, props, client_id}``,
        ``base_seq`` and ``msns``. Annotates with other than one prop key
        take the per-op path."""
        slot = self.slot_of(tenant_id, document_id)
        box = batch.boxcar
        n = box.n
        if n == 0:
            return
        self._applied_seq[slot] = max(self._applied_seq.get(slot, 0),
                                      batch.base_seq + n - 1)
        self._first_seq.setdefault(slot, batch.base_seq)

        def pairs():
            return [(_array_message(batch, i), _array_wire_op(box, i))
                    for i in range(n)]

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
        client = self._intern_client(slot, box.client_id)
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
        self._staged.setdefault(slot, []).append(chunk)
        self._staged_ops += len(chunk)

    def _drop_staged(self, slot: int) -> None:
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
        for k, v in props.items():
            staged.append((OP_ANNOTATE, start, end, seq, ref, client, 0, 0,
                           msn, 0, self.prop_table.intern_key(k),
                           NO_VAL if v is None
                           else self.prop_table.intern_val(v)))

    # -------------------------------------------------------------- flush

    def flush(self) -> int:
        """Dispatch every staged op to the device in [D, K] waves; returns
        the number of op rows dispatched."""
        total = 0
        while self._staged:
            total += self._dispatch_wave(self._take_wave())
        self.ops_applied += total
        if self._dispatches_since_check >= self.overflow_check_every:
            self._check_overflow()
        return total

    def finalize(self) -> None:
        """Flush staged ops and poll the overflow flags: after this, every
        doc's state (or its host escalation) reflects everything
        ingested."""
        self.flush()
        if self._dispatches_since_check:
            self._check_overflow()

    def _take_wave(self) -> list:
        """Pop up to K staged op rows per doc: [(slot, chunks, rows)]. A
        chunk that does not fit is split by a view, keeping order."""
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
        """Stage one wave on the host, copy it to the device and run the
        step there. Returns the op rows in the wave."""
        parts = [p for p in parts if p[2]]  # interval-only batches: no rows
        if not parts:
            return 0
        chunks = [ch for _slot, take, _n in parts for ch in take]
        flat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        n = len(flat)
        lens_a = np.array([count for _s, _t, count in parts])
        starts = np.cumsum(lens_a) - lens_a
        slots_a = np.array([slot for slot, _t, _n in parts], np.int64)
        doc_idx = np.repeat(slots_a, lens_a)
        pos_idx = np.arange(n, dtype=np.int64) - np.repeat(starts, lens_a)
        packed, seq_base, text_base = pack_wave_rows(flat, starts, lens_a)
        shape = (self.max_docs, self.K, OP_FIELDS)
        if packed.min() >= INT16_MIN and packed.max() <= INT16_MAX:
            wave16 = np.zeros(shape, np.int16)
            wave16[doc_idx, pos_idx] = packed
            bases = np.zeros((self.max_docs, 2), np.int32)
            bases[slots_a, 0] = seq_base
            bases[slots_a, 1] = text_base
            wave = unpack_wave16(torch.from_numpy(wave16).to(self.device),
                                 torch.from_numpy(bases).to(self.device))
        else:
            # a field escaped int16 (giant doc, huge window): ship the
            # wave at full int32 width
            wide = np.zeros(shape, np.int32)
            wide[doc_idx, pos_idx] = flat
            wave = torch.from_numpy(wide).to(self.device)
            self.wide_dispatches += 1
        state = cuda_apply.apply_ops_batch(self.state, wave)
        self.state = compact_batch(state, wave_min_seq(wave))
        self.dispatches += 1
        self._dispatches_since_check += 1
        return n

    def _check_overflow(self) -> None:
        self._dispatches_since_check = 0
        flags = self.state.overflow.cpu().numpy()  # device→host sync
        for slot in np.nonzero(flags)[0]:
            if int(slot) not in self._host_docs:
                self._escalate(int(slot), None, None)

    # ------------------------------------------------------------- queries

    def _sync(self, slot: int) -> None:
        """Flush + overflow-check before exposing a doc's state."""
        if self._staged.get(slot):
            self.flush()
        if self._dispatches_since_check:
            self._check_overflow()

    def _row(self, slot: int) -> dict:
        """Doc ``slot``'s state fields as numpy arrays."""
        return {f: getattr(self.state, f)[slot].cpu().numpy()
                for f in FIELDS}

    def slot_count(self, tenant_id: str, document_id: str) -> int:
        """Live device slots of a doc (bounded under churn by zamboni)."""
        slot = self.slot_of(tenant_id, document_id)
        return int(self.state.count[slot])

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
        tree = decode_state(self.state, self.arenas[slot], self.prop_table,
                            doc=slot)
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
        """Highest sequence number ingested for the doc (0 if none)."""
        return self._applied_seq.get(self.slot_of(tenant_id, document_id), 0)

    def first_seq(self, tenant_id: str, document_id: str) -> int:
        """First sequence number ever ingested for the doc (0 if none)."""
        return self._first_seq.get(self.slot_of(tenant_id, document_id), 0)

    # ---------------------------------------------------- host escalation

    def set_replay_source(self, fn) -> None:
        """``fn(tenant, doc)`` yields the doc's channel-level sequenced
        merge-tree messages from the start; escalation replays them."""
        self._replay_log = fn

    def _escalate(self, slot: int, msg, wire_op) -> None:
        """Rebuild the doc on the scalar oracle from its authoritative op
        log and continue host-side."""
        tenant_id, document_id = self._doc_keys[slot]
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
        if msg is not None:
            self._apply_host(slot, msg, wire_op)

    def _apply_host(self, slot: int, msg, wire_op) -> None:
        replica = self._host_docs[slot]
        if msg.sequence_number <= replica.tree.current_seq:
            return  # already covered by the escalation replay
        replica.apply_msg(replace(msg, contents=wire_op), local=False)
