"""MergeTree: ordered segment store with perspective-correct operations.

Scalar oracle for the TPU kernels. A flat ordered list stands in for the
reference's 8-ary B-tree (mergeTree.ts:333): every query is an O(n) scan
here; the kernel version does the same math as masked prefix sums on int32
arrays (see fluidframework_tpu.ops). Semantic parity targets, with
reference anchors:

- position resolution at (refSeq, clientId)      — partialLengths.ts:432
- concurrent-insert tie-break                    — mergeTree.ts:2281 (breakTie)
- remove/annotate over perspective-visible spans — mergeTree.ts:2640,2598
- own-op ack stamping                            — mergeTree.ts:1926
- collab-window compaction (zamboni)             — mergeTree.ts:1455

Tie-break rule (convergent; see tests/test_mergetree_farm.py): among
segments inserted concurrently at the same resolved position, HIGHER
sequence number sorts EARLIER; a client's own unacked segments
(ins_seq = UNASSIGNED_SEQ) sort earliest of all. Both sides of every race
order segments identically because the rule depends only on stamps.

JAX counterpart: ``fluidframework_tpu/mergetree/mergetree.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..protocol.messages import UNASSIGNED_SEQ, UNIVERSAL_SEQ
from .perspective import Perspective
from .references import LocalReference, ReferenceType
from .segments import NO_CLIENT, Segment


class MergeTree:
    def __init__(self):
        self.segments: list[Segment] = []
        self.min_seq = 0
        self.current_seq = 0

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def visible_length(self, perspective: Perspective) -> int:
        return sum(s.visible_length(perspective) for s in self.segments)

    def get_text(self, perspective: Perspective) -> str:
        out = []
        for s in self.segments:
            if s.visible_in(perspective) and not s.is_marker:
                out.append(s.text)
        return "".join(out)

    def resolve(self, pos: int, perspective: Perspective) -> tuple[int, int]:
        """Map a perspective position to (segment index, in-segment offset).

        Lands on the EARLIEST boundary when ``pos`` falls between segments
        (i.e. before any run of perspective-invisible segments); the insert
        tie-break then walks forward from there. offset > 0 means strictly
        inside segment ``index``.
        """
        if pos < 0:
            raise IndexError(f"negative position {pos}")
        remaining = pos
        for i, seg in enumerate(self.segments):
            if remaining == 0:
                return (i, 0)
            vl = seg.visible_length(perspective)
            if remaining < vl:
                return (i, remaining)
            remaining -= vl
        if remaining == 0:
            return (len(self.segments), 0)
        raise IndexError(
            f"position {pos} out of range (len {self.visible_length(perspective)})"
        )

    def visible_segment_at(
        self, pos: int, perspective: Perspective
    ) -> tuple[Optional[Segment], int]:
        """The segment holding the visible character AT ``pos`` (walking
        past invisible segments on a boundary), with the in-segment
        offset; (None, 0) when pos is the end of the document. The
        shared resolve-then-walk step of reference creation and item
        lookup — tree-structure-agnostic, unlike raw index math."""
        idx, offset = self.resolve(pos, perspective)
        segs = self.segments
        if offset == 0:
            while idx < len(segs) and \
                    segs[idx].visible_length(perspective) == 0:
                idx += 1
        if idx >= len(segs):
            return None, 0
        return segs[idx], offset

    def properties_at(self, pos: int, perspective: Perspective) -> dict:
        """Properties of the visible character at ``pos``."""
        seg, _ = self.visible_segment_at(pos, perspective)
        if seg is None:
            raise IndexError(pos)
        return dict(seg.props)

    def remove_segment(self, seg: Segment) -> None:
        """Physically remove a segment (reconnect re-placement path)."""
        self.segments.remove(seg)

    def position_of_segment(self, target: Segment, perspective: Perspective) -> int:
        """Perspective position of the first character of ``target``."""
        pos = 0
        for seg in self.segments:
            if seg is target:
                return pos
            pos += seg.visible_length(perspective)
        raise ValueError("segment not in tree")

    def local_reference_position(self, ref: LocalReference, perspective: Perspective) -> int:
        if ref.segment is None:
            return 0
        base = self.position_of_segment(ref.segment, perspective)
        if ref.segment.visible_in(perspective):
            return base + ref.offset
        return base

    # ------------------------------------------------------------------
    # mutation: insert
    # ------------------------------------------------------------------
    def insert_segment(
        self,
        pos: int,
        segment: Segment,
        perspective: Perspective,
    ) -> Segment:
        """Insert ``segment`` at perspective position ``pos``.

        ``segment`` arrives pre-stamped (UNASSIGNED for local ops, the
        assigned seq for remote ops). Implements the earliest-boundary +
        higher-seq-leftward tie-break described in the module docstring
        (ref: insertingWalk/breakTie mergeTree.ts:2378,2281).
        """
        idx, offset = self.resolve(pos, perspective)
        if offset > 0:
            tail = self.segments[idx].split(offset)
            self.segments.insert(idx + 1, tail)
            idx += 1
        else:
            # effective insert key: pending segments compare by
            # (UNASSIGNED, local_seq) so re-placed reconnect inserts order
            # among their own in-flight siblings exactly as their eventual
            # seqs will
            new_key = (segment.ins_seq, segment.ins_local_seq or 0)
            bound = perspective.local_seq
            while idx < len(self.segments):
                s = self.segments[idx]
                ins_seen = (
                    s.ins_client == perspective.client
                    and not (
                        bound is not None
                        and s.ins_local_seq is not None
                        and s.ins_local_seq > bound
                    )
                ) or s.ins_seq <= perspective.ref_seq
                if ins_seen:
                    break  # author saw it: position is relative to it, stay left
                if (s.ins_seq, s.ins_local_seq or 0) <= new_key:
                    break  # concurrent but earlier-sequenced: we sort before it
                idx += 1
        self.segments.insert(idx, segment)
        return segment

    # ------------------------------------------------------------------
    # mutation: remove
    # ------------------------------------------------------------------
    def mark_removed(
        self,
        start: int,
        end: int,
        perspective: Perspective,
        rem_seq: int,
        rem_client: int,
        rem_local_seq: Optional[int] = None,
    ) -> list[Segment]:
        """Mark [start, end) removed in the given perspective.

        Only perspective-visible segments are touched: content inserted
        concurrently inside the range survives (the remover never saw it).
        Overlapping removes keep the earliest assigned stamp; a pending
        local stamp is superseded by any assigned one but retains
        ``rem_local_seq`` so the eventual ack can settle the pending op
        (ref: overlapping-remove bookkeeping, mergeTree.ts:2640).
        """
        if end <= start:
            return []
        affected: list[Segment] = []
        pos = 0
        i = 0
        while i < len(self.segments) and pos < end:
            seg = self.segments[i]
            vl = seg.visible_length(perspective)
            if vl > 0:
                seg_start, seg_end = pos, pos + vl
                if seg_end > start:  # overlaps [start, end)?
                    if seg_start < start:
                        tail = seg.split(start - seg_start)
                        self.segments.insert(i + 1, tail)
                        pos = start
                        i += 1
                        continue
                    if seg_end > end:
                        tail = seg.split(end - seg_start)
                        self.segments.insert(i + 1, tail)
                        vl = end - seg_start
                    # fully covered: stamp. Every remover is recorded in
                    # rem_clients; the primary (rem_seq, rem_client) is the
                    # EARLIEST assigned remove, since ops apply in seq order
                    # an assigned stamp only ever replaces a pending one.
                    seg.rem_clients.add(rem_client)
                    if seg.rem_seq is None:
                        seg.rem_seq = rem_seq
                        seg.rem_client = rem_client
                        seg.rem_local_seq = rem_local_seq
                    elif seg.rem_seq == UNASSIGNED_SEQ and rem_seq != UNASSIGNED_SEQ:
                        # our pending remove raced an assigned remote remove:
                        # the assigned (earlier) stamp wins; rem_local_seq
                        # stays so our eventual ack can settle the pending op
                        seg.rem_seq = rem_seq
                        seg.rem_client = rem_client
                    affected.append(seg)
                pos = seg_end
            i += 1
        return affected

    # ------------------------------------------------------------------
    # mutation: annotate
    # ------------------------------------------------------------------
    def annotate_range(
        self,
        start: int,
        end: int,
        props: dict,
        perspective: Perspective,
        local_seq: Optional[int] = None,
    ) -> list[Segment]:
        """Set properties on [start, end).

        Last-writer-wins per key by sequence number. A pending local
        annotate shadows remote writes to the same key (its eventual seq is
        necessarily higher); ``None`` values delete keys
        (ref: annotateRange mergeTree.ts:2598, segmentPropertiesManager.ts).
        """
        if end <= start:
            return []
        affected: list[Segment] = []
        pos = 0
        i = 0
        while i < len(self.segments) and pos < end:
            seg = self.segments[i]
            vl = seg.visible_length(perspective)
            if vl > 0:
                seg_start, seg_end = pos, pos + vl
                if seg_end > start:
                    if seg_start < start:
                        tail = seg.split(start - seg_start)
                        self.segments.insert(i + 1, tail)
                        pos = start
                        i += 1
                        continue
                    if seg_end > end:
                        tail = seg.split(end - seg_start)
                        self.segments.insert(i + 1, tail)
                    self._apply_props(seg, props, local_seq)
                    affected.append(seg)
                pos = min(seg_end, end)
            i += 1
        return affected

    @staticmethod
    def _apply_props(seg: Segment, props: dict, local_seq: Optional[int]) -> None:
        for key, value in props.items():
            if local_seq is not None:  # local pending annotate
                seg.pending_props[key] = local_seq
            elif key in seg.pending_props:
                continue  # our pending write wins over this remote one
            if value is None:
                seg.props.pop(key, None)
            else:
                seg.props[key] = value

    # ------------------------------------------------------------------
    # collab window / zamboni
    # ------------------------------------------------------------------
    def update_min_seq(self, min_seq: int) -> None:
        """Advance the collaboration-window floor and compact.

        Every connected client has processed everything ≤ min_seq, so no
        future perspective can have ref_seq < min_seq: segments removed at
        or below it are invisible forever (drop them), and adjacent
        old clean text runs can merge (ref: zamboni mergeTree.ts:1455).
        """
        if min_seq <= self.min_seq:
            return
        self.min_seq = min_seq
        kept: list[Segment] = []
        for seg in self.segments:
            droppable = (
                seg.rem_seq is not None
                and seg.rem_seq != UNASSIGNED_SEQ
                and seg.rem_seq <= min_seq
                and seg.rem_local_seq is None
            )
            if droppable:
                self._slide_refs_off(seg, kept)
            else:
                prev = kept[-1] if kept else None
                if (
                    prev is not None
                    and prev.ins_seq <= min_seq
                    and seg.ins_seq <= min_seq
                    and prev.can_append(seg)
                ):
                    prev.append(seg)
                else:
                    kept.append(seg)
        # refs that slid onto a later segment: nothing more to do — they
        # were re-attached inside _slide_refs_off
        self.segments = kept

    def _slide_refs_off(self, dying: Segment, kept: list[Segment]) -> None:
        """SlideOnRemove: move refs from a dropped segment to a survivor."""
        if not dying.local_refs:
            return
        # prefer the previous kept segment's end; else detach to doc start
        target = kept[-1] if kept else None
        for ref in dying.local_refs:
            if ref.ref_type & ReferenceType.STAY_ON_REMOVE:
                ref.segment = None
                ref.offset = 0
                continue
            if target is not None:
                ref.segment = target
                ref.offset = target.length
                target.local_refs.append(ref)
            else:
                ref.segment = None
                ref.offset = 0
        dying.local_refs = []

    # ------------------------------------------------------------------
    # snapshot / load
    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Serializable state at current (seq, min_seq).

        Requires no pending local state (the summarizer only runs on a
        fully-acked replica; ref: SnapshotV1 snapshotV1.ts:35). Stamps at or
        below min_seq normalize to UNIVERSAL_SEQ so loaders treat them as
        base content; younger stamps are preserved for in-window perspective
        checks by catch-up ops.

        The output is CANONICAL: adjacent text runs whose serialized
        stamps are identical coalesce at write time, so the bytes do not
        depend on the in-memory segmentation (flat eager-zamboni vs
        blocked amortized-zamboni) — the snapshot-regression fingerprints
        then pin semantics, not representation.
        """
        segs: list[dict] = []
        for seg in self.segments:
            if seg.is_pending():
                raise RuntimeError("cannot snapshot with pending local ops")
            if seg.rem_seq is not None and seg.rem_seq <= self.min_seq:
                continue  # invisible forever
            d: dict = {"props": seg.props} if seg.props else {}
            if seg.is_marker:
                d["marker"] = seg.marker
            else:
                d["text"] = seg.text
            if seg.ins_seq > self.min_seq:
                d["insSeq"] = seg.ins_seq
                d["insClient"] = seg.ins_client
            if seg.rem_seq is not None:
                d["remSeq"] = seg.rem_seq
                d["remClient"] = seg.rem_client
                if len(seg.rem_clients) > 1:
                    d["remClients"] = sorted(seg.rem_clients)
            prev = segs[-1] if segs else None
            if (prev is not None and "text" in prev and "text" in d
                    and {k: v for k, v in prev.items() if k != "text"}
                    == {k: v for k, v in d.items() if k != "text"}):
                prev["text"] += d["text"]
            else:
                segs.append(d)
        return {"minSeq": self.min_seq, "seq": self.current_seq, "segments": segs}

    @classmethod
    def load(cls, snap: dict) -> "MergeTree":
        tree = cls()
        tree.min_seq = snap["minSeq"]
        tree.current_seq = snap["seq"]
        for d in snap["segments"]:
            seg = Segment(
                text=d.get("text", ""),
                marker=d.get("marker"),
                props=dict(d.get("props", {})),
                ins_seq=d.get("insSeq", UNIVERSAL_SEQ),
                ins_client=d.get("insClient", NO_CLIENT),
            )
            if "remSeq" in d:
                seg.rem_seq = d["remSeq"]
                seg.rem_client = d["remClient"]
                seg.rem_clients = set(d.get("remClients", [d["remClient"]]))
            tree.segments.append(seg)
        return tree
