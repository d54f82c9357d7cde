"""MergeTreeClient: the op protocol around a MergeTree replica.

Ref: packages/dds/merge-tree/src/client.ts:43 — local op creation
(insertSegmentLocal :202, removeRangeLocal :189, annotateRangeLocal :164),
remote apply (applyMsg :797 → applyRemoteOp :768), own-op ack
(ackPendingSegment mergeTree.ts:1926), reconnect rebase
(regeneratePendingOp client.ts:855).

Client ids: the wire uses string client ids; each replica interns them to
small ints for stamp comparisons (and for the int32 tensor path). The
mapping is replica-local — convergence only needs distinctness, since the
tie-break orders concurrent inserts by seq alone.

JAX counterpart: ``fluidframework_tpu/mergetree/client.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..protocol.messages import (
    MessageType,
    SequencedDocumentMessage,
    UNASSIGNED_SEQ,
)
from .mergetree import MergeTree
from .ops import (
    AnnotateOp,
    GroupOp,
    InsertOp,
    MergeOp,
    MergeTreeDeltaType,
    RemoveOp,
    op_from_wire,
)
from .perspective import Perspective
from .references import LocalReference, ReferenceType
from .segments import Segment


@dataclass
class SegmentGroup:
    """The segments touched by ONE in-flight wire op.

    The ack path stamps exactly this group — never "all segments with the
    same local seq", because reconnect regeneration can fragment one local
    op into several wire ops, each sequenced separately
    (ref: SegmentGroup / segmentGroups in mergeTree.ts).
    """

    segments: list[Segment] = field(default_factory=list)

    def attach(self, seg: Segment) -> None:
        self.segments.append(seg)
        seg.pending_groups.append(self)

    def detach_all(self) -> None:
        for seg in self.segments:
            if self in seg.pending_groups:
                seg.pending_groups.remove(self)
        self.segments = []


@dataclass
class PendingOp:
    local_seq: int
    op: MergeOp
    group: SegmentGroup = field(default_factory=SegmentGroup)


class MergeTreeClient:
    def __init__(self, client_id: str, blocked: bool = True):
        self.client_id = client_id
        self._ids: dict[str, int] = {client_id: 0}
        self._my_ids: set[str] = {client_id}
        # production replicas use the blocked tree (O(1) window advance,
        # block-skipping walks — mergetree/blocked.py); the flat tree
        # stays available as the semantics oracle the fuzz suites
        # compare against (and the kernel-parity reference)
        if blocked:
            from .blocked import BlockedMergeTree

            self.tree = BlockedMergeTree()
        else:
            self.tree = MergeTree()
        self.local_seq = 0
        self.pending: deque[PendingOp] = deque()

    def update_client_id(self, new_id: str) -> None:
        """Adopt the client id of a new connection after reconnect.

        All of this replica's identities (old and new) intern to 0, so
        pending-segment stamps and the local view stay coherent; ops from a
        PREVIOUS connection that were sequenced before our leave still ack
        as our own (ref: Client.startOrUpdateCollaboration updates
        longClientId, client.ts).
        """
        self.client_id = new_id
        self._my_ids.add(new_id)
        self._ids[new_id] = 0

    def is_own_message(self, client_id: Optional[str]) -> bool:
        return client_id in self._my_ids

    # -- id interning ----------------------------------------------------
    # interned id for server/system-authored stamps (never a local client)
    SYSTEM_CLIENT = 1_000_000

    def intern(self, client_id: Optional[str]) -> int:
        if client_id is None:
            return self.SYSTEM_CLIENT
        if client_id not in self._ids:
            self._ids[client_id] = len(self._ids)
        return self._ids[client_id]

    @property
    def my_id(self) -> int:
        return 0

    def local_view(self) -> Perspective:
        return Perspective(UNASSIGNED_SEQ, self.my_id)

    # -- queries ---------------------------------------------------------
    def get_text(self) -> str:
        return self.tree.get_text(self.local_view())

    def get_length(self) -> int:
        return self.tree.visible_length(self.local_view())

    def get_properties_at(self, pos: int) -> dict:
        """Properties of the visible character at ``pos`` in the local view
        (ref: getPropertiesAtPosition, merge-tree client.ts)."""
        return self.tree.properties_at(pos, self.local_view())

    # -- local ops (optimistic apply; caller submits returned op) --------
    def insert_text_local(self, pos: int, text: str, props: Optional[dict] = None) -> InsertOp:
        self.local_seq += 1
        seg = Segment(
            text=text,
            props=dict(props) if props else None,
            ins_seq=UNASSIGNED_SEQ,
            ins_client=self.my_id,
            ins_local_seq=self.local_seq,
        )
        self.tree.insert_segment(pos, seg, self.local_view())
        op = InsertOp(pos=pos, text=text, props=dict(props) if props else None)
        entry = PendingOp(self.local_seq, op)
        entry.group.attach(seg)
        self.pending.append(entry)
        return op

    def insert_marker_local(self, pos: int, marker: dict, props: Optional[dict] = None) -> InsertOp:
        self.local_seq += 1
        seg = Segment(
            marker=dict(marker),
            props=dict(props) if props else None,
            ins_seq=UNASSIGNED_SEQ,
            ins_client=self.my_id,
            ins_local_seq=self.local_seq,
        )
        self.tree.insert_segment(pos, seg, self.local_view())
        op = InsertOp(pos=pos, marker=dict(marker), props=dict(props) if props else None)
        entry = PendingOp(self.local_seq, op)
        entry.group.attach(seg)
        self.pending.append(entry)
        return op

    def remove_range_local(self, start: int, end: int) -> RemoveOp:
        self.local_seq += 1
        affected = self.tree.mark_removed(
            start,
            end,
            self.local_view(),
            rem_seq=UNASSIGNED_SEQ,
            rem_client=self.my_id,
            rem_local_seq=self.local_seq,
        )
        op = RemoveOp(start=start, end=end)
        entry = PendingOp(self.local_seq, op)
        for seg in affected:
            entry.group.attach(seg)
        self.pending.append(entry)
        return op

    def annotate_range_local(self, start: int, end: int, props: dict) -> AnnotateOp:
        self.local_seq += 1
        affected = self.tree.annotate_range(
            start, end, props, self.local_view(), local_seq=self.local_seq
        )
        op = AnnotateOp(start=start, end=end, props=dict(props))
        entry = PendingOp(self.local_seq, op)
        for seg in affected:
            entry.group.attach(seg)
        self.pending.append(entry)
        return op

    # -- sequenced message application ----------------------------------
    def apply_msg(
        self, msg: SequencedDocumentMessage, local: Optional[bool] = None
    ) -> None:
        """Apply one sequenced merge-tree message (op contents on the wire).

        Dispatch: our own message → ack the oldest pending op (server
        sequences each client FIFO); otherwise apply remotely at the
        author's perspective. Always advances (seq, minSeq) and compacts.

        ``local`` is the authoritative own-op flag when the caller (the
        container, which tracks every id it has held) knows it; standalone
        use falls back to the replica's own id registry.
        """
        if msg.type == MessageType.OPERATION:
            contents = msg.contents
            op = op_from_wire(contents) if isinstance(contents, dict) else contents
            if self.is_own_message(msg.client_id) if local is None else local:
                self._ack(op, msg.sequence_number)
            else:
                perspective = Perspective(
                    msg.reference_sequence_number, self.intern(msg.client_id)
                )
                self._apply_remote(op, msg.sequence_number, perspective)
        self.tree.current_seq = max(self.tree.current_seq, msg.sequence_number)
        self.tree.update_min_seq(msg.minimum_sequence_number)

    def _apply_remote(self, op: MergeOp, seq: int, perspective: Perspective) -> None:
        if isinstance(op, GroupOp):
            for sub in op.ops:
                self._apply_remote(sub, seq, perspective)
            return
        if isinstance(op, InsertOp):
            seg = Segment(
                text=op.text or "",
                marker=dict(op.marker) if op.marker is not None else None,
                props=dict(op.props) if op.props else None,
                ins_seq=seq,
                ins_client=perspective.client,
            )
            self.tree.insert_segment(op.pos, seg, perspective)
        elif isinstance(op, RemoveOp):
            self.tree.mark_removed(
                op.start, op.end, perspective, rem_seq=seq, rem_client=perspective.client
            )
        elif isinstance(op, AnnotateOp):
            self.tree.annotate_range(op.start, op.end, op.props, perspective)
        else:
            raise TypeError(f"unknown op {op!r}")

    def _ack(self, op: MergeOp, seq: int) -> None:
        assert self.pending, "ack with no pending op"
        entry = self.pending.popleft()
        segments = list(entry.group.segments)
        if isinstance(entry.op, InsertOp):
            for seg in segments:
                seg.ins_seq = seq
                seg.ins_local_seq = None
        elif isinstance(entry.op, RemoveOp):
            for seg in segments:
                if seg.rem_seq == UNASSIGNED_SEQ:
                    seg.rem_seq = seq
                # else: an assigned remote remove overlapped ours and won
                seg.rem_local_seq = None
        elif isinstance(entry.op, AnnotateOp):
            for seg in segments:
                for key in entry.op.props:
                    if seg.pending_props.get(key) == entry.local_seq:
                        del seg.pending_props[key]
        else:
            raise AssertionError("group ops are flattened before submit")
        entry.group.detach_all()

    # -- reconnect rebase ------------------------------------------------
    def regenerate_pending_ops(self) -> list[MergeOp]:
        """Rebuild pending ops against CURRENT state for resubmission.

        After reconnect, old pending ops reference stale positions; the
        pending segments themselves know where they live now. Pending
        inserts may have been split — regenerate one insert per surviving
        part; removes/annotates re-derive their ranges from the stamped
        segments (ref: regeneratePendingOp client.ts:855,
        findReconnectionPostition :675).
        """
        # Renumber every pending op with a fresh, unique local_seq first
        # (continuing the counter upward, so new values never collide with
        # old ones). A previous regeneration may have fragmented one op into
        # several wire ops SHARING a local_seq — but those fragments apply
        # sequentially on remotes, so the bounded-perspective ordering below
        # ("op L sees pending removes < L") needs them strictly ordered.
        for entry in self.pending:
            old_ls = entry.local_seq
            self.local_seq += 1
            new_ls = self.local_seq
            if isinstance(entry.op, InsertOp):
                for seg in entry.group.segments:
                    seg.ins_local_seq = new_ls
            elif isinstance(entry.op, RemoveOp):
                for seg in entry.group.segments:
                    seg.rem_local_seq = new_ls
            elif isinstance(entry.op, AnnotateOp):
                for seg in entry.group.segments:
                    for key in entry.op.props:
                        if seg.pending_props.get(key) == old_ls:
                            seg.pending_props[key] = new_ls
            entry.local_seq = new_ls

        new_ops: list[MergeOp] = []
        new_pending: deque[PendingOp] = deque()
        for entry in self.pending:
            ls = entry.local_seq
            rebase_view = Perspective(self.tree.current_seq, self.my_id, local_seq=ls)
            members = set(map(id, entry.group.segments))
            entry.group.detach_all()
            if isinstance(entry.op, InsertOp):
                # tree order, via group membership
                parts = [s for s in self.tree.segments if id(s) in members]
                for part in parts:
                    if part.rem_seq is not None and part.rem_seq != UNASSIGNED_SEQ:
                        # inserted-then-removed at an assigned seq: the op is
                        # moot; settle the stamp so the segment isn't
                        # pending forever (droppable once minSeq passes)
                        part.ins_seq = part.rem_seq
                        part.ins_local_seq = None
                        continue
                    # CRITICAL (found by the reconnect farm): the author
                    # must RE-PLACE the pending segment with the exact walk
                    # remotes will use for the regenerated op — its old
                    # physical spot may sit inside a tombstone run that the
                    # remote walk stops in front of, and a third client can
                    # later insert between the two placements.
                    pos = self.tree.position_of_segment(part, rebase_view)
                    self.tree.remove_segment(part)
                    self.tree.insert_segment(pos, part, rebase_view)
                    op = InsertOp(
                        pos=pos,
                        text=None if part.is_marker else part.text,
                        marker=dict(part.marker) if part.is_marker else None,
                        props=dict(part.props) if part.props else None,
                    )
                    new_entry = PendingOp(ls, op)
                    new_entry.group.attach(part)
                    new_ops.append(op)
                    new_pending.append(new_entry)
            elif isinstance(entry.op, RemoveOp):
                for start, end, segs in self._rebase_ranges(
                    rebase_view,
                    lambda s: id(s) in members and s.rem_seq == UNASSIGNED_SEQ,
                    exclude_matched=True,
                ):
                    op = RemoveOp(start=start, end=end)
                    new_entry = PendingOp(ls, op)
                    for seg in segs:
                        new_entry.group.attach(seg)
                    new_ops.append(op)
                    new_pending.append(new_entry)
            elif isinstance(entry.op, AnnotateOp):
                keys = set(entry.op.props.keys())
                for start, end, segs in self._rebase_ranges(
                    rebase_view,
                    lambda s: id(s) in members
                    and any(s.pending_props.get(k) == ls for k in keys),
                ):
                    op = AnnotateOp(start=start, end=end, props=dict(entry.op.props))
                    new_entry = PendingOp(ls, op)
                    for seg in segs:
                        new_entry.group.attach(seg)
                    new_ops.append(op)
                    new_pending.append(new_entry)
        self.pending = new_pending
        return new_ops

    def _rebase_ranges(
        self, rebase_view: Perspective, pred, exclude_matched: bool = False
    ) -> list[tuple[int, int, list[Segment]]]:
        """(start, end, segments) ranges (in ``rebase_view``) of segments
        matching ``pred``, merging adjacent runs.

        ``exclude_matched``: for REMOVE regeneration. Each range becomes a
        separate wire op, and the remote applies them sequentially with our
        earlier removes perspective-visible — so once a segment is emitted
        in a range it must stop counting toward later ranges' positions.
        (Annotates don't change visibility, so they keep full lengths.)
        """
        ranges: list[tuple[int, int, list[Segment]]] = []
        pos = 0
        for seg in self.tree.segments:
            vl = seg.visible_length(rebase_view)
            if vl and pred(seg):
                # A range may only grow while members are contiguous in the
                # view — any interposed visible non-member (e.g. a concurrent
                # insert that landed inside the original range) must break
                # it, or the regenerated op would swallow content the
                # original op never touched. Under exclude_matched, members
                # do not advance ``pos``, so contiguity means pos == start;
                # without it, pos == current end.
                extend = bool(ranges) and (
                    pos == ranges[-1][0] if exclude_matched else pos == ranges[-1][1]
                )
                if extend:
                    start, end, segs = ranges[-1]
                    segs.append(seg)
                    ranges[-1] = (start, end + vl, segs)
                else:
                    ranges.append((pos, pos + vl, [seg]))
                if exclude_matched:
                    continue  # emitted: invisible to subsequent ranges
            pos += vl
        return ranges

    # -- local references -------------------------------------------------
    def create_reference(
        self, pos: int, ref_type: ReferenceType = ReferenceType.SLIDE_ON_REMOVE
    ) -> LocalReference:
        return self.create_reference_at(pos, self.local_view(), ref_type)

    def create_reference_at(
        self,
        pos: int,
        perspective: Perspective,
        ref_type: ReferenceType = ReferenceType.SLIDE_ON_REMOVE,
    ) -> LocalReference:
        """Create a reference interpreting ``pos`` in an arbitrary view —
        remote interval ops anchor at the AUTHOR's (refSeq, client)
        perspective (ref: intervalCollection op apply, sequence pkg).
        Boundary positions attach to the first perspective-visible
        segment at or after the resolution point."""
        seg, offset = self.tree.visible_segment_at(pos, perspective)
        if seg is None:
            ref = LocalReference(None, 0, ref_type)
        else:
            ref = LocalReference(seg, offset, ref_type)
            seg.local_refs.append(ref)
        return ref

    def reference_position(self, ref: LocalReference) -> int:
        return self.tree.local_reference_position(ref, self.local_view())

    # -- snapshot ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Portable snapshot: interned int client ids are replica-local, so
        stamps inside the collab window are translated back to wire string
        ids before serialization (ref: SnapshotV1 stores original client ids,
        snapshotV1.ts:87)."""
        snap = self.tree.snapshot()
        reverse = {v: k for k, v in self._ids.items()}
        for d in snap["segments"]:
            if "insClient" in d:
                d["insClient"] = reverse.get(d["insClient"])
            if "remClient" in d:
                d["remClient"] = reverse.get(d["remClient"])
            if "remClients" in d:
                d["remClients"] = [reverse.get(c) for c in d["remClients"]]
        return snap

    @classmethod
    def load(cls, client_id: str, snap: dict,
             blocked: bool = True) -> "MergeTreeClient":
        c = cls(client_id, blocked=blocked)
        c.tree = type(c.tree).load(
            {
                **snap,
                "segments": [
                    {
                        **d,
                        **(
                            {"insClient": c.intern(d["insClient"])}
                            if "insClient" in d
                            else {}
                        ),
                        **(
                            {"remClient": c.intern(d["remClient"])}
                            if "remClient" in d
                            else {}
                        ),
                        **(
                            {"remClients": [c.intern(x) for x in d["remClients"]]}
                            if "remClients" in d
                            else {}
                        ),
                    }
                    for d in snap["segments"]
                ],
            }
        )
        return c
