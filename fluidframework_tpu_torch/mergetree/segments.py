"""Segments: the atoms of the merge tree.

A segment is a run of content (text, or a single marker) carrying integer
insert/remove stamps. Ref: packages/dds/merge-tree/src/mergeTree.ts:486
(BaseSegment), textSegment.ts (TextSegment), mergeTree.ts:668 (Marker).

Stamp encoding (shared with the int32 tensor layout in
fluidframework_tpu.ops):

- ``ins_seq``: assigned sequence number, or ``UNASSIGNED_SEQ`` while the
  local insert is unacked.
- ``rem_seq``: ``None`` if never removed; ``UNASSIGNED_SEQ`` while a local
  remove is unacked; otherwise the remover's assigned seq.
- ``*_local_seq``: the client-local op number while pending, for ack
  matching and reconnect rebase (ref: localSeq tracking in
  mergeTree.ts / SegmentGroup).

JAX counterpart: ``fluidframework_tpu/mergetree/segments.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from typing import Optional

from ..protocol.messages import UNASSIGNED_SEQ, UNIVERSAL_SEQ
from .references import LocalReference

# client-id sentinel for "no client" (snapshot-loaded / never-removed slots)
NO_CLIENT = -1


class Segment:
    __slots__ = (
        "text",
        "marker",
        "props",
        "ins_seq",
        "ins_client",
        "ins_local_seq",
        "rem_seq",
        "rem_client",
        "rem_clients",
        "rem_local_seq",
        "pending_props",
        "pending_groups",
        "local_refs",
    )

    def __init__(
        self,
        text: str = "",
        marker: Optional[dict] = None,
        props: Optional[dict] = None,
        ins_seq: int = UNIVERSAL_SEQ,
        ins_client: int = NO_CLIENT,
        ins_local_seq: Optional[int] = None,
    ):
        self.text = text
        self.marker = marker  # non-None ⇒ this is a marker segment
        self.props: dict = props or {}
        self.ins_seq = ins_seq
        self.ins_client = ins_client
        self.ins_local_seq = ins_local_seq
        self.rem_seq: Optional[int] = None  # earliest ASSIGNED remove seq (or UNASSIGNED while only pending)
        self.rem_client: int = NO_CLIENT  # author of rem_seq
        # ALL clients that removed this segment — overlapping concurrent
        # removes must each count for their author's later perspectives
        # (ref: overlapping-remove bookkeeping, mergeTree.ts:2640)
        self.rem_clients: set[int] = set()
        self.rem_local_seq: Optional[int] = None
        # key → local_seq of the pending local annotate that set it
        self.pending_props: dict = {}
        # SegmentGroups (one per in-flight wire op) this segment belongs to;
        # the ack path stamps exactly one group's segments with the op's
        # assigned seq (ref: SegmentGroupCollection, mergeTree.ts SegmentGroup)
        self.pending_groups: list = []
        self.local_refs: list[LocalReference] = []

    # -- basic geometry --------------------------------------------------
    @property
    def is_marker(self) -> bool:
        return self.marker is not None

    @property
    def length(self) -> int:
        return 1 if self.is_marker else len(self.text)

    def is_pending(self) -> bool:
        return (
            self.ins_local_seq is not None
            or self.rem_local_seq is not None
            or bool(self.pending_props)
        )

    # -- visibility ------------------------------------------------------
    def visible_in(self, perspective) -> bool:
        bound = perspective.local_seq
        # insert side: own inserts always visible (unless past the rebase
        # bound); others' only once sequenced at/below refSeq
        if self.ins_client == perspective.client:
            if (
                bound is not None
                and self.ins_local_seq is not None
                and self.ins_local_seq > bound
            ):
                return False
        elif not self.ins_seq <= perspective.ref_seq:
            return False
        # remove side
        if self.rem_seq is None:
            return True
        if perspective.client in self.rem_clients:
            if (
                bound is not None
                and self.rem_local_seq is not None
                and not self.rem_local_seq < bound
            ):
                # our pending remove lands at/after the bounded op — for
                # this view the segment is not yet gone by OUR hand; an
                # overlapping assigned remove may still hide it (below)
                pass
            else:
                return False
        if self.rem_seq != UNASSIGNED_SEQ and self.rem_seq <= perspective.ref_seq:
            return False
        return True

    def visible_length(self, perspective) -> int:
        return self.length if self.visible_in(perspective) else 0

    # -- split / merge ---------------------------------------------------
    def split(self, offset: int) -> "Segment":
        """Split at text offset (0 < offset < length); returns the tail.

        Both halves keep identical stamps so ack matching and perspective
        checks are unaffected (ref: BaseSegment.splitAt mergeTree.ts:523).
        Markers (length 1) are never split.
        """
        assert not self.is_marker and 0 < offset < len(self.text)
        tail = Segment(
            text=self.text[offset:],
            props=dict(self.props),
            ins_seq=self.ins_seq,
            ins_client=self.ins_client,
            ins_local_seq=self.ins_local_seq,
        )
        tail.rem_seq = self.rem_seq
        tail.rem_client = self.rem_client
        tail.rem_clients = set(self.rem_clients)
        tail.rem_local_seq = self.rem_local_seq
        tail.pending_props = dict(self.pending_props)
        # the tail stays part of every in-flight op the head belongs to
        tail.pending_groups = list(self.pending_groups)
        for g in self.pending_groups:
            g.segments.append(tail)
        self.text = self.text[:offset]
        # references at or past the split move to the tail
        keep, move = [], []
        for ref in self.local_refs:
            (move if ref.offset >= offset else keep).append(ref)
        for ref in move:
            ref.segment = tail
            ref.offset -= offset
        self.local_refs = keep
        tail.local_refs = move
        return tail

    def can_append(self, other: "Segment") -> bool:
        """May ``other`` (the immediate successor) be merged into self?

        Only fully-acked, never-removed, same-props text runs merge —
        zamboni's compaction criterion (ref: mergeTree.ts:1455).
        """
        return (
            not self.is_marker
            and not other.is_marker
            and self.rem_seq is None
            and other.rem_seq is None
            and not self.is_pending()
            and not other.is_pending()
            and self.props == other.props
        )

    def append(self, other: "Segment") -> None:
        base = len(self.text)
        self.text += other.text
        for ref in other.local_refs:
            ref.segment = self
            ref.offset += base
        self.local_refs.extend(other.local_refs)
        other.local_refs = []

    def __repr__(self) -> str:  # debugging aid for farm divergence dumps
        stamp = f"i{self.ins_seq}@{self.ins_client}"
        if self.ins_local_seq is not None:
            stamp += f"(L{self.ins_local_seq})"
        if self.rem_seq is not None:
            stamp += f" r{self.rem_seq}@{self.rem_client}"
        body = f"M{self.marker}" if self.is_marker else repr(self.text)
        return f"<Seg {body} {stamp}>"
