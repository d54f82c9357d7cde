"""BlockedMergeTree: the production host merge-tree — O(√n)-ish ops.

Ref: packages/dds/merge-tree/src/mergeTree.ts:333 — the reference keeps
segments in an 8-ary B-tree whose internal nodes cache partial lengths
per in-window sequence number (partialLengths.ts:62), so position
resolution skips whole subtrees. This is the same idea in a two-level
shape tuned for Python: segments live in BLOCKS of ~B, and each block
caches

- ``settled_len`` — total length of its UNIVERSALLY-VISIBLE segments
  (``ins_seq <= min_seq`` and never removed): every legal perspective
  has ``ref_seq >= min_seq``, so these contribute their full length to
  any view without inspection;
- ``volatile`` — the segments whose visibility is perspective-dependent
  (in-window stamps, pending local state): evaluated live per query.

A block's visible length under perspective P is then
``settled_len + Σ volatile.visible_length(P)`` — O(window ops in the
block), not O(B). Walks (resolve / remove / annotate) skip whole
non-overlapping blocks; only the overlapping blocks pay a per-segment
scan. The flat :class:`~.mergetree.MergeTree` remains the scalar oracle
(kernel fuzz parity) and the semantics contract: tests fuzz this class
against it op-for-op.

Compaction (zamboni, mergeTree.ts:1455) is AMORTIZED instead of eager:
``update_min_seq`` is O(1) plus a two-block round-robin rebuild, so a
1M-char document does not pay a full-tree scan on every sequenced op —
the flat oracle's dominant cost. Rebuilding a block drops dead
segments (sliding local references, references.py), merges adjacent
settled text runs, and re-settles in-window segments the advanced
``min_seq`` now covers.

JAX counterpart: ``fluidframework_tpu/mergetree/blocked.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from typing import Optional

from ..protocol.messages import UNASSIGNED_SEQ
from .mergetree import MergeTree
from .perspective import Perspective
from .segments import Segment

TARGET_BLOCK = 96          # split threshold is 2×
REBUILD_PER_ADVANCE = 2    # blocks compacted per min_seq advance


class _Block:
    __slots__ = ("segs", "settled_len", "volatile", "dirty")

    def __init__(self, segs: Optional[list] = None):
        self.segs: list[Segment] = segs if segs is not None else []
        self.settled_len = 0
        self.volatile: list[Segment] = []
        self.dirty = True

    def visible_length(self, tree: "BlockedMergeTree",
                       perspective: Perspective) -> int:
        if self.dirty:
            tree._rebuild(self)
        n = self.settled_len
        for s in self.volatile:
            n += s.visible_length(perspective)
        return n


def _settled(seg: Segment, min_seq: int) -> bool:
    """Universally visible: counts toward EVERY legal perspective."""
    return (seg.ins_seq <= min_seq and seg.rem_seq is None
            and not seg.is_pending())


def _droppable(seg: Segment, min_seq: int) -> bool:
    return (seg.rem_seq is not None and seg.rem_seq != UNASSIGNED_SEQ
            and seg.rem_seq <= min_seq and seg.rem_local_seq is None)


class BlockedMergeTree(MergeTree):
    """Drop-in for MergeTree with blocked storage.

    ``segments`` is a FLATTENED COPY for iteration (the cold paths —
    snapshot, reconnect rebase, item scans — keep their flat-list
    shape); all hot mutations and walks are overridden block-aware.
    """

    def __init__(self):
        self._blocks: list[_Block] = [_Block()]
        self._rr = 0  # round-robin compaction cursor
        super().__init__()  # its ``segments = []`` routes to the setter

    # -- storage view ----------------------------------------------------

    @property
    def segments(self) -> list:
        out = []
        for b in self._blocks:
            out.extend(b.segs)
        return out

    @segments.setter
    def segments(self, value) -> None:
        # base-class __init__ assigns []; rebuild blocks on any reset
        self._blocks = [_Block(list(value))]
        self._rr = 0

    # -- summaries -------------------------------------------------------

    def _rebuild(self, block: _Block) -> None:
        """Recompute the block summary; drop dead segments and merge
        adjacent settled runs (the per-block zamboni)."""
        min_seq = self.min_seq
        kept: list[Segment] = []
        for seg in block.segs:
            if _droppable(seg, min_seq):
                self._slide_refs_blocked(seg, kept, block)
            else:
                prev = kept[-1] if kept else None
                if (prev is not None and prev.ins_seq <= min_seq
                        and seg.ins_seq <= min_seq
                        and prev.can_append(seg)):
                    prev.append(seg)
                else:
                    kept.append(seg)
        block.segs = kept
        settled = 0
        volatile = []
        for seg in kept:
            if _settled(seg, min_seq):
                settled += seg.length
            else:
                volatile.append(seg)
        block.settled_len = settled
        block.volatile = volatile
        block.dirty = False

    def _slide_refs_blocked(self, dying: Segment, kept: list,
                            block: _Block) -> None:
        """SlideOnRemove across block boundaries: prefer the previous
        kept segment in this block, else the last segment of the nearest
        non-empty earlier block."""
        if not dying.local_refs:
            return
        target = kept[-1] if kept else None
        if target is None:
            bi = self._blocks.index(block)
            for j in range(bi - 1, -1, -1):
                if self._blocks[j].segs:
                    target = self._blocks[j].segs[-1]
                    break
        from .references import ReferenceType

        for ref in dying.local_refs:
            if ref.ref_type & ReferenceType.STAY_ON_REMOVE or target is None:
                ref.segment = None
                ref.offset = 0
            else:
                ref.segment = target
                ref.offset = target.length
                target.local_refs.append(ref)
        dying.local_refs = []

    def _split_block(self, bi: int) -> None:
        b = self._blocks[bi]
        if len(b.segs) <= 2 * TARGET_BLOCK:
            return
        half = len(b.segs) // 2
        tail = _Block(b.segs[half:])
        b.segs = b.segs[:half]
        b.dirty = True
        self._blocks.insert(bi + 1, tail)

    # -- queries ---------------------------------------------------------

    def visible_length(self, perspective: Perspective) -> int:
        return sum(b.visible_length(self, perspective)
                   for b in self._blocks)

    def get_text(self, perspective: Perspective) -> str:
        out = []
        for b in self._blocks:
            for s in b.segs:
                if s.visible_in(perspective) and not s.is_marker:
                    out.append(s.text)
        return "".join(out)

    def resolve(self, pos: int, perspective: Perspective) -> tuple[int, int]:
        if pos < 0:
            raise IndexError(f"negative position {pos}")
        remaining = pos
        base = 0  # global segment index of the current block's start
        for b in self._blocks:
            bl = b.visible_length(self, perspective)
            # skip only on STRICT excess: at remaining == bl the earliest
            # boundary may sit before a trailing invisible run INSIDE
            # this block, which the in-block scan finds (oracle parity)
            if remaining > bl:
                remaining -= bl
                base += len(b.segs)
                continue
            for i, seg in enumerate(b.segs):
                if remaining == 0:
                    return (base + i, 0)
                vl = seg.visible_length(perspective)
                if remaining < vl:
                    return (base + i, remaining)
                remaining -= vl
            base += len(b.segs)
        if remaining == 0:
            return (base, 0)
        raise IndexError(
            f"position {pos} out of range "
            f"(len {self.visible_length(perspective)})")

    def position_of_segment(self, target: Segment,
                            perspective: Perspective) -> int:
        pos = 0
        for b in self._blocks:
            # blocks not containing the target contribute their summary
            # length in O(volatile); only the target's block pays a scan
            contained = False
            for s in b.segs:
                if s is target:
                    contained = True
                    break
            if not contained:
                pos += b.visible_length(self, perspective)
                continue
            for seg in b.segs:
                if seg is target:
                    return pos
                pos += seg.visible_length(perspective)
        raise ValueError("segment not in tree")

    def visible_segment_at(
        self, pos: int, perspective: Perspective
    ) -> tuple[Optional[Segment], int]:
        """Block-aware override (the inherited one materializes the full
        flattened list per call)."""
        remaining = pos
        if remaining < 0:
            raise IndexError(f"negative position {pos}")
        walking = False
        for b in self._blocks:
            if not walking:
                bl = b.visible_length(self, perspective)
                if remaining > bl:
                    remaining -= bl
                    continue
            for seg in b.segs:
                vl = seg.visible_length(perspective)
                if walking or remaining == 0:
                    if vl > 0:
                        return seg, 0
                    continue  # boundary: walk past invisible segments
                if remaining < vl:
                    return seg, remaining
                remaining -= vl
            walking = walking or remaining == 0
        if remaining == 0:
            return None, 0
        raise IndexError(
            f"position {pos} out of range "
            f"(len {self.visible_length(perspective)})")

    # -- mutation --------------------------------------------------------

    def insert_segment(self, pos: int, segment: Segment,
                       perspective: Perspective) -> Segment:
        bi, si, offset = self._locate(pos, perspective)
        b = self._blocks[bi]
        if offset > 0:
            tail = b.segs[si].split(offset)
            b.segs.insert(si + 1, tail)
            si += 1
        else:
            # tie-break walk (oracle parity: mergetree.py insert_segment)
            new_key = (segment.ins_seq, segment.ins_local_seq or 0)
            bound = perspective.local_seq
            while True:
                if si >= len(b.segs):
                    if bi + 1 >= len(self._blocks):
                        break
                    bi += 1
                    b = self._blocks[bi]
                    si = 0
                    continue
                s = b.segs[si]
                ins_seen = (
                    s.ins_client == perspective.client
                    and not (
                        bound is not None
                        and s.ins_local_seq is not None
                        and s.ins_local_seq > bound
                    )
                ) or s.ins_seq <= perspective.ref_seq
                if ins_seen:
                    break
                if (s.ins_seq, s.ins_local_seq or 0) <= new_key:
                    break
                si += 1
        b.segs.insert(si, segment)
        b.dirty = True
        self._split_block(bi)
        return segment

    def _locate(self, pos: int, perspective: Perspective
                ) -> tuple[int, int, int]:
        """(block index, in-block segment index, offset) for ``pos`` —
        the blocked analog of resolve's earliest-boundary contract."""
        remaining = pos
        if remaining < 0:
            raise IndexError(f"negative position {pos}")
        for bi, b in enumerate(self._blocks):
            bl = b.visible_length(self, perspective)
            if remaining > bl:
                remaining -= bl
                continue
            for si, seg in enumerate(b.segs):
                if remaining == 0:
                    return (bi, si, 0)
                vl = seg.visible_length(perspective)
                if remaining < vl:
                    return (bi, si, remaining)
                remaining -= vl
        if remaining == 0:
            return (len(self._blocks) - 1,
                    len(self._blocks[-1].segs), 0)
        raise IndexError(
            f"position {pos} out of range "
            f"(len {self.visible_length(perspective)})")

    def mark_removed(
        self,
        start: int,
        end: int,
        perspective: Perspective,
        rem_seq: int,
        rem_client: int,
        rem_local_seq: Optional[int] = None,
    ) -> list[Segment]:
        if end <= start:
            return []
        affected: list[Segment] = []
        pos = 0
        touched_blocks: list[int] = []
        bi = 0
        while bi < len(self._blocks) and pos < end:
            b = self._blocks[bi]
            bl = b.visible_length(self, perspective)
            if pos + bl <= start:  # no overlap with [start, end)
                pos += bl
                bi += 1
                continue
            i = 0
            touched = False
            while i < len(b.segs) and pos < end:
                seg = b.segs[i]
                vl = seg.visible_length(perspective)
                if vl > 0:
                    seg_start, seg_end = pos, pos + vl
                    if seg_end > start:
                        if seg_start < start:
                            tail = seg.split(start - seg_start)
                            b.segs.insert(i + 1, tail)
                            pos = start
                            i += 1
                            touched = True
                            continue
                        if seg_end > end:
                            tail = seg.split(end - seg_start)
                            b.segs.insert(i + 1, tail)
                            vl = end - seg_start
                        seg.rem_clients.add(rem_client)
                        if seg.rem_seq is None:
                            seg.rem_seq = rem_seq
                            seg.rem_client = rem_client
                            seg.rem_local_seq = rem_local_seq
                        elif seg.rem_seq == UNASSIGNED_SEQ \
                                and rem_seq != UNASSIGNED_SEQ:
                            seg.rem_seq = rem_seq
                            seg.rem_client = rem_client
                        affected.append(seg)
                        touched = True
                    pos = seg_end
                i += 1
            if touched:
                b.dirty = True
                touched_blocks.append(bi)
            bi += 1
        # split AFTER the walk (back to front): splitting mid-iteration
        # would shift block indices and re-visit the inserted tail with
        # an already-advanced pos, corrupting the range accounting
        for bj in reversed(touched_blocks):
            self._split_block(bj)
        return affected

    def annotate_range(
        self,
        start: int,
        end: int,
        props: dict,
        perspective: Perspective,
        local_seq: Optional[int] = None,
    ) -> list[Segment]:
        if end <= start:
            return []
        affected: list[Segment] = []
        pos = 0
        touched_blocks: list[int] = []
        bi = 0
        while bi < len(self._blocks) and pos < end:
            b = self._blocks[bi]
            bl = b.visible_length(self, perspective)
            if pos + bl <= start:
                pos += bl
                bi += 1
                continue
            i = 0
            touched = False
            while i < len(b.segs) and pos < end:
                seg = b.segs[i]
                vl = seg.visible_length(perspective)
                if vl > 0:
                    seg_start, seg_end = pos, pos + vl
                    if seg_end > start:
                        if seg_start < start:
                            tail = seg.split(start - seg_start)
                            b.segs.insert(i + 1, tail)
                            pos = start
                            i += 1
                            touched = True
                            continue
                        if seg_end > end:
                            tail = seg.split(end - seg_start)
                            b.segs.insert(i + 1, tail)
                        self._apply_props(seg, props, local_seq)
                        affected.append(seg)
                        touched = True
                    pos = min(seg_end, end)
                i += 1
            if touched:
                b.dirty = True
                touched_blocks.append(bi)
            bi += 1
        # see mark_removed: splits are deferred past the walk
        for bj in reversed(touched_blocks):
            self._split_block(bj)
        return affected

    def remove_segment(self, seg: Segment) -> None:
        for b in self._blocks:
            for i, s in enumerate(b.segs):
                if s is seg:
                    del b.segs[i]
                    b.dirty = True
                    return
        raise ValueError("segment not in tree")

    # -- collab window ----------------------------------------------------

    def update_min_seq(self, min_seq: int) -> None:
        """O(1) + amortized compaction: advancing the floor never walks
        the whole tree (the flat oracle's per-op dominant cost); instead
        a round-robin cursor rebuilds a couple of blocks per advance, so
        every block is compacted once per (blocks/2) advances."""
        if min_seq <= self.min_seq:
            return
        self.min_seq = min_seq
        for _ in range(min(REBUILD_PER_ADVANCE, len(self._blocks))):
            self._rr = (self._rr + 1) % len(self._blocks)
            b = self._blocks[self._rr]
            if b.dirty or b.volatile:
                self._rebuild(b)
            if not b.segs and len(self._blocks) > 1:
                self._blocks.remove(b)
                self._rr %= len(self._blocks)

    # -- snapshot ---------------------------------------------------------
    # snapshot() is inherited: it iterates the flattened ``segments``
    # property and is segmentation-tolerant on load. load() must build
    # a blocked instance:

    @classmethod
    def load(cls, snap: dict) -> "BlockedMergeTree":
        flat = MergeTree.load(snap)  # plain flat build of the snapshot
        tree = cls()
        tree.min_seq = flat.min_seq
        tree.current_seq = flat.current_seq
        segs = flat.segments
        tree._blocks = [
            _Block(segs[i:i + TARGET_BLOCK])
            for i in range(0, len(segs), TARGET_BLOCK)
        ] or [_Block()]
        return tree
