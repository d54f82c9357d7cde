"""Value sequences: ordered lists of items over the merge-tree CRDT.

JAX counterpart: ``fluidframework_tpu/dds/sequence.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/sequence — SharedNumberSequence / SharedObjectSequence
(sequence.ts SharedSegmentSequence over SubSequence segments). Here each
item rides a merge-tree MARKER segment (length 1, dict payload), so
insert/remove get the full concurrent-position semantics of the text
path for free; items must be JSON-serializable.
"""

from __future__ import annotations

from typing import Any, Sequence

from ..mergetree.ops import op_to_wire
from ..protocol.messages import MessageType, SequencedDocumentMessage
from .registry import register_channel_type
from .string import SharedString

ITEM_KEY = "seqItem"


class SharedSequence(SharedString):
    """Sequence of opaque items; reuses the SharedString channel machinery
    (merge-tree client, interval collections, reconnect regeneration)."""

    def insert_range(self, pos: int, items: Sequence[Any]) -> None:
        # one marker per item: concurrent inserts interleave at item
        # granularity exactly like characters
        for i, item in enumerate(items):
            op = self.client.insert_marker_local(pos + i, {ITEM_KEY: item})
            self.submit_local_message(op_to_wire(op))
        self._emit("sequenceDelta", {"op": "insert", "pos": pos,
                                     "count": len(items), "local": True})

    def remove_range(self, start: int, end: int) -> None:
        op = self.client.remove_range_local(start, end)
        self.submit_local_message(op_to_wire(op))
        self._emit("sequenceDelta", {"op": "remove", "start": start,
                                     "end": end, "local": True})

    def get_items(self, start: int = 0, end: int | None = None) -> list[Any]:
        view = self.client.local_view()
        items = [
            seg.marker[ITEM_KEY]
            for seg in self.client.tree.segments
            if seg.is_marker and seg.visible_in(view) and ITEM_KEY in seg.marker
        ]
        return items[start:end]

    def get_item(self, pos: int) -> Any:
        seg, _ = self.client.tree.visible_segment_at(
            pos, self.client.local_view())
        if seg is None:
            raise IndexError(pos)
        return seg.marker[ITEM_KEY]

    def item_count(self) -> int:
        return self.client.get_length()


@register_channel_type
class SharedNumberSequence(SharedSequence):
    channel_type = "shared-number-sequence"


@register_channel_type
class SharedObjectSequence(SharedSequence):
    channel_type = "shared-object-sequence"
