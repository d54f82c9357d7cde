"""SharedString: collaborative text over the merge-tree CRDT.

JAX counterpart: ``fluidframework_tpu/dds/string.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/sequence/src/sharedString.ts (insertText :152) +
sequence.ts SharedSegmentSequence, which bridges the merge-tree Client to
the channel contract. The heavy lifting — optimistic apply, remote
perspective resolution, ack, reconnect rebase — is MergeTreeClient
(mergetree/client.py, the scalar oracle; the batched card path applies the
same sequenced stream server-side via ops/apply.py).
"""

from __future__ import annotations

from typing import Optional

from ..config import DEFAULT as _CFG
from ..mergetree.client import MergeTreeClient
from ..mergetree.ops import op_to_wire
from ..mergetree.references import LocalReference, ReferenceType
from ..protocol.messages import MessageType, SequencedDocumentMessage
from .intervals import IntervalCollection
from .registry import register_channel_type
from .shared_object import SharedObject

DETACHED_ID = "detached"
_SUMMARY_CHUNK_SEGMENTS = _CFG.summary_chunk_segments


@register_channel_type
class SharedString(SharedObject):
    channel_type = "shared-string"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self.client = MergeTreeClient(DETACHED_ID)
        self._interval_collections: dict[str, IntervalCollection] = {}
        self._pending_interval_ops: list[dict] = []

    # ------------------------------------------------------------- editing

    def insert_text(self, pos: int, text: str, props: Optional[dict] = None) -> None:
        op = self.client.insert_text_local(pos, text, props)
        self.submit_local_message(op_to_wire(op))
        self._emit("sequenceDelta", {"op": "insert", "pos": pos, "text": text,
                                     "local": True})

    def insert_marker(self, pos: int, marker: dict, props: Optional[dict] = None) -> None:
        op = self.client.insert_marker_local(pos, marker, props)
        self.submit_local_message(op_to_wire(op))

    def remove_text(self, start: int, end: int) -> None:
        removed = self.get_text()[start:end]
        op = self.client.remove_range_local(start, end)
        self.submit_local_message(op_to_wire(op))
        self._emit("sequenceDelta", {"op": "remove", "start": start, "end": end,
                                     "removedText": removed, "local": True})

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        op = self.client.annotate_range_local(start, end, props)
        self.submit_local_message(op_to_wire(op))

    # ------------------------------------------------------------- queries

    def get_text(self) -> str:
        return self.client.get_text()

    def __len__(self) -> int:
        return self.client.get_length()

    def create_reference(
        self, pos: int, ref_type: int = ReferenceType.SLIDE_ON_REMOVE
    ) -> LocalReference:
        return self.client.create_reference(pos, ref_type)

    def reference_position(self, ref: LocalReference) -> int:
        return self.client.reference_position(ref)

    # ----------------------------------------------------------- intervals

    def get_interval_collection(self, label: str) -> IntervalCollection:
        """Named collection of sliding ranges over this string (ref:
        SharedSegmentSequence.getIntervalCollection, sequence.ts)."""
        if label not in self._interval_collections:
            self._interval_collections[label] = IntervalCollection(label, self)
        return self._interval_collections[label]

    def _submit_interval_op(self, wire: dict) -> None:
        self._pending_interval_ops.append(wire)
        self.submit_local_message(wire)

    # ------------------------------------------------------------ contract

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        contents = msg.contents
        if isinstance(contents, dict) and contents.get("type") == "interval":
            coll = self.get_interval_collection(contents["label"])
            if local:
                self._pending_interval_ops.pop(0)
            coll.process(contents, msg, local)
            # interval msgs still advance the collab window for zamboni
            self.client.tree.current_seq = max(
                self.client.tree.current_seq, msg.sequence_number)
            self.client.tree.update_min_seq(msg.minimum_sequence_number)
            return
        self.client.apply_msg(msg, local)
        if not local and msg.type == MessageType.OPERATION:
            self._emit("sequenceDelta", {"wire": msg.contents, "local": False})

    def resubmit_pending(self) -> None:
        for op in self.client.regenerate_pending_ops():
            self.submit_local_message(op_to_wire(op))
        pending, self._pending_interval_ops = self._pending_interval_ops, []
        for wire in pending:
            # endpoints already slid with local edits: refresh positions
            wire = dict(wire)
            if wire["op"] in ("add", "change"):
                coll = self.get_interval_collection(wire["label"])
                interval = coll.get(wire["id"])
                if interval is None and wire["op"] == "change":
                    continue  # deleted meanwhile: drop the change
                if interval is not None:
                    s, e = coll.position(interval)
                    if wire.get("start") is not None:
                        wire["start"] = s
                    if wire.get("end") is not None:
                        wire["end"] = e
            self._submit_interval_op(wire)

    def on_connect(self, client_id: str) -> None:
        if client_id != self.client.client_id:
            self.client.update_client_id(client_id)

    def snapshot(self) -> dict:
        return {
            "mergetree": self.client.snapshot(),
            "intervals": {
                label: coll.snapshot()
                for label, coll in self._interval_collections.items()
            },
        }

    # segments per summary chunk blob (ref: SnapshotV1 chunked emit,
    # snapshotV1.ts:87 — bounded blob sizes keep incremental uploads and
    # partial loads cheap for giant documents); default from the unified
    # config registry, overridable per instance
    SUMMARY_CHUNK_SEGMENTS = _SUMMARY_CHUNK_SEGMENTS

    def summarize_core(self):
        import json

        from ..protocol.summary import SummaryBlob, SummaryTree

        snap = self.snapshot()
        segments = snap["mergetree"]["segments"]
        n = self.SUMMARY_CHUNK_SEGMENTS
        if len(segments) <= n:
            return SummaryBlob(
                json.dumps(snap, separators=(",", ":")).encode())
        header = {
            "mergetree_header": {
                k: v for k, v in snap["mergetree"].items() if k != "segments"
            },
            "intervals": snap["intervals"],
            "chunks": (len(segments) + n - 1) // n,
        }
        tree = {"header": SummaryBlob(
            json.dumps(header, separators=(",", ":")).encode())}
        for i in range(header["chunks"]):
            tree[f"chunk_{i}"] = SummaryBlob(json.dumps(
                segments[i * n:(i + 1) * n], separators=(",", ":")).encode())
        return SummaryTree(tree=tree)

    def load_core(self, snap: dict) -> None:
        if "header" in snap and "mergetree" not in snap:
            # chunked summary form (materialized tree): reassemble
            header = snap["header"]
            segments = []
            for i in range(header["chunks"]):
                segments.extend(snap[f"chunk_{i}"])
            snap = {
                "mergetree": dict(header["mergetree_header"],
                                  segments=segments),
                "intervals": header["intervals"],
            }
        if "mergetree" not in snap:  # pre-intervals snapshot layout
            self.client = MergeTreeClient.load(DETACHED_ID, snap)
            return
        self.client = MergeTreeClient.load(DETACHED_ID, snap["mergetree"])
        for label, coll_snap in snap.get("intervals", {}).items():
            self.get_interval_collection(label).load(coll_snap)
