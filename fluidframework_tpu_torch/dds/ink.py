"""Ink: append-only freehand stroke streams.

JAX counterpart: ``fluidframework_tpu/dds/ink.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/ink/src/ink.ts — createStroke starts a stroke with pen
settings; appendPointToStroke adds points.

Convergence design: ACKED state (stroke order, per-stroke point lists) is
built strictly in sequenced order, identically on every replica; local
pending strokes/points are kept in a separate optimistic overlay that
readers see appended at the end and that drains into acked state as acks
arrive. Snapshots persist the acked state only, so a client booting from
a summary and then replaying the pending ops' sequenced forms cannot
double-apply or lose interleaved remote points.

Wire: {"op": "createStroke", "id", "pen"}
| {"op": "stylus", "id", "point": {"x","y","time","pressure"?}}.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

from ..protocol.messages import SequencedDocumentMessage
from .registry import register_channel_type
from .shared_object import SharedObject


@register_channel_type
class Ink(SharedObject):
    channel_type = "ink"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        # acked, sequenced-order state (identical on every replica)
        self._strokes: dict[str, dict] = {}  # id → {"id","pen","points"}
        self._order: list[str] = []
        # optimistic overlay: our in-flight ops
        self._pending_ops: list[dict] = []
        self._uid = itertools.count()

    # ---------------------------------------------------------------- api

    def create_stroke(self, pen: Optional[dict] = None) -> str:
        stroke_id = f"{self.client_id or 'detached'}:{next(self._uid)}"
        op = {"op": "createStroke", "id": stroke_id, "pen": pen or {}}
        self._pending_ops.append(op)
        self.submit_local_message(op)
        return stroke_id

    def append_point(self, stroke_id: str, x: float, y: float, **extra) -> None:
        op = {"op": "stylus", "id": stroke_id, "point": {"x": x, "y": y, **extra}}
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def get_stroke(self, stroke_id: str) -> Optional[dict]:
        """Acked stroke merged with our optimistic pending points."""
        base = self._strokes.get(stroke_id)
        pen = base["pen"] if base else None
        points = list(base["points"]) if base else []
        found = base is not None
        for op in self._pending_ops:
            if op["id"] != stroke_id:
                continue
            if op["op"] == "createStroke":
                found, pen = True, op["pen"]
            else:
                points.append(op["point"])
        if not found:
            return None
        return {"id": stroke_id, "pen": pen, "points": points}

    def get_strokes(self) -> list[dict]:
        ids = list(self._order)
        for op in self._pending_ops:
            if op["op"] == "createStroke" and op["id"] not in self._strokes:
                ids.append(op["id"])
        return [self.get_stroke(i) for i in ids]

    # ----------------------------------------------------------- contract

    def _apply_sequenced(self, op: dict) -> None:
        """Advance the acked state — same code for remote ops and our own
        acks, so every replica builds the identical sequenced history."""
        if op["op"] == "createStroke":
            if op["id"] not in self._strokes:
                self._strokes[op["id"]] = {"id": op["id"], "pen": op["pen"],
                                           "points": []}
                self._order.append(op["id"])
        else:
            stroke = self._strokes.get(op["id"])
            if stroke is not None:
                stroke["points"].append(op["point"])

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._apply_sequenced(self._pending_ops.pop(0))
            return
        self._apply_sequenced(msg.contents)
        self._emit("stylus" if msg.contents["op"] == "stylus" else "createStroke",
                   {"local": False})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        # acked state only: pending ops re-apply via their sequenced forms
        return {"strokes": {k: {"id": v["id"], "pen": v["pen"],
                                "points": list(v["points"])}
                            for k, v in self._strokes.items()},
                "order": list(self._order)}

    def load_core(self, snap: dict) -> None:
        self._strokes = {k: {"id": v["id"], "pen": v["pen"],
                             "points": list(v["points"])}
                         for k, v in snap.get("strokes", {}).items()}
        self._order = list(snap.get("order", []))


@register_channel_type
class SharedSummaryBlock(SharedObject):
    """Summary-only data: no ops, state travels exclusively via snapshots.

    Ref: packages/dds/shared-summary-block — written by the summarizer
    client between summaries; readers see it on load.
    """

    channel_type = "shared-summary-block"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._data: dict[str, Any] = {}
        self._dirty_at = 0

    def set(self, key: str, value: Any) -> None:
        self._data[key] = value
        # local-only writes never sequence, so the base class's
        # last_changed_seq cannot see them: mark changed past the current
        # STREAM head to disqualify summary handle reuse until a summary
        # whose capture seq passes this point has uploaded the write
        head_fn = getattr(self, "_head_fn", None)
        head = head_fn() if head_fn is not None else self.last_changed_seq
        self._dirty_at = max(self._dirty_at, head + 1)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def summarize(self, path, parent_capture_seq=None):
        """A write marked at head+1 is covered by any ACKED summary whose
        capture seq reached that point (its upload read current _data);
        until then, force a fresh subtree upload."""
        if parent_capture_seq is not None \
                and self._dirty_at > parent_capture_seq:
            parent_capture_seq = None
        return super().summarize(path, parent_capture_seq)

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        raise RuntimeError("SharedSummaryBlock never sends or receives ops")

    def resubmit_pending(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {"data": dict(self._data)}

    def load_core(self, snap: dict) -> None:
        self._data = dict(snap.get("data", {}))
