"""SharedCell: a single LWW value.

JAX counterpart: ``fluidframework_tpu/dds/cell.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/cell/src/cell.ts — set/delete with pending-local
masking (same optimistic rule as the map kernel, for one slot).
Wire ops: {"op": "set", "value"} | {"op": "delete"}.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .registry import register_channel_type
from .shared_object import SharedObject

_EMPTY = object()


@register_channel_type
class SharedCell(SharedObject):
    channel_type = "shared-cell"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._value: Any = _EMPTY
        self._pending_ops: list[dict] = []

    def set(self, value: Any) -> None:
        self._value = value
        op = {"op": "set", "value": value}
        self._pending_ops.append(op)
        self.submit_local_message(op)
        self._emit("valueChanged", {"local": True})

    def delete(self) -> None:
        self._value = _EMPTY
        op = {"op": "delete"}
        self._pending_ops.append(op)
        self.submit_local_message(op)
        self._emit("delete", {"local": True})

    def get(self, default: Any = None) -> Any:
        return default if self._value is _EMPTY else self._value

    @property
    def empty(self) -> bool:
        return self._value is _EMPTY

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._pending_ops.pop(0)
            return
        if self._pending_ops:
            return  # our in-flight write is later in the order: it wins
        op = msg.contents
        if op["op"] == "set":
            self._value = op["value"]
            self._emit("valueChanged", {"local": False})
        else:
            self._value = _EMPTY
            self._emit("delete", {"local": False})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        return {"empty": self._value is _EMPTY,
                "value": None if self._value is _EMPTY else self._value}

    def load_core(self, snap: dict) -> None:
        self._value = _EMPTY if snap.get("empty", True) else snap["value"]


@register_channel_type
class SharedCounter(SharedObject):
    """Commutative increment counter (ref: packages/dds/counter/src/counter.ts).

    Increments commute, so remote ops always apply and local ops apply
    optimistically; no masking needed. Wire: {"op": "increment", "delta"}.
    """

    channel_type = "shared-counter"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self.value: int = 0
        self._pending_ops: list[dict] = []

    def increment(self, delta: int = 1) -> None:
        if not isinstance(delta, int):
            raise TypeError("counter delta must be an integer")
        self.value += delta
        op = {"op": "increment", "delta": delta}
        self._pending_ops.append(op)
        self.submit_local_message(op)
        self._emit("incremented", {"delta": delta, "value": self.value, "local": True})

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._pending_ops.pop(0)  # already applied optimistically
            return
        delta = msg.contents["delta"]
        self.value += delta
        self._emit("incremented", {"delta": delta, "value": self.value, "local": False})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        # acked value only: pending increments replay on top after load
        acked = self.value - sum(op["delta"] for op in self._pending_ops)
        return {"value": acked}

    def load_core(self, snap: dict) -> None:
        self.value = snap.get("value", 0)
