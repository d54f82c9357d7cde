"""SharedMap: LWW key-value store with optimistic local ops.

JAX counterpart: ``fluidframework_tpu/dds/map.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/map/src/map.ts over mapKernel.ts:141 — the kernel logic
lives in map_kernel.MapKernel, shared with SharedDirectory exactly as the
reference shares mapKernel.ts.

Wire ops: {"op": "set", "key", "value"} | {"op": "delete", "key"}
| {"op": "clear"}.
"""

from __future__ import annotations

from typing import Any, Iterator

from ..protocol.messages import SequencedDocumentMessage
from .map_kernel import MapKernel
from .registry import register_channel_type
from .shared_object import SharedObject


@register_channel_type
class SharedMap(SharedObject):
    channel_type = "shared-map"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._kernel = MapKernel()
        self._pending_ops: list[dict] = []  # FIFO, for ack + resubmit

    # ----------------------------------------------------------- mutators

    def set(self, key: str, value: Any) -> None:
        prev = (self._kernel.get(key), self._kernel.has(key))
        self._kernel.local_set(key, value)
        self._submit_map_op({"op": "set", "key": key, "value": value})
        self._emit("valueChanged", {"key": key, "local": True,
                                    "previousValue": prev[0],
                                    "previousExisted": prev[1]})

    def delete(self, key: str) -> bool:
        prev = (self._kernel.get(key), self._kernel.has(key))
        existed = self._kernel.local_delete(key)
        self._submit_map_op({"op": "delete", "key": key})
        self._emit("valueChanged", {"key": key, "local": True,
                                    "previousValue": prev[0],
                                    "previousExisted": prev[1]})
        return existed

    def clear(self) -> None:
        self._kernel.local_clear()
        self._submit_map_op({"op": "clear"})
        self._emit("clear", {"local": True})

    def _submit_map_op(self, op: dict) -> None:
        self._pending_ops.append(op)
        self.submit_local_message(op)

    # ------------------------------------------------------------ readers

    def get(self, key: str, default: Any = None) -> Any:
        return self._kernel.get(key, default)

    def has(self, key: str) -> bool:
        return self._kernel.has(key)

    def keys(self) -> Iterator[str]:
        return self._kernel.keys()

    def items(self):
        return self._kernel.data.items()

    def __len__(self) -> int:
        return len(self._kernel.data)

    # ----------------------------------------------------------- contract

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._kernel.ack(self._pending_ops.pop(0))
            return
        op = msg.contents
        if self._kernel.apply_remote(op):
            if op["op"] == "clear":
                self._emit("clear", {"local": False})
            else:
                self._emit("valueChanged", {"key": op["key"], "local": False})

    def resubmit_pending(self) -> None:
        # LWW values carry no positions: resubmit verbatim, same order
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        return {"data": dict(self._kernel.data)}

    def load_core(self, snap: dict) -> None:
        self._kernel.data = dict(snap.get("data", {}))
