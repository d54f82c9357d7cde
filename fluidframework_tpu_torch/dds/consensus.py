"""Consensus collections: linearizable primitives over the total order.

JAX counterpart: ``fluidframework_tpu/dds/consensus.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/register-collection (consensusRegisterCollection.ts) and
packages/dds/ordered-collection (consensusOrderedCollection.ts,
consensusQueue.ts). Unlike the optimistic DDSes these expose only ACKED
state — a write is visible when its op comes back sequenced, and
linearizability falls out of the total order + collaboration window.
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, Optional

from ..protocol.messages import SequencedDocumentMessage
from .registry import register_channel_type
from .shared_object import SharedObject


@register_channel_type
class ConsensusRegisterCollection(SharedObject):
    """Named linearizable registers with concurrency-window versioning.

    Ref: consensusRegisterCollection.ts — each write lands with its
    (seq, refSeq); versions the writer had SEEN (seq ≤ writer's refSeq)
    are superseded and dropped; concurrent versions coexist until later
    writes observe them. Read policies: "atomic" = the earliest surviving
    version (the consensus winner), "lww" = the latest.

    Wire: {"op": "write", "key", "value"}.
    """

    channel_type = "consensus-register-collection"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        # key → list of {"value", "seq"} ordered by seq
        self._versions: dict[str, list[dict]] = {}
        self._pending_ops: list[dict] = []

    def write(self, key: str, value: Any) -> None:
        op = {"op": "write", "key": key, "value": value}
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def read(self, key: str, policy: str = "atomic") -> Optional[Any]:
        versions = self._versions.get(key)
        if not versions:
            return None
        return versions[0 if policy == "atomic" else -1]["value"]

    def read_versions(self, key: str) -> list[Any]:
        return [v["value"] for v in self._versions.get(key, [])]

    def keys(self):
        return list(self._versions.keys())

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._pending_ops.pop(0)
        op = msg.contents
        key = op["key"]
        versions = self._versions.setdefault(key, [])
        # versions the writer had seen are superseded (ref:
        # consensusRegisterCollection processInboundWrite)
        ref = msg.reference_sequence_number
        versions[:] = [v for v in versions if v["seq"] > ref]
        versions.append({"value": op["value"], "seq": msg.sequence_number})
        won = versions[0]["seq"] == msg.sequence_number
        self._emit("atomicChanged" if won else "versionChanged",
                   {"key": key, "local": local})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        return {"versions": {k: list(v) for k, v in self._versions.items()}}

    def load_core(self, snap: dict) -> None:
        self._versions = {k: list(v) for k, v in snap.get("versions", {}).items()}


@register_channel_type
class ConsensusQueue(SharedObject):
    """Exactly-once distributed work queue.

    Ref: consensusOrderedCollection.ts/consensusQueue.ts — ``add`` appends;
    ``acquire`` hands the head to exactly one client (decided by the total
    order); the holder must ``complete`` (remove durably) or ``release``
    (requeue). A holder's leave releases its items deterministically
    (every replica sees the same sequenced leave).

    Wire: {"op": "add", "value", "id"} | {"op": "acquire", "id"}
    | {"op": "complete"/"release", "id"}.
    """

    channel_type = "consensus-queue"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self._items: list[dict] = []  # {"id", "value"} FIFO
        self._in_flight: dict[str, dict] = {}  # item id → {"value", "client"}
        self._pending_ops: list[dict] = []
        self._uid = itertools.count()
        # ids minted before attach must still be globally unique — a
        # literal 'detached' prefix would collide across replicas
        self._detached_token = f"detached-{uuid.uuid4().hex[:12]}"

    # ---------------------------------------------------------------- api

    def _mint_id(self) -> str:
        return f"{self.client_id or self._detached_token}:{next(self._uid)}"

    def add(self, value: Any) -> None:
        op = {"op": "add", "value": value, "id": self._mint_id()}
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def acquire(self) -> str:
        """Request the queue head. Returns a ticket; listen for
        "acquired" events or poll :meth:`holding` for the outcome."""
        ticket = self._mint_id()
        op = {"op": "acquire", "id": ticket}
        self._pending_ops.append(op)
        self.submit_local_message(op)
        return ticket

    def complete(self, item_id: str) -> None:
        op = {"op": "complete", "id": item_id}
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def release(self, item_id: str) -> None:
        op = {"op": "release", "id": item_id}
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def holding(self, client_id: Optional[str] = None) -> list[tuple[str, Any]]:
        """Items currently held by ``client_id`` (default: me)."""
        me = client_id or self.client_id
        return [(iid, e["value"]) for iid, e in self._in_flight.items()
                if e["client"] == me]

    def __len__(self) -> int:
        return len(self._items)

    def peek_values(self) -> list[Any]:
        return [i["value"] for i in self._items]

    # ----------------------------------------------------------- contract

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        if local:
            self._pending_ops.pop(0)
        op = msg.contents
        kind = op["op"]
        if kind == "add":
            self._items.append({"id": op["id"], "value": op["value"]})
            self._emit("add", {"value": op["value"], "local": local})
        elif kind == "acquire":
            if self._items:
                item = self._items.pop(0)
                self._in_flight[item["id"]] = {
                    "value": item["value"], "client": msg.client_id}
                self._emit("acquired", {
                    "ticket": op["id"], "itemId": item["id"],
                    "value": item["value"], "client": msg.client_id,
                    "local": local})
            elif local:
                self._emit("acquireFailed", {"ticket": op["id"]})
        elif kind == "complete":
            entry = self._in_flight.pop(op["id"], None)
            if entry is not None:
                self._emit("complete", {"itemId": op["id"], "value": entry["value"]})
        elif kind == "release":
            entry = self._in_flight.pop(op["id"], None)
            if entry is not None:
                # released items re-add at the BACK (ref:
                # consensusOrderedCollection removeClient/release), which
                # also keeps multi-item releases in FIFO order
                self._items.append({"id": op["id"], "value": entry["value"]})
                self._emit("localRelease", {"itemId": op["id"]})

    def on_member_removed(self, client_id: str) -> None:
        """A holder left: requeue its items (deterministic — driven by the
        sequenced leave every replica processes)."""
        for iid in [i for i, e in self._in_flight.items() if e["client"] == client_id]:
            entry = self._in_flight.pop(iid)
            self._items.append({"id": iid, "value": entry["value"]})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        return {"items": list(self._items),
                "inFlight": {k: dict(v) for k, v in self._in_flight.items()}}

    def load_core(self, snap: dict) -> None:
        self._items = list(snap.get("items", []))
        self._in_flight = {k: dict(v) for k, v in snap.get("inFlight", {}).items()}
