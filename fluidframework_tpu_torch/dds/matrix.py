"""SharedMatrix: a 2-D grid over two merge-tree permutation vectors.

JAX counterpart: ``fluidframework_tpu/dds/matrix.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/matrix (SURVEY §2.2) — rows and cols are each a
merge-tree sequence (permutationvector.ts:124) mapping logical index →
stable LOCAL handle; cells live in a sparse store keyed by (row_handle,
col_handle) (sparsearray2d.ts:60). Row/col insert/remove are merge-tree
ops; setCell is LWW with pending-local masking (matrix.ts:197-273).

Handles never cross the wire: insert ops carry only (pos, count) and each
replica allocates its own contiguous handles on apply; setCell ops carry
(row, col) POSITIONS resolved at the author's (refSeq, clientId)
perspective — exactly the merge-tree concurrent-position rule, reused
twice.

Wire: {"op": "insertRows"/"insertCols"/"removeRows"/"removeCols",
       "pos", "count"}
    | {"op": "setCell", "row", "col", "value"}.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Optional

from ..mergetree.client import MergeTreeClient
from ..mergetree.ops import InsertOp, RemoveOp, op_to_wire
from ..mergetree.perspective import Perspective
from ..protocol.messages import SequencedDocumentMessage
from .registry import register_channel_type
from .shared_object import SharedObject

HANDLE_BASE = 0x100  # handle h ↔ chr(HANDLE_BASE + h) in segment text
DETACHED_ID = "detached"


class PermutationVector:
    """Logical index → stable local handle, under concurrent edits.

    The merge-tree does all the work: segment text chars ARE the handles
    (split arithmetic keeps them contiguous per fragment), and position
    resolution at any (refSeq, client) perspective is the standard
    merge-tree query (ref: permutationvector.ts PermutationSegment:36,
    handletable.ts:19).
    """

    def __init__(self):
        self.mc = MergeTreeClient(DETACHED_ID)
        self._next_handle = 0

    def alloc(self, count: int) -> str:
        start = self._next_handle
        self._next_handle += count
        return "".join(chr(HANDLE_BASE + start + i) for i in range(count))

    @property
    def length(self) -> int:
        return self.mc.get_length()

    def handle_at(self, pos: int, perspective: Optional[Perspective] = None) -> int:
        """The stable handle of the item at ``pos`` in the given view."""
        persp = perspective or self.mc.local_view()
        seg, off = self.mc.tree.visible_segment_at(pos, persp)
        if seg is None:
            raise IndexError(f"position {pos} out of range")
        return ord(seg.text[off]) - HANDLE_BASE

    def position_of_handle(self, handle: int) -> Optional[int]:
        """CURRENT local position of a handle (None if its item is gone)."""
        ch = chr(HANDLE_BASE + handle)
        persp = self.mc.local_view()
        pos = 0
        for seg in self.mc.tree.segments:
            vl = seg.visible_length(persp)
            idx = seg.text.find(ch) if seg.text else -1
            if idx >= 0:
                return pos + idx if vl > 0 else None
            pos += vl
        return None

    def snapshot(self) -> dict:
        return {"mc": self.mc.snapshot(), "nextHandle": self._next_handle}

    def load(self, snap: dict) -> None:
        self.mc = MergeTreeClient.load(DETACHED_ID, snap["mc"])
        self._next_handle = snap["nextHandle"]


@register_channel_type
class SharedMatrix(SharedObject):
    channel_type = "shared-matrix"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self.rows = PermutationVector()
        self.cols = PermutationVector()
        self._cells: dict[tuple[int, int], Any] = {}  # (row_h, col_h) → value
        # FIFO of pending local ops:
        # {"kind": "vector", "wire": ..., } | {"kind": "cell", "rh","ch","wire"}
        self._pending: list[dict] = []
        self._pending_cells: dict[tuple[int, int], int] = {}

    # ------------------------------------------------------------ shape api

    @property
    def row_count(self) -> int:
        return self.rows.length

    @property
    def col_count(self) -> int:
        return self.cols.length

    def insert_rows(self, pos: int, count: int) -> None:
        self._insert_vector(self.rows, "insertRows", pos, count)

    def insert_cols(self, pos: int, count: int) -> None:
        self._insert_vector(self.cols, "insertCols", pos, count)

    def remove_rows(self, pos: int, count: int) -> None:
        self._remove_vector(self.rows, "removeRows", pos, count)

    def remove_cols(self, pos: int, count: int) -> None:
        self._remove_vector(self.cols, "removeCols", pos, count)

    def _insert_vector(self, vec: PermutationVector, kind: str, pos: int, count: int) -> None:
        vec.mc.insert_text_local(pos, vec.alloc(count))
        wire = {"op": kind, "pos": pos, "count": count}
        self._pending.append({"kind": "vector", "wire": wire})
        self.submit_local_message(wire)
        self._emit("shapeChanged", {
            "op": kind, "pos": pos, "count": count, "local": True,
            # stable handles of the inserted span: undo anchors on these,
            # not on positions that concurrent remote edits can shift
            "handles": [vec.handle_at(p) for p in range(pos, pos + count)],
        })

    def _remove_vector(self, vec: PermutationVector, kind: str, pos: int, count: int) -> None:
        handles = [vec.handle_at(p) for p in range(pos, pos + count)]
        vec.mc.remove_range_local(pos, pos + count)
        wire = {"op": kind, "pos": pos, "count": count}
        self._pending.append({"kind": "vector", "wire": wire})
        self.submit_local_message(wire)
        self._purge_cells(kind.endswith("Rows"), handles)
        self._emit("shapeChanged", {"op": kind, "local": True})

    def _purge_cells(self, is_rows: bool, handles: list[int]) -> None:
        """Drop cell values of removed rows/cols so the sparse store and
        snapshots do not grow without bound (ref: matrix handle recycling
        via handletable.ts — we reclaim storage, not handles)."""
        dead = set(handles)
        axis = 0 if is_rows else 1
        for key in [k for k in self._cells if k[axis] in dead]:
            del self._cells[key]

    # ------------------------------------------------------------- cell api

    def set_cell(self, row: int, col: int, value: Any) -> None:
        rh = self.rows.handle_at(row)
        ch = self.cols.handle_at(col)
        prev = self._cells.get((rh, ch))
        self._cells[(rh, ch)] = value
        self._pending_cells[(rh, ch)] = self._pending_cells.get((rh, ch), 0) + 1
        wire = {"op": "setCell", "row": row, "col": col, "value": value}
        self._pending.append({"kind": "cell", "rh": rh, "ch": ch, "wire": wire})
        self.submit_local_message(wire)
        self._emit("cellChanged", {"row": row, "col": col, "local": True,
                                   "rowHandle": rh, "colHandle": ch,
                                   "previousValue": prev})

    def position_of_handles(self, row_handle: int, col_handle: int):
        """Current (row, col) of a stable handle pair, or None when
        either axis was removed — the undo anchor resolution."""
        row = self.rows.position_of_handle(row_handle)
        col = self.cols.position_of_handle(col_handle)
        if row is None or col is None:
            return None
        return row, col

    def get_cell(self, row: int, col: int) -> Any:
        rh = self.rows.handle_at(row)
        ch = self.cols.handle_at(col)
        return self._cells.get((rh, ch))

    def to_lists(self) -> list[list[Any]]:
        return [
            [self.get_cell(r, c) for c in range(self.col_count)]
            for r in range(self.row_count)
        ]

    # ------------------------------------------------------------- contract

    _VECTOR_OPS = {
        "insertRows": ("rows", True), "insertCols": ("cols", True),
        "removeRows": ("rows", False), "removeCols": ("cols", False),
    }

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        op = msg.contents
        kind = op["op"]
        if local:
            head = self._pending.pop(0)
            if head["kind"] == "cell":
                key = (head["rh"], head["ch"])
                self._pending_cells[key] -= 1
                if self._pending_cells[key] == 0:
                    del self._pending_cells[key]
                self._observe_all(msg)
            else:
                # ack the vector op on its owning merge tree; the other
                # vector just observes the (seq, msn) advance
                axis, is_insert = self._VECTOR_OPS[head["wire"]["op"]]
                mt_wire = self._to_merge_wire(head["wire"], text="?" * head["wire"]["count"])
                getattr(self, axis).mc.apply_msg(replace(msg, contents=mt_wire), True)
                self._observe_other(axis, msg)
            return

        if kind == "setCell":
            rows_persp = Perspective(
                msg.reference_sequence_number, self.rows.mc.intern(msg.client_id))
            cols_persp = Perspective(
                msg.reference_sequence_number, self.cols.mc.intern(msg.client_id))
            rh = self.rows.handle_at(op["row"], rows_persp)
            ch = self.cols.handle_at(op["col"], cols_persp)
            self._observe_all(msg)
            if (rh, ch) in self._pending_cells:
                return  # our in-flight write is later in the order: it wins
            if (self.rows.position_of_handle(rh) is None
                    or self.cols.position_of_handle(ch) is None):
                return  # target row/col already removed: don't resurrect
            self._cells[(rh, ch)] = op["value"]
            self._emit("cellChanged", {"rowHandle": rh, "colHandle": ch,
                                       "local": False})
            return

        axis, is_insert = self._VECTOR_OPS[kind]
        vec: PermutationVector = getattr(self, axis)
        text = vec.alloc(op["count"]) if is_insert else ""
        if not is_insert:
            # capture the doomed handles at the author's view before apply
            persp = Perspective(msg.reference_sequence_number,
                                vec.mc.intern(msg.client_id))
            dead = [vec.handle_at(p, persp)
                    for p in range(op["pos"], op["pos"] + op["count"])]
        vec.mc.apply_msg(replace(msg, contents=self._to_merge_wire(op, text)), False)
        if not is_insert:
            self._purge_cells(axis == "rows", dead)
        self._observe_other(axis, msg)
        self._emit("shapeChanged", {"op": kind, "local": False})

    @staticmethod
    def _to_merge_wire(op: dict, text: str) -> dict:
        if op["op"].startswith("insert"):
            return op_to_wire(InsertOp(pos=op["pos"], text=text))
        return op_to_wire(RemoveOp(start=op["pos"], end=op["pos"] + op["count"]))

    def _observe_all(self, msg: SequencedDocumentMessage) -> None:
        for vec in (self.rows, self.cols):
            self._observe(vec, msg)

    def _observe_other(self, applied_axis: str, msg: SequencedDocumentMessage) -> None:
        self._observe(self.cols if applied_axis == "rows" else self.rows, msg)

    @staticmethod
    def _observe(vec: PermutationVector, msg: SequencedDocumentMessage) -> None:
        """Advance (seq, msn) on a vector that got no op of its own, so
        zamboni windows stay in sync with the document order."""
        tree = vec.mc.tree
        tree.current_seq = max(tree.current_seq, msg.sequence_number)
        tree.update_min_seq(msg.minimum_sequence_number)

    # ------------------------------------------------------------ reconnect

    def resubmit_pending(self) -> None:
        """Rebase-and-resubmit: vector ops regenerate through their merge
        trees; cell ops re-resolve their handles to CURRENT positions
        (dropping writes to rows/cols that no longer exist)."""
        pending, self._pending = self._pending, []
        for axis in ("rows", "cols"):
            vec: PermutationVector = getattr(self, axis)
            for mop in vec.mc.regenerate_pending_ops():
                if isinstance(mop, InsertOp):
                    wire = {"op": f"insert{axis.capitalize()}", "pos": mop.pos,
                            "count": len(mop.text)}
                else:
                    wire = {"op": f"remove{axis.capitalize()}", "pos": mop.start,
                            "count": mop.end - mop.start}
                self._pending.append({"kind": "vector", "wire": wire})
                self.submit_local_message(wire)
        for entry in pending:
            if entry["kind"] != "cell":
                continue
            row = self.rows.position_of_handle(entry["rh"])
            col = self.cols.position_of_handle(entry["ch"])
            key = (entry["rh"], entry["ch"])
            if row is None or col is None:
                # target vanished: drop the write and its pending mask
                self._pending_cells[key] -= 1
                if self._pending_cells[key] == 0:
                    del self._pending_cells[key]
                continue
            wire = dict(entry["wire"], row=row, col=col)
            self._pending.append({"kind": "cell", "rh": entry["rh"],
                                  "ch": entry["ch"], "wire": wire})
            self.submit_local_message(wire)

    def on_connect(self, client_id: str) -> None:
        for vec in (self.rows, self.cols):
            if client_id != vec.mc.client_id:
                vec.mc.update_client_id(client_id)

    # ------------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        return {
            "rows": self.rows.snapshot(),
            "cols": self.cols.snapshot(),
            "cells": [[rh, ch, v] for (rh, ch), v in self._cells.items()],
        }

    def load_core(self, snap: dict) -> None:
        self.rows.load(snap["rows"])
        self.cols.load(snap["cols"])
        self._cells = {(rh, ch): v for rh, ch, v in snap["cells"]}
