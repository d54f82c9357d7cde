"""Undo/redo: revertible capture over DDS events.

JAX counterpart: ``fluidframework_tpu/framework/undo_redo.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/undo-redo — UndoRedoStackManager
(undoRedoStackManager.ts:80) groups local DDS changes into operations and
replays inverses; handlers exist for SharedMap value changes
(mapHandler) and sequence deltas (sequenceHandler.ts:23). Undo positions
for text use sliding local references, so intervening remote edits move
the undo target instead of corrupting it.

Known simplification vs the reference: text revertibles anchor RANGES via
sliding references, where the reference tracks the affected SEGMENTS
(merge-tree TrackingGroups maintained through splits). Consequence: undo
chains whose ranges overlap earlier undone/redone ranges are positional
approximations — convergent across replicas (they emit ordinary ops) but
possibly differing from segment-exact undo. Segment tracking groups are
the planned upgrade path.
"""

from __future__ import annotations

from typing import Optional

from ..dds.map import SharedMap
from ..dds.string import SharedString


class _MapRevertible:
    def __init__(self, m: SharedMap, key: str, prev_value, prev_existed: bool):
        self.map = m
        self.key = key
        self.prev_value = prev_value
        self.prev_existed = prev_existed

    def revert(self) -> None:
        if self.prev_existed:
            self.map.set(self.key, self.prev_value)
        else:
            self.map.delete(self.key)


class _InsertRevertible:
    """Undo an insert: remove the (possibly slid) inserted range.

    Anchors on the FIRST and LAST inserted characters (a reference past
    doc end would detach); remote text inserted strictly inside the range
    is removed with it — the reference's segment-tracking handlers are
    finer-grained, this matches its simple sequence handler.
    """

    def __init__(self, s: SharedString, pos: int, length: int):
        self.string = s
        self.start_ref = s.create_reference(pos)
        self.last_ref = s.create_reference(pos + length - 1)

    def revert(self) -> None:
        n = len(self.string)
        start = min(self.string.reference_position(self.start_ref), n)
        last = min(self.string.reference_position(self.last_ref), n - 1)
        if last >= start:
            self.string.remove_text(start, last + 1)


class _RemoveRevertible:
    """Undo a remove: reinsert the text at the (possibly slid) position.

    Anchors on the character BEFORE the removed range — a forward anchor
    would detach whenever the removal reached the end of the document
    (the revertible is built after the removal applied).
    """

    def __init__(self, s: SharedString, pos: int, text: str):
        self.string = s
        self.before_ref = s.create_reference(pos - 1) if pos > 0 else None
        self.text = text

    def revert(self) -> None:
        pos = (0 if self.before_ref is None
               else self.string.reference_position(self.before_ref) + 1)
        # the anchor may sit on a tombstone whose base position is past
        # the live end (e.g. everything after it was undone too)
        self.string.insert_text(min(pos, len(self.string)), self.text)


class UndoRedoStackManager:
    """Attach DDSes; local changes group into undoable operations.

    ``close_current_operation()`` ends a group (one undo step). Reverting
    re-enters the DDSes, and those captures land on the opposite stack; a
    fresh user edit clears the redo stack (standard undo semantics).
    """

    def __init__(self):
        self._undo: list[list] = []
        self._redo: list[list] = []
        self._open: Optional[list] = None
        self._capture_into: Optional[list] = None  # revert-in-progress sink

    # ------------------------------------------------------------ attach

    def attach_map(self, m: SharedMap) -> None:
        m.on("valueChanged", lambda e: self._on_map_event(m, e))

    def attach_string(self, s: SharedString) -> None:
        s.on("sequenceDelta", lambda e: self._on_string_event(s, e))

    def attach_matrix(self, m) -> None:
        """Cell sets and row/col INSERTS are undoable; removals are not
        (purged cells cannot be revived — see _VectorInsertRevertible)."""
        m.on("cellChanged", lambda e: self._on_matrix_cell(m, e))
        m.on("shapeChanged", lambda e: self._on_matrix_shape(m, e))

    def _on_matrix_cell(self, m, event: dict) -> None:
        if event.get("local") and "rowHandle" in event:
            self._capture(_CellRevertible(
                m, event["rowHandle"], event["colHandle"],
                event.get("previousValue")))

    def _on_matrix_shape(self, m, event: dict) -> None:
        if not event.get("local"):
            return
        op = event.get("op", "")
        if op in ("insertRows", "insertCols") and event.get("handles"):
            self._capture(_VectorInsertRevertible(
                m, op == "insertRows", event["handles"]))

    def _on_map_event(self, m: SharedMap, event: dict) -> None:
        if event.get("local"):
            self._capture(_MapRevertible(
                m, event["key"], event.get("previousValue"),
                event.get("previousExisted", False)))

    def _on_string_event(self, s: SharedString, event: dict) -> None:
        if not event.get("local"):
            return
        if event["op"] == "insert":
            self._capture(_InsertRevertible(s, event["pos"], len(event["text"])))
        elif event["op"] == "remove":
            self._capture(_RemoveRevertible(
                s, event["start"], event.get("removedText", "")))

    # ------------------------------------------------------------- stacks

    def _capture(self, revertible) -> None:
        if self._capture_into is not None:
            self._capture_into.append(revertible)
            return
        self._redo.clear()  # a fresh edit invalidates the redo future
        if self._open is None:
            self._open = []
            self._undo.append(self._open)
        self._open.append(revertible)

    def close_current_operation(self) -> None:
        self._open = None

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def _revert_group(self, group: list, into: list) -> None:
        self._capture_into = into
        try:
            for revertible in reversed(group):
                revertible.revert()
        finally:
            self._capture_into = None

    def undo(self) -> bool:
        if not self._undo:
            return False
        self.close_current_operation()
        group = self._undo.pop()
        inverse: list = []
        self._revert_group(group, inverse)
        self._redo.append(inverse)
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        group = self._redo.pop()
        inverse: list = []
        self._revert_group(group, inverse)
        self._undo.append(inverse)
        return True


class _CellRevertible:
    """Undo a setCell by rewriting the previous LWW value, anchored on
    the cell's STABLE handles — concurrent remote row/col inserts shift
    positions, so a position-addressed revert would clobber the wrong
    cell (ref: matrix undoprovider.ts tracks handles for the same
    reason)."""

    def __init__(self, m, row_handle: int, col_handle: int, prev_value):
        self.m, self.rh, self.ch, self.prev = m, row_handle, col_handle, \
            prev_value

    def revert(self) -> None:
        at = self.m.position_of_handles(self.rh, self.ch)
        if at is None:
            return  # the cell's row/col was removed meanwhile: no-op
        self.m.set_cell(at[0], at[1], self.prev)


class _VectorInsertRevertible:
    """Undo an insertRows/insertCols by removing the inserted span,
    resolved through the inserted HANDLES at revert time (the span may
    have moved or been interleaved by remote inserts). Row/col REMOVALS
    are not undoable here: the cells of removed axes are purged with
    their handles, so there is no content to revive — attach_matrix
    documents the scope."""

    def __init__(self, m, is_rows: bool, handles: list):
        self.m, self.is_rows, self.handles = m, is_rows, list(handles)

    def revert(self) -> None:
        vec = self.m.rows if self.is_rows else self.m.cols
        positions = sorted(
            (p for p in (vec.position_of_handle(h) for h in self.handles)
             if p is not None),
            reverse=True)  # highest first: removals don't shift the rest
        for p in positions:
            if self.is_rows:
                self.m.remove_rows(p, 1)
            else:
                self.m.remove_cols(p, 1)
