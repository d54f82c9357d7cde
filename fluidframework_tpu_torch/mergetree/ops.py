"""Merge-tree operation model.

Ref: packages/dds/merge-tree/src/ops.ts:34-110 (MergeTreeDeltaType,
IMergeTreeInsertMsg/RemoveMsg/AnnotateMsg/GroupMsg) and opBuilder.ts.

JAX counterpart: ``fluidframework_tpu/mergetree/ops.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Union


class MergeTreeDeltaType(IntEnum):
    INSERT = 0
    REMOVE = 1
    ANNOTATE = 2
    GROUP = 3


@dataclass
class InsertOp:
    pos: int
    text: Optional[str] = None  # text payload, or None for a marker
    marker: Optional[dict] = None  # marker payload: {"refType": int, ...}
    props: Optional[dict] = None

    type: MergeTreeDeltaType = MergeTreeDeltaType.INSERT


@dataclass
class RemoveOp:
    start: int
    end: int  # exclusive

    type: MergeTreeDeltaType = MergeTreeDeltaType.REMOVE


@dataclass
class AnnotateOp:
    start: int
    end: int  # exclusive
    props: dict = field(default_factory=dict)

    type: MergeTreeDeltaType = MergeTreeDeltaType.ANNOTATE


@dataclass
class GroupOp:
    ops: list["MergeOp"] = field(default_factory=list)

    type: MergeTreeDeltaType = MergeTreeDeltaType.GROUP


MergeOp = Union[InsertOp, RemoveOp, AnnotateOp, GroupOp]


def op_to_wire(op: MergeOp) -> dict:
    """JSON-serializable wire form (used in DocumentMessage.contents)."""
    if isinstance(op, InsertOp):
        d = {"type": int(op.type), "pos": op.pos}
        if op.text is not None:
            d["text"] = op.text
        if op.marker is not None:
            d["marker"] = op.marker
        if op.props:
            d["props"] = op.props
        return d
    if isinstance(op, RemoveOp):
        return {"type": int(op.type), "start": op.start, "end": op.end}
    if isinstance(op, AnnotateOp):
        return {"type": int(op.type), "start": op.start, "end": op.end, "props": op.props}
    if isinstance(op, GroupOp):
        return {"type": int(op.type), "ops": [op_to_wire(o) for o in op.ops]}
    raise TypeError(f"not a merge-tree op: {op!r}")


def op_from_wire(d: dict) -> MergeOp:
    t = MergeTreeDeltaType(d["type"])
    if t == MergeTreeDeltaType.INSERT:
        return InsertOp(
            pos=d["pos"], text=d.get("text"), marker=d.get("marker"), props=d.get("props")
        )
    if t == MergeTreeDeltaType.REMOVE:
        return RemoveOp(start=d["start"], end=d["end"])
    if t == MergeTreeDeltaType.ANNOTATE:
        return AnnotateOp(start=d["start"], end=d["end"], props=d["props"])
    if t == MergeTreeDeltaType.GROUP:
        return GroupOp(ops=[op_from_wire(o) for o in d["ops"]])
    raise ValueError(f"unknown merge-tree op type {t}")
