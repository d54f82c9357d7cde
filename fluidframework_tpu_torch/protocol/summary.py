"""Summary (checkpoint) tree contracts.

JAX counterpart: ``fluidframework_tpu/protocol/summary.py``; the port's copy,
imports rebased to this package.

A summary is a recursive tree: container → data stores → channels → DDS
snapshot blobs. Incremental summaries replace unchanged subtrees with a
:class:`SummaryHandle` pointing at the previously-acked summary, so only
changed state is re-uploaded.

Ref: protocol-definitions/src/summary.ts (ISummaryTree/ISummaryBlob/
ISummaryHandle/ISummaryAttachment).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Union


class SummaryType(IntEnum):
    TREE = 1
    BLOB = 2
    HANDLE = 3
    ATTACHMENT = 4


@dataclass
class SummaryBlob:
    """Leaf content; bytes or utf-8 text."""

    content: bytes

    type: SummaryType = SummaryType.BLOB


@dataclass
class SummaryHandle:
    """Reference to a subtree of the previous acked summary by path.

    ``handle`` is a '/'-separated path within the parent summary
    (ref: summary.ts ISummaryHandle — handle reuse is what makes summaries
    incremental).
    """

    handle: str
    handle_type: SummaryType = SummaryType.TREE

    type: SummaryType = SummaryType.HANDLE


@dataclass
class SummaryAttachment:
    """Reference to an already-uploaded blob by content id."""

    id: str

    type: SummaryType = SummaryType.ATTACHMENT


@dataclass
class SummaryTree:
    tree: dict[str, "SummaryObject"] = field(default_factory=dict)
    unreferenced: bool = False

    type: SummaryType = SummaryType.TREE


SummaryObject = Union[SummaryTree, SummaryBlob, SummaryHandle, SummaryAttachment]


def summary_to_wire(obj: SummaryObject) -> dict:
    """JSON-safe encoding (network storage RPC carries summary trees)."""
    if isinstance(obj, SummaryTree):
        return {"__summary__": "tree",
                "tree": {k: summary_to_wire(v) for k, v in obj.tree.items()}}
    if isinstance(obj, SummaryBlob):
        return {"__summary__": "blob", "hex": obj.content.hex()}
    if isinstance(obj, SummaryHandle):
        return {"__summary__": "handle", "handle": obj.handle}
    if isinstance(obj, SummaryAttachment):
        return {"__summary__": "attachment", "id": obj.id}
    raise TypeError(f"not a summary object: {obj!r}")


def summary_from_wire(d: dict) -> SummaryObject:
    kind = d["__summary__"]
    if kind == "tree":
        return SummaryTree(
            tree={k: summary_from_wire(v) for k, v in d["tree"].items()})
    if kind == "blob":
        return SummaryBlob(content=bytes.fromhex(d["hex"]))
    if kind == "handle":
        return SummaryHandle(handle=d["handle"])
    if kind == "attachment":
        return SummaryAttachment(id=d["id"])
    raise ValueError(f"unknown summary wire kind {kind!r}")


def is_summary_wire(d) -> bool:
    return isinstance(d, dict) and "__summary__" in d


@dataclass
class SummaryProposal:
    """Body of a MessageType.SUMMARIZE op (ref: protocol.ts:198-260)."""

    handle: str  # storage handle of the uploaded summary tree
    head: str  # parent summary handle this one builds on
    message: str = ""
    parents: list[str] = field(default_factory=list)


@dataclass
class SummaryAck:
    """Body of a MessageType.SUMMARY_ACK op."""

    handle: str  # storage handle of the committed summary
    summary_proposal_seq: int  # seq of the summarize op being acked


@dataclass
class SummaryNack:
    """Body of a MessageType.SUMMARY_NACK op."""

    summary_proposal_seq: int
    error_message: str = ""
