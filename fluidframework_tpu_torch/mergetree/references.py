"""Local references: stable cursors into the merge tree.

Ref: packages/dds/merge-tree/src/localReference.ts and ops.ts:6
(ReferenceType). A reference pins (segment, offset); when its segment is
removed/compacted it slides to the nearest surviving segment (SlideOnRemove
semantics). Interval collections build on these.

JAX counterpart: ``fluidframework_tpu/mergetree/references.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from enum import IntFlag
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from .segments import Segment


class ReferenceType(IntFlag):
    SIMPLE = 0
    SLIDE_ON_REMOVE = 1
    STAY_ON_REMOVE = 2
    TRANSIENT = 4
    RANGE_BEGIN = 8
    RANGE_END = 16


class LocalReference:
    __slots__ = ("segment", "offset", "ref_type", "properties")

    def __init__(
        self,
        segment: Optional["Segment"],
        offset: int = 0,
        ref_type: ReferenceType = ReferenceType.SLIDE_ON_REMOVE,
        properties: Optional[dict] = None,
    ):
        self.segment = segment
        self.offset = offset
        self.ref_type = ref_type
        self.properties = properties or {}

    def is_detached(self) -> bool:
        return self.segment is None
