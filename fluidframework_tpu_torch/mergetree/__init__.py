"""The merge tree: the core sequence CRDT.

Scalar reference implementation ("the oracle") of the merge logic the TPU
kernels in :mod:`fluidframework_tpu.ops` vectorize. Semantics match the
reference's packages/dds/merge-tree (SURVEY.md §2.1): segments stamped with
``(clientId, seq)`` insert/remove pairs, position resolution against a
``(refSeq, clientId)`` perspective, optimistic local apply with ack
stamping, reconnect rebase, collab-window compaction (zamboni).

Deliberate design departures from the reference (TPU-first):

- Flat ordered segment list (structure-of-arrays friendly), not an 8-ary
  B-tree: the kernel's masked prefix-sum over contiguous arrays replaces
  the tree's PartialSequenceLengths cache (ref mergeTree.ts:333,
  partialLengths.ts:62).
- All stamps are plain ints with ``UNASSIGNED_SEQ = 2**31-1`` so every
  visibility rule is a branch-free integer comparison — identical code path
  in the oracle and the int32 tensor kernel.

JAX counterpart: ``fluidframework_tpu/mergetree/__init__.py``, copied unchanged with its imports
rebased onto this package.
"""

from .ops import (
    MergeTreeDeltaType,
    InsertOp,
    RemoveOp,
    AnnotateOp,
    GroupOp,
    MergeOp,
    op_from_wire,
    op_to_wire,
)
from .segments import Segment, NO_CLIENT
from .perspective import Perspective, LOCAL_CLIENT_VIEW
from .mergetree import MergeTree
from .client import MergeTreeClient
from .references import LocalReference, ReferenceType

__all__ = [
    "MergeTreeDeltaType",
    "InsertOp",
    "RemoveOp",
    "AnnotateOp",
    "GroupOp",
    "MergeOp",
    "op_from_wire",
    "op_to_wire",
    "Segment",
    "NO_CLIENT",
    "Perspective",
    "LOCAL_CLIENT_VIEW",
    "MergeTree",
    "MergeTreeClient",
    "LocalReference",
    "ReferenceType",
]
