"""Perspectives: the (refSeq, clientId) views that make the CRDT tick.

Every operation is interpreted in the view its author had when creating it:
segments inserted after the author's refSeq by OTHER clients are invisible
to it; the author's own prior (even unacked) segments are visible. This is
the rule the reference encodes in merge-tree length queries
(packages/dds/merge-tree/src/partialLengths.ts:62,432 and
mergeTree.ts leaf visibility) — here it is two pure integer predicates,
shared verbatim in spirit with the int32 tensor kernel.

JAX counterpart: ``fluidframework_tpu/mergetree/perspective.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..protocol.messages import UNASSIGNED_SEQ


@dataclass(frozen=True)
class Perspective:
    """(ref_seq, client) view; ``local_seq`` optionally bounds which of the
    client's OWN pending ops have applied — the "rebase view" used when
    regenerating op ``local_seq`` after reconnect (only pending inserts with
    local seq ≤ bound and pending removes with local seq < bound count;
    ref: client.ts:675 findReconnectionPostition's localSeq walks)."""

    ref_seq: int
    client: int
    local_seq: Optional[int] = None

    def sees_insert(self, ins_seq: int, ins_client: int) -> bool:
        """Is a segment's insert visible in this view?

        Own inserts are always visible (a client's later ops may reference
        its own still-unacked content); others' only once sequenced at or
        below ref_seq.
        """
        return ins_client == self.client or ins_seq <= self.ref_seq

    def sees_removed(self, rem_seq: int, rem_client: int) -> bool:
        """Is a segment's remove visible (i.e. the segment gone) in this view?

        ``rem_seq`` uses 0 for "never removed" handled by caller; here a
        remove counts if it is our own or sequenced at or below ref_seq.
        """
        return rem_client == self.client or rem_seq <= self.ref_seq


# The local client's current view: refSeq = UNASSIGNED_SEQ makes every
# assigned stamp (and the client's own pending UNASSIGNED stamps) visible.
# Construct per-client as Perspective(UNASSIGNED_SEQ, my_client_id).
def LOCAL_CLIENT_VIEW(client: int) -> Perspective:
    return Perspective(UNASSIGNED_SEQ, client)
