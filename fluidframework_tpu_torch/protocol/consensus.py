"""Quorum member and proposal types (ref: protocol-definitions/src/consensus.ts).

JAX counterpart: ``fluidframework_tpu/protocol/consensus.py``; the port's copy,
imports rebased to this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


@dataclass
class ClientDetails:
    """Connection-time client description (ref: protocol-definitions IClient)."""

    user_id: str = ""
    mode: str = "write"  # "read" | "write"
    interactive: bool = True  # False for summarizer/agent clients
    details: dict = field(default_factory=dict)
    scopes: list[str] = field(default_factory=list)


@dataclass
class SequencedClient:
    """A quorum member: a client plus the seq of its join op.

    Ref: consensus.ts ISequencedClient — join-op order is what makes
    "oldest client" well-defined for summarizer election.
    """

    client: ClientDetails
    sequence_number: int


class ProposalState(Enum):
    PENDING = "pending"
    ACCEPTED = "accepted"
    REJECTED = "rejected"


@dataclass
class QuorumProposal:
    """A key/value proposal flowing through the total order.

    Commit rule (ref: protocol-base/src/quorum.ts:67): a proposal is accepted
    once the minimum sequence number passes its sequence number with no
    rejection — unanimous-silence consensus.
    """

    key: str
    value: Any
    sequence_number: int  # seq of the propose op (0 until sequenced)
    local: bool = False
    state: ProposalState = ProposalState.PENDING
    rejections: set[str] = field(default_factory=set)
    approval_seq: Optional[int] = None
