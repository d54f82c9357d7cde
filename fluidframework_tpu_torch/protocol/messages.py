"""Operation message types — the unit of everything in the framework.

JAX counterpart: ``fluidframework_tpu/protocol/messages.py``; the port's copy,
imports rebased to this package.

The server assigns each client-submitted :class:`DocumentMessage` a position in
a single total order per document, producing a
:class:`SequencedDocumentMessage`; all merge logic downstream is a
deterministic function of that sequenced stream.

Ref: protocol-definitions/src/protocol.ts:6-160 (MessageType,
IDocumentMessage, ISequencedDocumentMessage, INack, ITrace).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


# Sequence number sentinels.
# A local, not-yet-acked op carries UNASSIGNED_SEQ; it compares as "newer than
# everything" in perspective checks (ref: merge-tree constants
# UnassignedSequenceNumber = -1, NonCollabClient etc. in
# packages/dds/merge-tree/src/constants.ts — we use explicit large/small
# sentinels that keep integer comparisons branch-free for the tensor path).
UNASSIGNED_SEQ = 2**31 - 1  # local pending op: newer than any assigned seq
UNIVERSAL_SEQ = 0  # content present from the beginning (snapshot load)


class MessageType(str, Enum):
    """Total-order message kinds (ref: protocol.ts:6-55)."""

    NOOP = "noop"
    CLIENT_JOIN = "join"
    CLIENT_LEAVE = "leave"
    PROPOSE = "propose"
    REJECT = "reject"
    ACCEPT = "accept"
    SUMMARIZE = "summarize"
    SUMMARY_ACK = "summaryAck"
    SUMMARY_NACK = "summaryNack"
    OPERATION = "op"
    NO_CLIENT = "noClient"
    CONTROL = "control"


class NackErrorType(str, Enum):
    """Why the server refused an op (ref: protocol-definitions INackContent)."""

    BAD_REQUEST = "BadRequestError"
    THROTTLING = "ThrottlingError"
    INVALID_SCOPE = "InvalidScopeError"
    LIMIT_EXCEEDED = "LimitExceededError"


@dataclass(slots=True)
class TraceHop:
    """One service hop stamped onto a message for wire-level latency tracing.

    Ref: protocol-definitions/src/protocol.ts:59-67 (ITrace); deli stamps
    start/end in lambdas/src/deli/lambda.ts.
    """

    service: str
    action: str
    timestamp: float = field(default_factory=lambda: time.time())


@dataclass(slots=True)
class DocumentMessage:
    """Client → server message (ref: protocol.ts:84-110 IDocumentMessage)."""

    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Optional[dict] = None
    traces: list[TraceHop] = field(default_factory=list)


@dataclass(slots=True)
class SequencedDocumentMessage:
    """Server → client message: an op with its place in the total order.

    Ref: protocol.ts:132-160 (ISequencedDocumentMessage). Carries the assigned
    ``sequence_number``, the document-wide ``minimum_sequence_number`` (the
    collaboration-window floor: every connected client has seen at least this
    far), and echoes of the client-side numbers for dup/gap detection.
    """

    client_id: Optional[str]  # None for server-generated messages
    sequence_number: int
    minimum_sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Optional[dict] = None
    origin: Optional[str] = None
    timestamp: float = 0.0
    traces: list[TraceHop] = field(default_factory=list)


@dataclass(slots=True)
class Nack:
    """Server rejection of a submitted op (ref: protocol.ts:70-82 INack)."""

    operation: Optional[DocumentMessage]
    sequence_number: int  # latest sequenced number at time of nack
    code: int
    type: NackErrorType
    message: str = ""
    retry_after_seconds: Optional[float] = None
    # admission-shed nacks: how long the client should back off before
    # resubmitting this op (jittered client-side by the network client)
    retry_after_ms: Optional[int] = None


@dataclass(slots=True)
class Signal:
    """Transient, un-sequenced message relayed to all clients.

    Ref: protocol-definitions ISignalMessage; alfred submitSignal relay
    (lambdas/src/alfred/index.ts:405).
    """

    client_id: Optional[str]
    type: str
    content: Any = None
