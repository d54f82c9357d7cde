"""Operation message types the replica farm and its oracle read.

The server assigns each client-submitted op a position in a single total
order per document, producing a :class:`SequencedDocumentMessage`; all
merge logic downstream is a deterministic function of that sequenced
stream.

JAX counterpart: ``fluidframework_tpu/protocol/messages.py``. This is a
copy of the part the port needs (``UNASSIGNED_SEQ``, ``UNIVERSAL_SEQ``,
``MessageType``, ``SequencedDocumentMessage``); the client-side message,
nack, signal and trace types wait for the port of the host layers.

Ref: protocol-definitions/src/protocol.ts:6-160 (MessageType,
ISequencedDocumentMessage).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

# Sequence number sentinels. A local, not-yet-acked op carries
# UNASSIGNED_SEQ; it compares as "newer than everything" in perspective
# checks, which keeps every visibility rule a plain integer comparison.
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


@dataclass(slots=True)
class SequencedDocumentMessage:
    """Server → client message: an op with its place in the total order.

    Carries the assigned ``sequence_number``, the document-wide
    ``minimum_sequence_number`` (the collaboration-window floor: every
    connected client has seen at least this far), and echoes of the
    client-side numbers.
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
    traces: list = field(default_factory=list)
