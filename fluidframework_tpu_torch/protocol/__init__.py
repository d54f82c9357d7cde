"""Protocol types of the port (JAX counterpart: ``fluidframework_tpu/protocol``,
whose names this package exports alike)."""

from .consensus import (
    ClientDetails,
    ProposalState,
    QuorumProposal,
    SequencedClient,
)
from .messages import (
    UNASSIGNED_SEQ,
    UNIVERSAL_SEQ,
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedDocumentMessage,
    Signal,
    TraceHop,
)
from .quorum import ProtocolOpHandler, Quorum
from .summary import (
    SummaryAttachment,
    SummaryBlob,
    SummaryHandle,
    SummaryObject,
    SummaryTree,
    SummaryType,
)

__all__ = [
    "UNASSIGNED_SEQ",
    "UNIVERSAL_SEQ",
    "ClientDetails",
    "DocumentMessage",
    "MessageType",
    "Nack",
    "NackErrorType",
    "ProposalState",
    "ProtocolOpHandler",
    "Quorum",
    "QuorumProposal",
    "SequencedClient",
    "SequencedDocumentMessage",
    "Signal",
    "SummaryAttachment",
    "SummaryBlob",
    "SummaryHandle",
    "SummaryObject",
    "SummaryTree",
    "SummaryType",
    "TraceHop",
]
