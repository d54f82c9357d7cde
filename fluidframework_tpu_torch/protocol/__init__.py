"""Protocol types of the port (JAX counterpart: ``fluidframework_tpu/protocol``)."""

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

__all__ = [
    "UNASSIGNED_SEQ",
    "UNIVERSAL_SEQ",
    "DocumentMessage",
    "MessageType",
    "Nack",
    "NackErrorType",
    "SequencedDocumentMessage",
    "Signal",
    "TraceHop",
]
