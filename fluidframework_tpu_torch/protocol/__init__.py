"""Protocol types of the port (JAX counterpart: ``fluidframework_tpu/protocol``)."""

from .messages import (
    UNASSIGNED_SEQ,
    UNIVERSAL_SEQ,
    MessageType,
    SequencedDocumentMessage,
)

__all__ = [
    "UNASSIGNED_SEQ",
    "UNIVERSAL_SEQ",
    "MessageType",
    "SequencedDocumentMessage",
]
