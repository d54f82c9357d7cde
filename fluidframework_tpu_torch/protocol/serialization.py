"""Wire serialization for protocol messages (JSON).

JAX counterpart: ``fluidframework_tpu/protocol/serialization.py``; the port's copy,
imports rebased to this package.

One canonical encoding shared by the durable native log, the network
front end, and the replay tooling — the analog of the reference's JSON
socket/Kafka payloads (protocol-definitions types are the schema).
"""

from __future__ import annotations

import json
from typing import Any

from .messages import (
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedDocumentMessage,
    Signal,
    TraceHop,
)

_KINDS = {
    "doc": DocumentMessage,
    "seq": SequencedDocumentMessage,
    "nack": Nack,
    "signal": Signal,
}
# custom codecs for types outside protocol.messages (e.g. service
# RawMessage): kind → (cls, to_dict, from_dict)
_CUSTOM: dict[str, tuple] = {}


def register_message_type(kind: str, cls: type, to_dict, from_dict) -> None:
    _CUSTOM[kind] = (cls, to_dict, from_dict)


# Hand-rolled encoders: ``dataclasses.asdict`` recursed into (and
# deep-copied) every ``contents`` payload, and was the front end's
# second-largest CPU cost under load. Payload dicts are shared by
# reference — encoders feed json.dumps immediately and nothing mutates
# wire dicts.

def _hop_dicts(traces) -> list[dict]:
    return [
        {"service": t.service, "action": t.action, "timestamp": t.timestamp}
        for t in traces
    ]


def _doc_fields(m: DocumentMessage) -> dict:
    return {
        "client_sequence_number": m.client_sequence_number,
        "reference_sequence_number": m.reference_sequence_number,
        "type": m.type,
        "contents": m.contents,
        "metadata": m.metadata,
        "traces": _hop_dicts(m.traces),
    }


_ENCODERS = {
    DocumentMessage: lambda m: dict(_doc_fields(m), _kind="doc"),
    SequencedDocumentMessage: lambda m: {
        "_kind": "seq",
        "client_id": m.client_id,
        "sequence_number": m.sequence_number,
        "minimum_sequence_number": m.minimum_sequence_number,
        "client_sequence_number": m.client_sequence_number,
        "reference_sequence_number": m.reference_sequence_number,
        "type": m.type,
        "contents": m.contents,
        "metadata": m.metadata,
        "origin": m.origin,
        "timestamp": m.timestamp,
        "traces": _hop_dicts(m.traces),
    },
    Nack: lambda m: {
        "_kind": "nack",
        "operation": None if m.operation is None
        else _doc_fields(m.operation),
        "sequence_number": m.sequence_number,
        "code": m.code,
        "type": m.type,
        "message": m.message,
        "retry_after_seconds": m.retry_after_seconds,
        # omitted when unset: pre-overload-control nacks must stay
        # byte-identical (format freeze, tests/test_compat.py)
        **({} if m.retry_after_ms is None
           else {"retry_after_ms": m.retry_after_ms}),
    },
    Signal: lambda m: {
        "_kind": "signal",
        "client_id": m.client_id,
        "type": m.type,
        "content": m.content,
    },
}


def message_to_dict(msg: Any) -> dict:
    enc = _ENCODERS.get(type(msg))
    if enc is not None:
        return enc(msg)
    for kind, (cls, to_dict, _) in _CUSTOM.items():
        if isinstance(msg, cls):
            return dict(to_dict(msg), _kind=kind)
    raise TypeError(f"unknown message type {type(msg)!r}")


def message_from_dict(d: dict) -> Any:
    d = dict(d)
    kind = d.pop("_kind")
    if kind in _CUSTOM:
        return _CUSTOM[kind][2](d)
    cls = _KINDS[kind]
    if "traces" in d:
        d["traces"] = [TraceHop(**t) for t in d["traces"]]
    if "type" in d:
        d["type"] = (
            NackErrorType(d["type"]) if kind == "nack"
            else d["type"] if kind == "signal"
            else MessageType(d["type"])
        )
    if kind == "nack" and d.get("operation") is not None:
        op = dict(d["operation"])
        op["type"] = MessageType(op["type"])
        op["traces"] = [TraceHop(**t) for t in op.get("traces", [])]
        d["operation"] = DocumentMessage(**op)
    return cls(**d)


def encode_message(msg: Any) -> bytes:
    return json.dumps(message_to_dict(msg), separators=(",", ":")).encode()


def decode_message(data: bytes) -> Any:
    return message_from_dict(json.loads(data.decode()))
