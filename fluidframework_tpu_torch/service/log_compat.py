"""Legacy JSON durable-record codec — the storage tier's compat shim.

JAX counterpart: ``fluidframework_tpu/service/log_compat.py``; the port's
copy, imports rebased to this package.

Every record shape the durable log ever persisted before the columnar
segment store decodes through here: tag-wrapped JSON structures
(``_wrap``/``_unwrap``) and the 0xFF binary kinds whose header is a JSON
list. New code paths append columnar segment blocks (protocol/binwire
``encode_seg_block``) and never call this module; the hot storage modules
(``durable_log``, ``segment_store``, ``native/oplog``) keep
``json.dumps``/``json.loads`` out of their own code — this shim is the
one home of the JSON codec, and callers count every trip through it under
the ``storage.log.legacy_json`` deprecation counter.
"""

from __future__ import annotations

import json
from typing import Any

from ..protocol.serialization import message_from_dict, message_to_dict

_TAG_MSG = "_msg"  # a wrapped protocol message
_TAG_ESC = "_esc"  # an escaped user dict that contained a tag key


def _wrap(value: Any) -> Any:
    """Recursively tag protocol messages / escape colliding user dicts."""
    if isinstance(value, dict):
        out = {k: _wrap(v) for k, v in value.items()}
        if _TAG_MSG in out or _TAG_ESC in out:
            return {_TAG_ESC: out}
        return out
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return {_TAG_MSG: message_to_dict(value)}


def _unwrap(value: Any) -> Any:
    if isinstance(value, dict):
        if _TAG_MSG in value and len(value) == 1:
            return message_from_dict(value[_TAG_MSG])
        if _TAG_ESC in value and len(value) == 1:
            return {k: _unwrap(v) for k, v in value[_TAG_ESC].items()}
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def encode_json_value(value: Any) -> bytes:
    """The frozen legacy record encoding (tag-wrapped compact JSON)."""
    return json.dumps(_wrap(value), separators=(",", ":")).encode()


def decode_json_value(data: bytes) -> Any:
    return _unwrap(json.loads(data.decode()))


def abox_header_bytes(box) -> bytes:
    """JSON header of the legacy 0xFF boxcar record kinds (1/2)."""
    return json.dumps(
        [box.tenant_id, box.document_id, box.client_id, box.ds_id,
         box.channel_id, box.timestamp, int(box.n), box.props],
        separators=(",", ":")).encode()


def abox_header_from(data: bytes) -> list:
    return json.loads(data.decode())
