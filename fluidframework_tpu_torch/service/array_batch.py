"""Array-native boxcars: a client's boxcar of text ops as arrays.

JAX counterpart: ``fluidframework_tpu/service/array_batch.py``
(``ArrayBoxcar``, ``SequencedArrayBatch``, the ``abox``/``abatch``
durable-log codecs). This is a copy of those two classes with
``to_raw_boxcar``, the bridge into deli's ``RawBoxcar``, the binwire
column cache (``wire_cols``) the durable log's segment blocks reuse, and
the codecs registered with ``protocol.serialization``.

A client's submitted boxcar of merge-tree text ops rides the pipeline as
structure-of-arrays — int32 fields plus one concatenated text blob — so
the applier bulk-loads it into device staging without touching a per-op
dict, and only cold consumers materialise per-op message objects.

Op kinds (matching the merge-tree wire ops):

- 0 insert:   a = pos;   text run in ``text[text_off[i]:text_off[i+1]]``
- 1 remove:   a = start, b = end
- 2 annotate: a = start, b = end, props in ``props[i]``
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
)

KIND_INSERT = 0
KIND_REMOVE = 1
KIND_ANNOTATE = 2


@dataclass
class ArrayBoxcar:
    """One client's submitted boxcar of text chanops, SoA form.

    All ops target ONE channel (``ds_id``/``channel_id``)."""

    tenant_id: str
    document_id: str
    client_id: str
    ds_id: str
    channel_id: str
    kind: np.ndarray      # int8 [n]
    a: np.ndarray         # int32 [n] pos/start
    b: np.ndarray         # int32 [n] end (removes/annotates)
    cseq: np.ndarray      # int32 [n]
    rseq: np.ndarray      # int32 [n]
    text: str             # concatenated insert payloads
    text_off: np.ndarray  # int32 [n+1] offsets into text (non-inserts 0-len)
    props: Optional[list] = None  # per-op props dict or None (annotates)
    timestamp: float = 0.0
    # raw binwire column section the boxcar was encoded as, memoized by
    # the durable log (one encode serves the rawops record and the deltas
    # block). Transport cache only — deliberately OUTSIDE the durable
    # codecs below (a replayed boxcar re-encodes on demand).
    wire_cols: Optional[bytes] = field(default=None, repr=False,
                                       compare=False)
    # accumulated trace hops [(hop_id, ts), ...] (sampled boxcars only;
    # None when tracing is unarmed). Each tier APPENDS its hop in place.
    # Transport-only: deliberately outside any durable codec.
    hops: Optional[list] = field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return len(self.kind)

    def wire_op(self, i: int) -> dict:
        k = int(self.kind[i])
        if k == KIND_INSERT:
            return {"type": 0, "pos": int(self.a[i]),
                    "text": self.text[int(self.text_off[i]):
                                      int(self.text_off[i + 1])]}
        if k == KIND_REMOVE:
            return {"type": 1, "start": int(self.a[i]), "end": int(self.b[i])}
        return {"type": 2, "start": int(self.a[i]), "end": int(self.b[i]),
                "props": dict(self.props[i]) if self.props else {}}

    def contents(self, i: int) -> dict:
        return {"kind": "chanop", "address": self.ds_id,
                "contents": {"address": self.channel_id,
                             "contents": self.wire_op(i)}}

    def to_raw_boxcar(self):
        """The exactly-equivalent dict boxcar (deli scalar fallback)."""
        from .deli import RawBoxcar

        ops = [
            DocumentMessage(
                client_sequence_number=int(self.cseq[i]),
                reference_sequence_number=int(self.rseq[i]),
                type=MessageType.OPERATION,
                contents=self.contents(i))
            for i in range(self.n)
        ]
        return RawBoxcar(tenant_id=self.tenant_id,
                         document_id=self.document_id,
                         client_id=self.client_id, ops=ops,
                         timestamp=self.timestamp)


@dataclass
class SequencedArrayBatch:
    """A ticketed ArrayBoxcar: seqs are ``base_seq + i``; per-op msns.

    ``messages()`` materialises (and caches) the per-op
    SequencedDocumentMessage list for cold consumers."""

    boxcar: ArrayBoxcar
    base_seq: int         # seq of op 0
    msns: np.ndarray      # int64 [n]
    timestamp: float
    _materialized: Optional[list] = field(default=None, repr=False)

    # a batch is not changed once made, and every subscriber of a
    # broadcast reads these: each is computed once, then an attribute

    @cached_property
    def n(self) -> int:
        return self.boxcar.n

    @cached_property
    def last_seq(self) -> int:
        return self.base_seq + self.n - 1

    @cached_property
    def last_msn(self) -> int:
        return int(self.msns[-1])

    def message(self, i: int) -> SequencedDocumentMessage:
        if self._materialized is not None:
            return self._materialized[i]
        box = self.boxcar
        return SequencedDocumentMessage(
            client_id=box.client_id,
            sequence_number=self.base_seq + i,
            minimum_sequence_number=int(self.msns[i]),
            client_sequence_number=int(box.cseq[i]),
            reference_sequence_number=int(box.rseq[i]),
            type=MessageType.OPERATION,
            contents=box.contents(i),
            timestamp=self.timestamp,
        )

    def messages(self) -> list:
        if self._materialized is None:
            self._materialized = [self.message(i) for i in range(self.n)]
        return self._materialized


# ------------------------------------------------------- durable-log codec
# Array fields serialize as base64 of their little-endian bytes —
# json-encoding an int list costs ~10× a b64encode of the same data,
# and these records ARE the durable hot path in the split deployment.

import base64 as _b64  # noqa: E402


def _enc(arr: np.ndarray) -> str:
    return _b64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _dec(s: str, dtype) -> np.ndarray:
    return np.frombuffer(_b64.b64decode(s), dtype=dtype)


def _boxcar_to_dict(box: ArrayBoxcar) -> dict:
    return {
        "tenant_id": box.tenant_id, "document_id": box.document_id,
        "client_id": box.client_id, "ds": box.ds_id, "ch": box.channel_id,
        "kind": _enc(box.kind), "a": _enc(box.a), "b": _enc(box.b),
        "cseq": _enc(box.cseq), "rseq": _enc(box.rseq),
        "text": box.text, "text_off": _enc(box.text_off),
        "props": box.props, "timestamp": box.timestamp,
    }


def _boxcar_from_dict(d: dict) -> ArrayBoxcar:
    return ArrayBoxcar(
        tenant_id=d["tenant_id"], document_id=d["document_id"],
        client_id=d["client_id"], ds_id=d["ds"], channel_id=d["ch"],
        kind=_dec(d["kind"], np.int8),
        a=_dec(d["a"], np.int32), b=_dec(d["b"], np.int32),
        cseq=_dec(d["cseq"], np.int32),
        rseq=_dec(d["rseq"], np.int32),
        text=d["text"], text_off=_dec(d["text_off"], np.int32),
        props=d.get("props"), timestamp=d["timestamp"],
    )


def _abatch_to_dict(batch: SequencedArrayBatch) -> dict:
    return {
        "boxcar": _boxcar_to_dict(batch.boxcar),
        "base_seq": batch.base_seq,
        "msns": _enc(batch.msns),
        "timestamp": batch.timestamp,
    }


def _abatch_from_dict(d: dict) -> SequencedArrayBatch:
    return SequencedArrayBatch(
        boxcar=_boxcar_from_dict(d["boxcar"]), base_seq=d["base_seq"],
        msns=_dec(d["msns"], np.int64), timestamp=d["timestamp"],
    )


def _register_codecs() -> None:
    from ..protocol.serialization import register_message_type

    register_message_type("abox", ArrayBoxcar, _boxcar_to_dict,
                          _boxcar_from_dict)
    register_message_type("abatch", SequencedArrayBatch, _abatch_to_dict,
                          _abatch_from_dict)


_register_codecs()
