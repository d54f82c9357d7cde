"""Array-native boxcars: a client's boxcar of text ops as arrays.

JAX counterpart: ``fluidframework_tpu/service/array_batch.py``
(``ArrayBoxcar``, ``SequencedArrayBatch``). This is a copy of those two
classes with ``to_raw_boxcar``, the bridge into deli's ``RawBoxcar``. The
binwire column cache (``wire_cols``) waits for the network front end, and
the durable-log codec for the checkpoint slice (ROADMAP A4).

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

    @property
    def n(self) -> int:
        return self.boxcar.n

    @property
    def last_seq(self) -> int:
        return self.base_seq + self.n - 1

    @property
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
