"""Wire-op streams made from ``ops/opgen.py`` rows, for driving an applier.

``generate_doc_ops`` yields device op rows (seq, refSeq = seq - 1, msn,
client, positions within the visible length). An applier ingests the
service's sequenced wire ops instead, so these helpers turn one doc's rows
into (sequenced message, wire op) pairs for ``ingest_batch`` or into
``SequencedArrayBatch`` boxcars for ``ingest_array_batch``. Insert text is
drawn from the caller's numpy generator; annotate key ``k`` becomes the
prop key ``"k<k>"``. (The service path's own streams come from
``service/load_gen.run_inproc``.)
"""

from __future__ import annotations

import numpy as np

from ..ops.apply import (
    F_CLIENT,
    F_END,
    F_KEY,
    F_MSN,
    F_POS,
    F_REFSEQ,
    F_SEQ,
    F_TLEN,
    F_TYPE,
    F_VAL,
    OP_ANNOTATE,
    OP_INSERT,
    OP_REMOVE,
)
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..service.array_batch import ArrayBoxcar, SequencedArrayBatch

_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _texts(rows: np.ndarray, rng: np.random.Generator) -> list:
    """Insert payload of every row ("" for non-inserts)."""
    lens = np.where(rows[:, F_TYPE] == OP_INSERT, rows[:, F_TLEN], 0)
    chars = _LETTERS[rng.integers(0, len(_LETTERS), int(lens.sum()))]
    ends = np.cumsum(lens)
    return ["".join(chars[e - n:e]) for n, e in zip(lens, ends)]


def _wire_op(row: np.ndarray, text: str) -> dict:
    typ = int(row[F_TYPE])
    if typ == OP_INSERT:
        return {"type": 0, "pos": int(row[F_POS]), "text": text}
    if typ == OP_REMOVE:
        return {"type": 1, "start": int(row[F_POS]), "end": int(row[F_END])}
    if typ == OP_ANNOTATE:
        return {"type": 2, "start": int(row[F_POS]), "end": int(row[F_END]),
                "props": {f"k{int(row[F_KEY])}": int(row[F_VAL])}}
    raise ValueError(f"no wire op for device op type {typ}")


def wire_pairs(rows: np.ndarray, rng: np.random.Generator) -> list:
    """One doc's op rows as (SequencedDocumentMessage, wire op) pairs;
    client ``c`` becomes the wire client id ``"c<c>"``."""
    return [
        (SequencedDocumentMessage(
            client_id=f"c{int(row[F_CLIENT])}",
            sequence_number=int(row[F_SEQ]),
            minimum_sequence_number=int(row[F_MSN]),
            client_sequence_number=k + 1,
            reference_sequence_number=int(row[F_REFSEQ]),
            type=MessageType.OPERATION,
            contents=None),
         _wire_op(row, text))
        for k, (row, text) in enumerate(zip(rows, _texts(rows, rng)))
    ]


def array_batches(rows: np.ndarray, rng: np.random.Generator,
                  tenant_id: str, document_id: str,
                  max_boxcar: int = 16) -> list:
    """One doc's op rows as SequencedArrayBatch boxcars: each boxcar is a
    run of consecutive ops of one client, at most ``max_boxcar`` long."""
    texts = _texts(rows, rng)
    out = []
    start = 0
    while start < len(rows):
        end = start + 1
        while (end < len(rows) and end - start < max_boxcar
               and rows[end, F_CLIENT] == rows[start, F_CLIENT]):
            end += 1
        part = rows[start:end]
        n = end - start
        lens = [len(t) for t in texts[start:end]]
        is_ann = part[:, F_TYPE] == OP_ANNOTATE
        props = ([({f"k{int(r[F_KEY])}": int(r[F_VAL])} if a else None)
                  for r, a in zip(part, is_ann)] if is_ann.any() else None)
        box = ArrayBoxcar(
            tenant_id=tenant_id, document_id=document_id,
            client_id=f"c{int(part[0, F_CLIENT])}", ds_id="default",
            channel_id="text",
            kind=(part[:, F_TYPE] - 1).astype(np.int8),
            a=part[:, F_POS].astype(np.int32),
            b=np.where(part[:, F_TYPE] == OP_INSERT, 0,
                       part[:, F_END]).astype(np.int32),
            cseq=np.arange(start + 1, end + 1, dtype=np.int32),
            rseq=part[:, F_REFSEQ].astype(np.int32),
            text="".join(texts[start:end]),
            text_off=np.concatenate([[0], np.cumsum(lens)]).astype(np.int32),
            props=props)
        out.append(SequencedArrayBatch(
            boxcar=box, base_seq=int(part[0, F_SEQ]),
            msns=part[:, F_MSN].astype(np.int64), timestamp=0.0))
        start = end
    return out
