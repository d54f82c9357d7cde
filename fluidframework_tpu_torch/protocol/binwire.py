"""Binary wire codec for the HOT frames of the socket protocol.

JAX counterpart: ``fluidframework_tpu/protocol/binwire.py``; the port's
copy, imports rebased to this package. The durable log uses its columnar
section (``encode_cols``, ``_read_cols``, ``encode_seg_block``,
``read_seg_block``, ``SEG_COLS``, ``SEG_JSON``); the network tier (front
end, gateway, network driver, socket load) uses the rest, the FT_HISTORY
commit frames of the history doors included.

Ref: the reference ships every socket payload as JSON over socket.io
(driver-base/src/documentDeltaConnection.ts:53, alfred index.ts:310);
at the measured knee the front end spent its whole budget in
per-frame ``json.loads``/``dumps`` (submit→deli p99 5.3 ms of 5.9 total).
SURVEY §2.9 prescribes a binary front end for exactly this reason. This
module is the TPU-first answer: the two frames that carry the op volume
(client submit boxcars and sequenced broadcast batches) get a
struct-packed encoding; everything else (connect, signals, storage RPCs)
stays JSON.

Frame discrimination needs no negotiation on the READ side: JSON bodies
start with ``{`` (0x7B), binary bodies with MAGIC (0x01). The 4-byte
length header is shared with the JSON framing (front_end.py docstring).

Layout (all integers big-endian):

    body   := MAGIC ftype hdr(ftype) batch
    MAGIC  := 0x01
    ftype  := 1 submit | 2 ops | 3 fsubmit | 4 fops
            | 5 cols_submit | 6 cols_fsubmit | 7 cols_ops | 8 cols_fops
    hdr    := ""                       (submit, ops, cols_submit, cols_ops)
            | u32 sid                  (fsubmit, cols_fsubmit)
            | u16 len + utf8 topic     (fops, cols_fops)
    batch  := pool recs
    pool   := u16 n; n × (u16 len + utf8)     -- interned strings
    recs   := u16 n; n × rec

The batch section is IDENTICAL across the four frame types — that is the
load-bearing property: a gateway converts a client ``submit`` into an
upstream ``fsubmit`` by prepending 6 bytes to the received body, and a
core ``fops`` into a client ``ops`` by slicing the topic header off,
relaying op payloads it never decodes (gateway.py).

rec (submit: DocumentMessage):

    i32 cseq, i32 rseq, traces, u8 kind, payload(kind)

rec (ops: SequencedDocumentMessage):

    u16 client_id_idx (0xFFFF = None), i64 seq, i64 msn,
    i32 cseq, i32 rseq, f64 timestamp, traces, u8 kind, payload(kind)

    traces := u8 n; n × (u16 svc_idx, u16 act_idx, f64 ts)

kind encodes the merge-tree chanop fast path — the envelope
``{"kind": "chanop", "address": ds, "contents": {"address": ch,
"contents": op}}`` (runtime/datastore.py wire shape) collapses to
interned addresses + fixed fields:

    0 insert   := u16 ds_idx, u16 ch_idx, u32 pos, u16 len + utf8 text
    1 remove   := u16 ds_idx, u16 ch_idx, u32 start, u32 end
    2 annotate := u16 ds_idx, u16 ch_idx, u32 start, u32 end,
                  u16 len + utf8 props-JSON
    255 generic:= u32 len + utf8 JSON of the non-fixed message fields
                  ({type, contents, metadata[, origin]}) — ANY message
                  round-trips; the fast kinds are an optimization, not a
                  constraint (test_binwire fuzzes both against the JSON
                  codec for equality).
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from ..utils.telemetry import HOP_SERVICE_ACTION
from .messages import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
    Signal,
    TraceHop,
)

MAGIC = 0x01
FT_SUBMIT = 1
FT_OPS = 2
FT_FSUBMIT = 3
FT_FOPS = 4
FT_COLS_SUBMIT = 5
FT_COLS_FSUBMIT = 6
FT_COLS_OPS = 7
FT_COLS_FOPS = 8
FT_COLS_DELTAS = 9
FT_COLS_SNAP = 10
FT_PRESENCE = 11
FT_FPRESENCE = 12
FT_HISTORY = 13

_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_DOC_FIXED = struct.Struct(">ii")           # cseq, rseq
_SEQ_FIXED = struct.Struct(">Hqqiid")       # cid_idx, seq, msn, cseq, rseq, ts
_TRACE = struct.Struct(">HHd")              # svc_idx, act_idx, ts
_INS_HDR = struct.Struct(">HHI")            # ds, ch, pos
_SPAN = struct.Struct(">HHII")              # ds, ch, start, end
_FSUB_HDR = struct.Struct(">BBI")           # magic, ftype, sid
_HOP = struct.Struct(">Bd")                 # hoptail entry: hop id, unix ts

_NONE_IDX = 0xFFFF
_MAX_U32 = 0xFFFFFFFF

_OP_TYPE = MessageType.OPERATION


class _Pool:
    """Build-side string interner for the frame's string pool."""

    __slots__ = ("idx", "items")

    def __init__(self):
        self.idx: dict[str, int] = {}
        self.items: list[bytes] = []

    def add(self, s: str) -> int:
        i = self.idx.get(s)
        if i is None:
            i = len(self.items)
            if i >= _NONE_IDX:
                raise ValueError("string pool overflow")
            self.idx[s] = i
            self.items.append(s.encode())
        return i

    def dump(self) -> bytes:
        out = [_U16.pack(len(self.items))]
        for b in self.items:
            out.append(_U16.pack(len(b)))
            out.append(b)
        return b"".join(out)


def _chanop_parts(contents) -> Optional[tuple]:
    """(ds, ch, op) if contents is a plain chanop envelope, else None."""
    if type(contents) is not dict or contents.get("kind") != "chanop":
        return None
    ds = contents.get("address")
    inner = contents.get("contents")
    if (type(ds) is not str or type(inner) is not dict
            or len(contents) != 3 or len(inner) != 2):
        return None
    ch = inner.get("address")
    op = inner.get("contents")
    if type(ch) is not str or type(op) is not dict:
        return None
    return ds, ch, op


def _u32_ok(*vals) -> bool:
    for v in vals:
        if type(v) is not int or v < 0 or v > _MAX_U32:
            return False
    return True


def _encode_payload(pool: _Pool, out: list, type_, contents, metadata,
                    origin=None) -> None:
    """Append ``u8 kind + payload`` for one message's variable part."""
    if type_ is _OP_TYPE and metadata is None and origin is None:
        parts = _chanop_parts(contents)
        if parts is not None:
            ds, ch, op = parts
            t = op.get("type")
            if t == 0 and len(op) == 3:
                text = op.get("text")
                pos = op.get("pos")
                if type(text) is str and _u32_ok(pos):
                    tb = text.encode()
                    if len(tb) <= 0xFFFF:
                        out.append(b"\x00")
                        out.append(_INS_HDR.pack(pool.add(ds), pool.add(ch),
                                                 pos))
                        out.append(_U16.pack(len(tb)))
                        out.append(tb)
                        return
            elif t == 1 and len(op) == 3:
                start, end = op.get("start"), op.get("end")
                if _u32_ok(start, end):
                    out.append(b"\x01")
                    out.append(_SPAN.pack(pool.add(ds), pool.add(ch),
                                          start, end))
                    return
            elif t == 2 and len(op) == 4 and type(op.get("props")) is dict:
                start, end = op.get("start"), op.get("end")
                if _u32_ok(start, end):
                    pb = json.dumps(op["props"],
                                    separators=(",", ":")).encode()
                    if len(pb) <= 0xFFFF:
                        out.append(b"\x02")
                        out.append(_SPAN.pack(pool.add(ds), pool.add(ch),
                                              start, end))
                        out.append(_U16.pack(len(pb)))
                        out.append(pb)
                        return
    # generic fallback: the non-fixed fields as JSON
    d = {"type": type_, "contents": contents, "metadata": metadata}
    if origin is not None:
        d["origin"] = origin
    gb = json.dumps(d, separators=(",", ":")).encode()
    out.append(b"\xff")
    out.append(_U32.pack(len(gb)))
    out.append(gb)


def _encode_traces(pool: _Pool, out: list, traces) -> None:
    n = len(traces)
    if n > 0xFF:  # absurd, but stay correct
        traces = traces[-0xFF:]
        n = 0xFF
    out.append(bytes((n,)))
    for t in traces:
        out.append(_TRACE.pack(pool.add(t.service), pool.add(t.action),
                               t.timestamp))


def encode_submit(ops: list[DocumentMessage], *, sid: Optional[int] = None,
                  ) -> bytes:
    """Encode a submit boxcar body (``fsubmit`` when ``sid`` is given)."""
    pool = _Pool()
    recs: list = [_U16.pack(len(ops))]
    for m in ops:
        recs.append(_DOC_FIXED.pack(m.client_sequence_number,
                                    m.reference_sequence_number))
        _encode_traces(pool, recs, m.traces)
        _encode_payload(pool, recs, m.type, m.contents, m.metadata)
    hdr = (bytes((MAGIC, FT_SUBMIT)) if sid is None
           else _FSUB_HDR.pack(MAGIC, FT_FSUBMIT, sid))
    return hdr + pool.dump() + b"".join(recs)


def encode_ops(msgs: list[SequencedDocumentMessage], *,
               topic: Optional[str] = None) -> bytes:
    """Encode a sequenced broadcast batch body (``fops`` with a topic)."""
    pool = _Pool()
    recs: list = [_U16.pack(len(msgs))]
    for m in msgs:
        cid = m.client_id
        recs.append(_SEQ_FIXED.pack(
            _NONE_IDX if cid is None else pool.add(cid),
            m.sequence_number, m.minimum_sequence_number,
            m.client_sequence_number, m.reference_sequence_number,
            m.timestamp))
        _encode_traces(pool, recs, m.traces)
        _encode_payload(pool, recs, m.type, m.contents, m.metadata, m.origin)
    if topic is None:
        hdr = bytes((MAGIC, FT_OPS))
    else:
        tb = topic.encode()
        hdr = bytes((MAGIC, FT_FOPS)) + _U16.pack(len(tb)) + tb
    return hdr + pool.dump() + b"".join(recs)


# ---------------------------------------------------------------- decoding


def _read_pool(body: bytes, off: int) -> tuple[list[str], int]:
    (n,) = _U16.unpack_from(body, off)
    off += 2
    pool = []
    for _ in range(n):
        (ln,) = _U16.unpack_from(body, off)
        off += 2
        pool.append(body[off:off + ln].decode())
        off += ln
    return pool, off


def _read_traces(body: bytes, off: int, pool: list[str]
                 ) -> tuple[list[TraceHop], int]:
    n = body[off]
    off += 1
    traces = []
    for _ in range(n):
        svc, act, ts = _TRACE.unpack_from(body, off)
        off += _TRACE.size
        traces.append(TraceHop(service=pool[svc], action=pool[act],
                               timestamp=ts))
    return traces, off


def _read_payload(body: bytes, off: int, pool: list[str]) -> tuple:
    """Returns (type, contents, metadata, origin, new_off)."""
    kind = body[off]
    off += 1
    if kind == 0:
        ds, ch, pos = _INS_HDR.unpack_from(body, off)
        off += _INS_HDR.size
        (ln,) = _U16.unpack_from(body, off)
        off += 2
        text = body[off:off + ln].decode()
        off += ln
        op = {"type": 0, "pos": pos, "text": text}
    elif kind == 1:
        ds, ch, start, end = _SPAN.unpack_from(body, off)
        off += _SPAN.size
        op = {"type": 1, "start": start, "end": end}
    elif kind == 2:
        ds, ch, start, end = _SPAN.unpack_from(body, off)
        off += _SPAN.size
        (ln,) = _U16.unpack_from(body, off)
        off += 2
        op = {"type": 2, "start": start, "end": end,
              "props": json.loads(body[off:off + ln])}
        off += ln
    elif kind == 0xFF:
        (ln,) = _U32.unpack_from(body, off)
        off += 4
        d = json.loads(body[off:off + ln])
        off += ln
        return (MessageType(d["type"]), d.get("contents"),
                d.get("metadata"), d.get("origin"), off)
    else:
        raise ValueError(f"unknown binwire payload kind {kind}")
    contents = {"kind": "chanop", "address": pool[ds],
                "contents": {"address": pool[ch], "contents": op}}
    return _OP_TYPE, contents, None, None, off


def decode_submit(body: bytes, with_spans: bool = False):
    """Decode a submit/fsubmit body → (sid or None, ops).

    With ``with_spans`` additionally returns a splice context the
    broadcast encoder can reuse (see :func:`encode_ops_spliced`):
    ``(sid, ops, spans_by_contents_id, pool_entries_blob, npool)`` —
    spans are the raw payload bytes (kind byte included) keyed by
    ``id(op.contents)``, valid while the decoded contents objects live."""
    ftype = body[1]
    if ftype == FT_FSUBMIT:
        (sid,) = _U32.unpack_from(body, 2)
        off = _FSUB_HDR.size
    else:
        sid, off = None, 2
    pool_start = off + 2
    pool, off = _read_pool(body, off)
    pool_blob = body[pool_start:off]
    (n,) = _U16.unpack_from(body, off)
    off += 2
    ops = []
    spans: dict[int, bytes] = {}
    for _ in range(n):
        cseq, rseq = _DOC_FIXED.unpack_from(body, off)
        off += _DOC_FIXED.size
        traces, off = _read_traces(body, off, pool)
        payload_start = off
        type_, contents, metadata, _, off = _read_payload(body, off, pool)
        op = DocumentMessage(
            client_sequence_number=cseq, reference_sequence_number=rseq,
            type=type_, contents=contents, metadata=metadata, traces=traces)
        ops.append(op)
        if with_spans and type(contents) is dict:
            # identity-keyed: safe ONLY for dicts — json.loads returns a
            # fresh dict per record (unique id while the ops are alive),
            # whereas interned payloads (small ints, bools, str) would
            # collide across records and splice the wrong bytes
            spans[id(contents)] = body[payload_start:off]
    if with_spans:
        return sid, ops, spans, pool_blob, len(pool)
    return sid, ops


def decode_ops(body: bytes) -> tuple[Optional[str],
                                     list[SequencedDocumentMessage]]:
    """Decode an ops/fops body → (topic or None, msgs)."""
    ftype = body[1]
    if ftype == FT_COLS_OPS or ftype == FT_COLS_FOPS:
        return decode_cols_ops(body)
    if ftype == FT_FOPS:
        (tl,) = _U16.unpack_from(body, 2)
        topic = body[4:4 + tl].decode()
        off = 4 + tl
    else:
        topic, off = None, 2
    pool, off = _read_pool(body, off)
    (n,) = _U16.unpack_from(body, off)
    off += 2
    msgs = []
    for _ in range(n):
        cid_idx, seq, msn, cseq, rseq, ts = _SEQ_FIXED.unpack_from(body, off)
        off += _SEQ_FIXED.size
        traces, off = _read_traces(body, off, pool)
        type_, contents, metadata, origin, off = _read_payload(body, off, pool)
        msgs.append(SequencedDocumentMessage(
            client_id=None if cid_idx == _NONE_IDX else pool[cid_idx],
            sequence_number=seq, minimum_sequence_number=msn,
            client_sequence_number=cseq, reference_sequence_number=rseq,
            type=type_, contents=contents, metadata=metadata, origin=origin,
            timestamp=ts, traces=traces))
    return topic, msgs


def encode_ops_spliced(msgs: list[SequencedDocumentMessage],
                       spans: dict[int, bytes], pool_blob: bytes,
                       npool: int, *,
                       topic: Optional[str] = None) -> Optional[bytes]:
    """Encode a broadcast batch by SPLICING the submitted payload bytes.

    The deli fast lane emits sequenced messages whose ``contents`` are
    the very objects the submit decode produced, so the broadcast frame
    can reuse the submit frame's payload bytes and string pool verbatim:
    per op only the fixed header and trace hops are packed fresh, and
    the payload — the bulk of the record — is a bytes copy. Returns
    None when any message's contents is not from the splice context
    (scalar-lane fallback, system messages): the caller then uses
    :func:`encode_ops`.
    """
    extra = _Pool()
    recs: list = [_U16.pack(len(msgs))]
    try:
        for m in msgs:
            span = spans.get(id(m.contents))
            if span is None or m.origin is not None:
                return None
            cid = m.client_id
            recs.append(_SEQ_FIXED.pack(
                _NONE_IDX if cid is None else npool + extra.add(cid),
                m.sequence_number, m.minimum_sequence_number,
                m.client_sequence_number, m.reference_sequence_number,
                m.timestamp))
            traces = m.traces
            n = len(traces)
            if n > 0xFF:
                traces = traces[-0xFF:]
                n = 0xFF
            recs.append(bytes((n,)))
            for t in traces:
                recs.append(_TRACE.pack(npool + extra.add(t.service),
                                        npool + extra.add(t.action),
                                        t.timestamp))
            recs.append(span)
        total = npool + len(extra.items)
        if total >= _NONE_IDX:
            return None
    except struct.error:
        return None
    if topic is None:
        hdr = bytes((MAGIC, FT_OPS))
    else:
        tb = topic.encode()
        hdr = bytes((MAGIC, FT_FOPS)) + _U16.pack(len(tb)) + tb
    pool_out = [_U16.pack(total), pool_blob]
    for b in extra.items:
        pool_out.append(_U16.pack(len(b)))
        pool_out.append(b)
    return hdr + b"".join(pool_out) + b"".join(recs)


def scan_ops(body: bytes):
    """Lightweight walk of an ops/fops body for load observers.

    Yields one tuple per record WITHOUT constructing message objects or
    contents dicts — the load worker's broadcast observer only needs op
    identity and the visible-length delta, and at the measured knee the
    full decode (dataclass + 3 nested dicts per op, times every
    subscriber) was the workers' largest CPU item:

        (client_id | None, seq, cseq, deli_ts | None, delta)

    ``delta`` is the op's visible-length change: +chars for an insert
    (ASCII payloads: byte length == char length — the synthetic load
    generator emits ASCII-only text), -span for a remove, 0 otherwise
    (annotate/generic). ``deli_ts`` is the last deli/sequence trace hop
    timestamp when the record carries one.

    Columnar batches (FT_COLS_OPS/FOPS) carry no per-record traces: the
    stamp timestamp IS the deli ticket time, so every record yields it
    as ``deli_ts`` — the hop split stays honest without trace bytes.
    """
    ftype = body[1]
    if ftype == FT_COLS_OPS or ftype == FT_COLS_FOPS:
        _, cid, base_seq, ts, sc, _msns, _hops = _read_cols_stamp(body)
        kind = sc.kind
        delta = np.where(
            kind == 0, np.diff(sc.text_off),
            np.where(kind == 1, sc.a - sc.b, 0)).tolist()
        for i, cseq in enumerate(sc.cseq.tolist()):
            yield cid, base_seq + i, cseq, ts, delta[i]
        return
    if ftype == FT_FOPS:
        (tl,) = _U16.unpack_from(body, 2)
        off = 4 + tl
    else:
        off = 2
    pool, off = _read_pool(body, off)
    deli_idx = None
    for i, s in enumerate(pool):
        if s == "deli":
            deli_idx = i
            break
    (n,) = _U16.unpack_from(body, off)
    off += 2
    for _ in range(n):
        cid_idx, seq, msn, cseq, rseq, ts = _SEQ_FIXED.unpack_from(body, off)
        off += _SEQ_FIXED.size
        ntr = body[off]
        off += 1
        deli_ts = None
        for _t in range(ntr):
            svc, act, hop_ts = _TRACE.unpack_from(body, off)
            off += _TRACE.size
            if svc == deli_idx:
                deli_ts = hop_ts
        kind = body[off]
        off += 1
        delta = 0
        if kind == 0:
            off += _INS_HDR.size
            (ln,) = _U16.unpack_from(body, off)
            off += 2 + ln
            delta = ln
        elif kind == 1:
            _, _, start, end = _SPAN.unpack_from(body, off)
            off += _SPAN.size
            delta = start - end
        elif kind == 2:
            off += _SPAN.size
            (ln,) = _U16.unpack_from(body, off)
            off += 2 + ln
        elif kind == 0xFF:
            (ln,) = _U32.unpack_from(body, off)
            off += 4 + ln
        else:
            raise ValueError(f"unknown binwire payload kind {kind}")
        yield (None if cid_idx == _NONE_IDX else pool[cid_idx],
               seq, cseq, deli_ts, delta)


# ------------------------------------------------------------- columnar
# Fixed-stride column frames: the zero-materialization ingress path.
#
# The rec-oriented frames above are variable-length per record, so the
# server must walk them op by op. The columnar family carries the SAME
# boxcar as packed SoA columns that ``np.frombuffer`` views in O(1),
# feeding deli's array lane without ever materializing per-op objects.
# A submit boxcar is columnar-eligible when every op is a canonical
# same-channel chanop (insert/remove/annotate, no metadata/traces) —
# exactly the shape the merge-tree runtime emits; anything else rides
# the rec frames unchanged.
#
# Layout (the column section is LITTLE-endian — a deliberate deviation
# from the big-endian rec frames so the columns are numpy-native views
# on LE hosts; outer headers stay big-endian so the gateway's 6-byte
# fsubmit prepend and u16-topic fops strip work byte-identically across
# both families):
#
#     body := MAGIC ftype hdr(ftype) section
#     ftype := 5 cols_submit | 6 cols_fsubmit | 7 cols_ops | 8 cols_fops
#     hdr   := ""                    (cols_submit, cols_ops)
#            | u32 sid               (cols_fsubmit, big-endian)
#            | u16 len + utf8 topic  (cols_fops, big-endian)
#     section(submit) := cols
#     section(ops)    := stamp cols n×i64 msns
#     stamp := u16 cid_len + utf8 client_id, i64 base_seq, f64 timestamp
#     cols  := u16 n, u16 ds_len + utf8, u16 ch_len + utf8,
#              n×u8 kind, n×i32 a, n×i32 b, n×i32 cseq, n×i32 rseq,
#              (n+1)×i32 text_off, u32 tlen + utf8 text,
#              u32 plen + utf8 props-JSON (plen 0 = no annotate props)
#
# ``a``/``b`` are pos/0 for inserts, start/end for removes/annotates;
# ``text_off`` are cumulative CHARACTER offsets into ``text`` (insert i
# owns text[text_off[i]:text_off[i+1]]). Record i's sequence number in a
# stamped frame is base_seq + i; the stamp timestamp is deli's ticket
# time for the whole batch (replaces per-record trace hops).
#
# Every cols-family body additionally ends in a hop trailer:
#
#     hoptail := k × (u8 hop_id, f64 ts)  u8 k      (big-endian)
#
# The count byte comes LAST so a relay tier appends its hop WITHOUT
# parsing any frame content: read body[-1], splice 9 bytes before it,
# bump the count (append_hop). Unsampled frames carry k = 0 — a single
# NUL byte — so the disarmed hot-path cost is one byte per frame. Hop
# ids index utils.telemetry.HOPS (the taxonomy's single source of
# truth). The trailer sits OUTSIDE the ``cols`` section, so the deli
# stamp splice and the encode-once fan-out caches never touch it.
#
# The load-bearing property: deli stamping is a byte SPLICE — the ops
# frame embeds the submit frame's ``cols`` bytes VERBATIM between the
# stamp and the appended msns, so the broadcast fan-out re-encodes
# nothing (see stamp_cols_ops and front_end._push_abatch).


class SubmitColumns:
    """Decoded column view of a columnar submit boxcar.

    The array fields are zero-copy ``np.frombuffer`` views into the
    received frame; ``cols`` is the raw column section (the splice
    input for :func:`stamp_cols_ops`).
    """

    __slots__ = ("ds_id", "channel_id", "kind", "a", "b", "cseq", "rseq",
                 "text", "text_off", "props", "cols")

    def __init__(self, ds_id, channel_id, kind, a, b, cseq, rseq,
                 text, text_off, props, cols):
        self.ds_id = ds_id
        self.channel_id = channel_id
        self.kind = kind
        self.a = a
        self.b = b
        self.cseq = cseq
        self.rseq = rseq
        self.text = text
        self.text_off = text_off
        self.props = props
        self.cols = cols

    @property
    def n(self) -> int:
        return len(self.kind)


def _i32_ok(*vals) -> bool:
    for v in vals:
        if type(v) is not int or v < 0 or v > 0x7FFFFFFF:
            return False
    return True


def encode_cols(ds_id: str, channel_id: str, kind, a, b, cseq, rseq,
                text: str, text_off, props) -> bytes:
    """Pack column arrays into the shared ``cols`` section."""
    n = len(kind)
    if not 0 < n <= 0xFFFF:
        raise ValueError(f"columnar boxcar size {n} out of range")
    dsb = ds_id.encode()
    chb = channel_id.encode()
    if len(dsb) > 0xFFFF or len(chb) > 0xFFFF:
        raise ValueError("address too long for columnar frame")
    tb = text.encode()
    pb = (b"" if props is None
          else json.dumps(props, separators=(",", ":")).encode())
    return b"".join((
        n.to_bytes(2, "little"),
        len(dsb).to_bytes(2, "little"), dsb,
        len(chb).to_bytes(2, "little"), chb,
        np.ascontiguousarray(kind, np.int8).tobytes(),
        np.ascontiguousarray(a, "<i4").tobytes(),
        np.ascontiguousarray(b, "<i4").tobytes(),
        np.ascontiguousarray(cseq, "<i4").tobytes(),
        np.ascontiguousarray(rseq, "<i4").tobytes(),
        np.ascontiguousarray(text_off, "<i4").tobytes(),
        len(tb).to_bytes(4, "little"), tb,
        len(pb).to_bytes(4, "little"), pb,
    ))


def _read_cols(body: bytes, off: int) -> tuple[SubmitColumns, int]:
    start = off
    n = int.from_bytes(body[off:off + 2], "little")
    off += 2
    if n == 0:
        raise ValueError("empty columnar boxcar")
    ln = int.from_bytes(body[off:off + 2], "little")
    off += 2
    ds = body[off:off + ln].decode()
    off += ln
    ln = int.from_bytes(body[off:off + 2], "little")
    off += 2
    ch = body[off:off + ln].decode()
    off += ln
    kind = np.frombuffer(body, np.int8, n, off)
    off += n
    a = np.frombuffer(body, "<i4", n, off)
    off += 4 * n
    b = np.frombuffer(body, "<i4", n, off)
    off += 4 * n
    cseq = np.frombuffer(body, "<i4", n, off)
    off += 4 * n
    rseq = np.frombuffer(body, "<i4", n, off)
    off += 4 * n
    text_off = np.frombuffer(body, "<i4", n + 1, off)
    off += 4 * (n + 1)
    tlen = int.from_bytes(body[off:off + 4], "little")
    off += 4
    text = body[off:off + tlen].decode()
    off += tlen
    plen = int.from_bytes(body[off:off + 4], "little")
    off += 4
    props = json.loads(body[off:off + plen]) if plen else None
    off += plen
    if off > len(body):
        raise ValueError("truncated columnar frame")
    return SubmitColumns(ds, ch, kind, a, b, cseq, rseq, text, text_off,
                         props, body[start:off]), off


def _hoptail(hops) -> bytes:
    """Pack an ordered [(hop_id, ts), ...] list as the trailing hoptail."""
    if not hops:
        return b"\x00"
    hops = hops[-0xFF:]
    return b"".join(_HOP.pack(int(h), float(t)) for h, t in hops) \
        + bytes((len(hops),))


def append_hop(body: bytes, hop_id: int, ts: float) -> bytes:
    """Splice one hop into a cols-family body's trailing hoptail.

    The relay-tier stamp: no frame content is parsed — the count byte
    at body[-1] moves back 9 bytes and increments. Full tails (255
    hops) drop the stamp rather than corrupt the frame.
    """
    k = body[-1]
    if k >= 0xFF:
        return body
    return b"".join((body[:-1], _HOP.pack(hop_id, ts), bytes((k + 1,))))


def read_hoptail(body: bytes, end: Optional[int] = None):
    """Parse the trailing hoptail → [(hop_id, ts), ...] in stamp order.

    ``end`` — the content end offset, when the caller just parsed the
    body — validates the trailer exactly. Without it the count byte is
    trusted but bounds-checked; inconsistent tails (frames predating
    the trailer in durable replays, chaos truncation) yield [] rather
    than raising.
    """
    if not body:
        return []
    k = body[-1]
    tail = 1 + k * _HOP.size
    if end is not None and len(body) - end != tail:
        return []
    off = len(body) - tail
    if off < 2:
        return []
    return [_HOP.unpack_from(body, off + i * _HOP.size) for i in range(k)]


def hops_to_traces(hops) -> list[TraceHop]:
    """Materialize hoptail entries as TraceHop objects (rec-frame shape)."""
    return [TraceHop(service=HOP_SERVICE_ACTION[h][0],
                     action=HOP_SERVICE_ACTION[h][1], timestamp=t)
            for h, t in hops if 0 <= h < len(HOP_SERVICE_ACTION)]


def encode_submit_columns(ops: list[DocumentMessage], *,
                          sid: Optional[int] = None) -> Optional[bytes]:
    """Encode a submit boxcar as a columnar frame, or None if ineligible.

    Eligibility mirrors :func:`_encode_payload`'s fast-kind strictness
    (canonical chanop dicts, i32-range positions, no metadata) plus the
    columnar constraints: one (ds, channel) per boxcar and no trace
    hops (the stamp timestamp replaces them). Callers fall back to
    :func:`encode_submit` on None — the rec path round-trips anything.
    """
    n = len(ops)
    if not 0 < n <= 0xFFFF:
        return None
    ds_id = ch_id = None
    kinds: list[int] = []
    av: list[int] = []
    bv: list[int] = []
    cs: list[int] = []
    rs: list[int] = []
    toff: list[int] = [0]
    texts: list[str] = []
    prs: list = []
    for m in ops:
        if m.type is not _OP_TYPE or m.metadata is not None or m.traces:
            return None
        parts = _chanop_parts(m.contents)
        if parts is None:
            return None
        ds, ch, op = parts
        if ds_id is None:
            ds_id, ch_id = ds, ch
        elif ds != ds_id or ch != ch_id:
            return None
        t = op.get("type")
        pr = None
        if t == 0 and len(op) == 3:
            pos, text = op.get("pos"), op.get("text")
            if type(text) is not str or not _i32_ok(pos):
                return None
            kinds.append(0)
            av.append(pos)
            bv.append(0)
            texts.append(text)
            toff.append(toff[-1] + len(text))
        elif t == 1 and len(op) == 3:
            start, end = op.get("start"), op.get("end")
            if not _i32_ok(start, end):
                return None
            kinds.append(1)
            av.append(start)
            bv.append(end)
            toff.append(toff[-1])
        elif t == 2 and len(op) == 4 and type(op.get("props")) is dict:
            start, end = op.get("start"), op.get("end")
            if not _i32_ok(start, end):
                return None
            kinds.append(2)
            av.append(start)
            bv.append(end)
            toff.append(toff[-1])
            pr = op["props"]
        else:
            return None
        prs.append(pr)
        cs.append(m.client_sequence_number)
        rs.append(m.reference_sequence_number)
    props = prs if any(p is not None for p in prs) else None
    try:
        cols = encode_cols(ds_id, ch_id, kinds, av, bv, cs, rs,
                           "".join(texts), toff, props)
    except (ValueError, OverflowError, TypeError):
        return None
    hdr = (bytes((MAGIC, FT_COLS_SUBMIT)) if sid is None
           else _FSUB_HDR.pack(MAGIC, FT_COLS_FSUBMIT, sid))
    return hdr + cols + b"\x00"


def decode_submit_columns(body: bytes, *, with_hops: bool = False):
    """Decode a cols_submit/cols_fsubmit body → (sid or None, columns).

    ``with_hops=True`` appends the parsed hoptail as a third element.
    """
    ftype = body[1]
    if ftype == FT_COLS_FSUBMIT:
        (sid,) = _U32.unpack_from(body, 2)
        off = _FSUB_HDR.size
    elif ftype == FT_COLS_SUBMIT:
        sid, off = None, 2
    else:
        raise ValueError(f"not a columnar submit frame (ftype {ftype})")
    sc, end = _read_cols(body, off)
    if with_hops:
        return sid, sc, read_hoptail(body, end)
    return sid, sc


def _cols_contents(sc: SubmitColumns, kind, a, b, toff, i: int) -> dict:
    k = kind[i]
    if k == 0:
        op = {"type": 0, "pos": a[i],
              "text": sc.text[toff[i]:toff[i + 1]]}
    elif k == 1:
        op = {"type": 1, "start": a[i], "end": b[i]}
    elif k == 2:
        op = {"type": 2, "start": a[i], "end": b[i],
              "props": sc.props[i] if sc.props else {}}
    else:
        raise ValueError(f"unknown columnar op kind {k}")
    return {"kind": "chanop", "address": sc.ds_id,
            "contents": {"address": sc.channel_id, "contents": op}}


def cols_to_ops(sc: SubmitColumns) -> list[DocumentMessage]:
    """Materialize per-op DocumentMessages (scalar-fallback path)."""
    kind = sc.kind.tolist() if hasattr(sc.kind, "tolist") else sc.kind
    a = sc.a.tolist()
    b = sc.b.tolist()
    cs = sc.cseq.tolist()
    rs = sc.rseq.tolist()
    toff = sc.text_off.tolist()
    return [DocumentMessage(
        client_sequence_number=cs[i], reference_sequence_number=rs[i],
        type=_OP_TYPE, contents=_cols_contents(sc, kind, a, b, toff, i))
        for i in range(len(kind))]


def stamp_cols_ops(cols: bytes, client_id: str, base_seq: int, msns,
                   timestamp: float, *, topic: Optional[str] = None,
                   hops=None) -> bytes:
    """Build a cols_ops/cols_fops body by SPLICING the submit's columns.

    ``cols`` is the column section exactly as received (SubmitColumns.
    cols); only the stamp header, the msn tail, and the hoptail are
    packed fresh — this is deli's sequence/msn stamping as a vectorized
    byte splice. ``hops`` is the accumulated [(hop_id, ts), ...] list
    carried from the submit frame through the tiers (empty/None on
    unsampled batches: the tail is a single NUL byte).
    """
    cid = client_id.encode()
    if topic is None:
        hdr = bytes((MAGIC, FT_COLS_OPS))
    else:
        tb = topic.encode()
        hdr = bytes((MAGIC, FT_COLS_FOPS)) + _U16.pack(len(tb)) + tb
    return b"".join((
        hdr,
        len(cid).to_bytes(2, "little"), cid,
        int(base_seq).to_bytes(8, "little", signed=True),
        np.array([timestamp], "<f8").tobytes(),
        cols,
        np.ascontiguousarray(msns, "<i8").tobytes(),
        _hoptail(hops),
    ))


def _read_cols_stamp(body: bytes):
    """Parse a stamped columnar body → (topic, cid, base_seq, ts, sc,
    msns, hops)."""
    ftype = body[1]
    if ftype == FT_COLS_FOPS:
        (tl,) = _U16.unpack_from(body, 2)
        topic = body[4:4 + tl].decode()
        off = 4 + tl
    elif ftype == FT_COLS_OPS:
        topic, off = None, 2
    else:
        raise ValueError(f"not a columnar ops frame (ftype {ftype})")
    cl = int.from_bytes(body[off:off + 2], "little")
    off += 2
    cid = body[off:off + cl].decode()
    off += cl
    base_seq = int.from_bytes(body[off:off + 8], "little", signed=True)
    off += 8
    ts = float(np.frombuffer(body, "<f8", 1, off)[0])
    off += 8
    sc, off = _read_cols(body, off)
    msns = np.frombuffer(body, "<i8", sc.n, off)
    hops = read_hoptail(body, off + 8 * sc.n)
    return topic, cid, base_seq, ts, sc, msns, hops


def decode_cols_ops(body: bytes) -> tuple[Optional[str],
                                          list[SequencedDocumentMessage]]:
    """Materialize a stamped columnar batch as sequenced messages.

    The compatibility path for rec-frame consumers (driver read loop,
    legacy JSON fan-out): hot subscribers consume the frame bytes or
    the SequencedArrayBatch directly and never call this.
    """
    topic, cid, base_seq, ts, sc, msns, hops = _read_cols_stamp(body)
    kind = sc.kind.tolist()
    a = sc.a.tolist()
    b = sc.b.tolist()
    cs = sc.cseq.tolist()
    rs = sc.rseq.tolist()
    toff = sc.text_off.tolist()
    mlist = msns.tolist()
    msgs = [SequencedDocumentMessage(
        client_id=cid, sequence_number=base_seq + i,
        minimum_sequence_number=mlist[i],
        client_sequence_number=cs[i], reference_sequence_number=rs[i],
        type=_OP_TYPE, contents=_cols_contents(sc, kind, a, b, toff, i),
        timestamp=ts)
        for i in range(len(kind))]
    if hops:
        # frame-level hops ride the LAST record, mirroring the client
        # convention of stamping the final op of a sampled boxcar
        msgs[-1].traces = hops_to_traces(hops)
    return topic, msgs


# ------------------------------------------------ durable segment blocks
# The storage tier (service/segment_store.py) persists each sequenced
# boxcar as ONE column block whose payload is, byte for byte, the
# FT_COLS_OPS stamp section:
#
#     block := f64 boxcar_ts (LE)            -- submit-time client stamp
#              u16 cid_len + cid
#              i64 base_seq (LE)
#              f64 deli_ts (LE)
#              cols section (encode_cols)
#              n x i64 msns (LE)
#
# so backfill serving is a byte slice — prepend the 2-byte header, append
# the 1-byte unsampled hoptail, and a binary client receives the same
# stamped column bytes the broadcast fan-out shipped, with zero re-encode.
# The leading boxcar_ts is the only field outside the wire stamp (the
# boxcar's own submit timestamp survives log round-trips); slicing it off
# is the whole cost of serving.

SEG_COLS = 1   # columnar block: payload as above
SEG_JSON = 2   # legacy compat shim: payload is an opaque encoded record


def encode_seg_block(cols: bytes, client_id: str, base_seq: int, msns,
                     timestamp: float, boxcar_ts: float) -> bytes:
    """Pack one sequenced boxcar as a durable SEG_COLS block payload."""
    cid = client_id.encode()
    return b"".join((
        np.array([boxcar_ts], "<f8").tobytes(),
        len(cid).to_bytes(2, "little"), cid,
        int(base_seq).to_bytes(8, "little", signed=True),
        np.array([timestamp], "<f8").tobytes(),
        cols,
        np.ascontiguousarray(msns, "<i8").tobytes(),
    ))


def read_seg_block(payload: bytes):
    """Parse a SEG_COLS payload → (boxcar_ts, cid, base_seq, ts, sc,
    msns); the storage-side recovery decode (one np.frombuffer per
    column, no per-op unpacking)."""
    boxcar_ts = float(np.frombuffer(payload, "<f8", 1, 0)[0])
    off = 8
    cl = int.from_bytes(payload[off:off + 2], "little")
    off += 2
    cid = payload[off:off + cl].decode()
    off += cl
    base_seq = int.from_bytes(payload[off:off + 8], "little", signed=True)
    off += 8
    ts = float(np.frombuffer(payload, "<f8", 1, off)[0])
    off += 8
    sc, off = _read_cols(payload, off)
    msns = np.frombuffer(payload, "<i8", sc.n, off)
    return boxcar_ts, cid, base_seq, ts, sc, msns


def seg_block_wire_body(payload: bytes) -> bytes:
    """SEG_COLS payload → a complete FT_COLS_OPS body (unsampled
    hoptail): the zero-re-encode backfill serving slice."""
    return bytes((MAGIC, FT_COLS_OPS)) + payload[8:] + b"\x00"


def cols_deltas_body(rid: int, payload: bytes) -> bytes:
    """SEG_COLS payload → one FT_COLS_DELTAS backfill push body, tagged
    with the u32 request id so the client routes it to the right
    get_deltas_cols call. No hoptail: backfill is replay, not live."""
    return (bytes((MAGIC, FT_COLS_DELTAS)) + rid.to_bytes(4, "big")
            + payload[8:])


def read_cols_deltas(body: bytes):
    """FT_COLS_DELTAS body → (rid, sequenced messages)."""
    rid = int.from_bytes(body[2:6], "big")
    _, msgs = decode_cols_ops(bytes((MAGIC, FT_COLS_OPS)) + body[6:]
                              + b"\x00")
    return rid, msgs


def snap_chunk_body(rid: int, chunk_hash: str, chunk: bytes) -> bytes:
    """Snapcols chunk → one FT_COLS_SNAP push body, tagged with the u32
    request id (routing, like FT_COLS_DELTAS) and the content hash (the
    client's dedupe key). The chunk bytes ride verbatim — the serving
    cache frames each chunk exactly once per (doc, version)."""
    h = chunk_hash.encode("ascii")
    return (bytes((MAGIC, FT_COLS_SNAP)) + rid.to_bytes(4, "big")
            + _U16.pack(len(h)) + h + chunk)


def read_snap_chunk(body: bytes):
    """FT_COLS_SNAP body → (rid, chunk_hash, chunk bytes)."""
    rid = int.from_bytes(body[2:6], "big")
    (hl,) = _U16.unpack_from(body, 6)
    return rid, body[8:8 + hl].decode("ascii"), body[8 + hl:]


def encode_history_commit(rid: int, commit: dict) -> bytes:
    """History commit dict → one FT_HISTORY push body, tagged with the
    u32 request id (routing, like FT_COLS_SNAP). The commit rides as a
    framed refgraph record so the wire exercises the same crc'd codec
    the per-doc ref file persists."""
    from .refgraph import encode_commit, frame_record
    return (bytes((MAGIC, FT_HISTORY)) + rid.to_bytes(4, "big")
            + frame_record(encode_commit(commit)))


def decode_history_commit(body: bytes):
    """FT_HISTORY body → (rid, commit dict). Raises on a torn record —
    the wire is a reliable stream, unlike the ref file's tail."""
    from .refgraph import scan_records
    rid = int.from_bytes(body[2:6], "big")
    records, clean = scan_records(body[6:])
    if len(records) != 1 or clean != len(body) - 6:
        raise ValueError("malformed FT_HISTORY body")
    rec = records[0]
    if rec.get("t") != "commit":
        raise ValueError("FT_HISTORY body is not a commit record")
    rec.pop("t", None)
    return rid, rec


# --------------------------------------------------- gateway byte rewrites
# The relay operations gateway.py performs WITHOUT decoding op payloads.


def submit_to_fsubmit(body: bytes, sid: int) -> bytes:
    """Rewrite a client ``submit`` body into an upstream ``fsubmit``."""
    ft = FT_COLS_FSUBMIT if body[1] == FT_COLS_SUBMIT else FT_FSUBMIT
    return _FSUB_HDR.pack(MAGIC, ft, sid) + body[2:]


def fsubmit_sid(body: bytes) -> int:
    """The muxed session id an ``fsubmit`` body is addressed to."""
    return _U32.unpack_from(body, 2)[0]


def fsubmit_rewrite_sid(body: bytes, sid: int) -> bytes:
    """Relay-tree sid splice: re-address an ``fsubmit`` body to the
    parent tier's sid without touching the op payload bytes."""
    return body[:2] + _U32.pack(sid) + body[6:]


def fops_strip_topic(body: bytes) -> tuple[str, bytes]:
    """Split an ``fops`` body → (topic, client-facing ``ops`` body)."""
    ft = FT_COLS_OPS if body[1] == FT_COLS_FOPS else FT_OPS
    (tl,) = _U16.unpack_from(body, 2)
    topic = body[4:4 + tl].decode()
    return topic, bytes((MAGIC, ft)) + body[4 + tl:]


def fpresence_strip_topic(body: bytes) -> tuple[str, bytes]:
    """Split an ``fpresence`` body → (topic, client ``presence`` body)."""
    (tl,) = _U16.unpack_from(body, 2)
    topic = body[4:4 + tl].decode()
    return topic, bytes((MAGIC, FT_PRESENCE)) + body[4 + tl:]


# ----------------------------------------------------- presence frames
# The ephemeral lane: coalesced signal batches, never sequenced, never
# logged. Batch section is IDENTICAL between FT_PRESENCE (client form)
# and FT_FPRESENCE (backbone form, u16-len topic prefix) so a gateway
# relays presence down the tree with the same topic-slice byte splice
# as fops — zero re-encode at every level.
#
#     batch := u16 n; n × entry
#     entry := u16 cid_len (0xFFFF = None) + utf8 cid,
#              u16 type_len + utf8 type,
#              u32 content_len + utf8 content-JSON


def encode_presence(signals, topic: Optional[str] = None) -> bytes:
    """Signal batch → FT_PRESENCE body, or FT_FPRESENCE when ``topic``
    is given (the backbone form a gateway strips without decoding)."""
    out = []
    if topic is None:
        out.append(bytes((MAGIC, FT_PRESENCE)))
    else:
        t = topic.encode()
        out.append(bytes((MAGIC, FT_FPRESENCE)) + _U16.pack(len(t)) + t)
    out.append(_U16.pack(len(signals)))
    for sig in signals:
        cid = sig.client_id
        if cid is None:
            out.append(_U16.pack(_NONE_IDX))
        else:
            c = cid.encode()
            out.append(_U16.pack(len(c)))
            out.append(c)
        t = sig.type.encode()
        out.append(_U16.pack(len(t)))
        out.append(t)
        body = json.dumps(sig.content, separators=(",", ":")).encode()
        out.append(_U32.pack(len(body)))
        out.append(body)
    return b"".join(out)


def decode_presence(body: bytes):
    """FT_PRESENCE / FT_FPRESENCE body → list of Signal."""
    off = 2
    if body[1] == FT_FPRESENCE:
        (tl,) = _U16.unpack_from(body, off)
        off += 2 + tl
    (n,) = _U16.unpack_from(body, off)
    off += 2
    sigs = []
    for _ in range(n):
        (cl,) = _U16.unpack_from(body, off)
        off += 2
        if cl == _NONE_IDX:
            cid = None
        else:
            cid = body[off:off + cl].decode()
            off += cl
        (tl,) = _U16.unpack_from(body, off)
        off += 2
        typ = body[off:off + tl].decode()
        off += tl
        (bl,) = _U32.unpack_from(body, off)
        off += 4
        content = json.loads(body[off:off + bl].decode())
        off += bl
        sigs.append(Signal(client_id=cid, type=typ, content=content))
    return sigs


def is_binary(body: bytes) -> bool:
    return bool(body) and body[0] == MAGIC


def frame(body: bytes) -> bytes:
    """Prepend the shared 4-byte length header."""
    return len(body).to_bytes(4, "big") + body
