"""DurableLog: the ordered-log interface over the native C++ op log.

JAX counterpart: ``fluidframework_tpu/service/durable_log.py``; the port's
copy, imports rebased to this package. The on-disk format is the same, so
a directory either package wrote reads back in the other.

Drop-in for LocalLog in LocalOrderer/LocalServer (same OrderedLogBase
machinery), but every record is persisted through csrc/oplog.cpp, so a
process restart resumes the pipeline from disk — the single-node
durability story the reference gets from Kafka+Mongo (SURVEY §2.9
consolidation note).

Two on-disk lanes:

- **Columnar segment streams** (default for ``deltas/*`` topics): each
  sequenced boxcar persists as ONE packed column block
  (binwire.encode_seg_block — byte for byte the FT_COLS_OPS stamp
  section) appended through the native segment store
  (``<stream>.seg<k>`` files + 32-byte seq-span index entries). Recovery
  replay decodes blocks with vectorized ``np.frombuffer`` column reads,
  and seq-range backfill (:meth:`delta_blocks`) is a binary search over
  the mmap'd index plus raw byte-range copies served to binary clients
  verbatim — zero re-encode, zero per-op materialization.
- **Record topics** (rawops, checkpoints, versions, uploads — and any
  deltas directory written before the segment store existed): the
  original length-prefixed record files. Non-columnar encodings live in
  the ``log_compat`` shim; every trip through it on the deltas lane is
  counted under the ``storage.log.legacy_json`` deprecation counter.

Subscriber positions are in-memory (the lambdas own their checkpoints,
as in the reference).
"""

from __future__ import annotations

import os
import struct
from typing import Any, Optional

import numpy as np

from ..native.oplog import NativeOpLog
from ..utils.affinity import blocking
from ..obs.metrics import tier_counters
from ..protocol import binwire
from .local_log import OrderedLogBase
from .log_compat import (
    abox_header_bytes,
    abox_header_from,
    decode_json_value,
    encode_json_value,
)
from .segment_store import SegmentReader

# --------------------------------------------------- binary fast path
# The split deployment's hot records are (a) a raw ArrayBoxcar on the
# rawops topic and (b) the ticketed {"abatch": SequencedArrayBatch}
# record on the deltas topic. (b) rides the columnar segment store; (a)
# packs as kind-3 below with the SAME binwire cols section the segment
# block embeds, so ONE column encode per boxcar serves the rawops
# record, the deltas block, and the broadcast splice. Kinds 1/2 remain
# as the frozen decoders (and record-topic encoders) for pre-segment
# directories. 0xFF can never begin a JSON record.

_BIN_MARK = 0xFF
_BIN_RAW_ABOX = 1   # legacy raw boxcar (JSON header + column bytes)
_BIN_ABATCH = 2     # legacy sequenced batch (record-format deltas topics)
_BIN_RAW_COLS = 3   # raw boxcar: route header + binwire cols section

#: Native-handle budget per DurableLog handle (override per instance or
#: with FLUID_LOG_FD_CAP). A sharded core owns several per-partition
#: logs plus sockets, all inside one RLIMIT_NOFILE — at ~8 handles per
#: resident doc an uncapped 10k-doc rehydration would exhaust any
#: realistic limit, so cold handles LRU-cycle under this cap instead.
LOG_FD_CAP = int(os.environ.get("FLUID_LOG_FD_CAP", "2048"))

_RAW_COLS_HDR = struct.Struct("<d")  # boxcar timestamp


def _cols_of(box) -> Optional[bytes]:
    """The boxcar's binwire column section, encoded once and memoized on
    ``wire_cols`` (network-columnar boxcars arrive with it already set);
    None when the boxcar doesn't fit the columnar format."""
    cols = box.wire_cols
    if cols is None:
        try:
            cols = binwire.encode_cols(
                box.ds_id, box.channel_id, box.kind, box.a, box.b,
                box.cseq, box.rseq, box.text, box.text_off, box.props)
        except Exception:
            return None
        box.wire_cols = cols
    return cols


def _abox_bytes(box) -> bytes:
    cached = getattr(box, "_wire_cache", None)
    if cached is not None:
        return cached
    hdr = abox_header_bytes(box)
    text = box.text.encode()
    data = b"".join((
        len(hdr).to_bytes(4, "little"), hdr,
        np.ascontiguousarray(box.kind, np.int8).tobytes(),
        np.ascontiguousarray(box.a, np.int32).tobytes(),
        np.ascontiguousarray(box.b, np.int32).tobytes(),
        np.ascontiguousarray(box.cseq, np.int32).tobytes(),
        np.ascontiguousarray(box.rseq, np.int32).tobytes(),
        np.ascontiguousarray(box.text_off, np.int32).tobytes(),
        len(text).to_bytes(4, "little"), text,
    ))
    box._wire_cache = data
    return data


def _abox_from(data: bytes, off: int):
    from .array_batch import ArrayBoxcar

    hlen = int.from_bytes(data[off:off + 4], "little")
    off += 4
    tenant, doc, client, ds, ch, ts, n, props = abox_header_from(
        data[off:off + hlen])
    off += hlen
    kind = np.frombuffer(data, np.int8, n, off); off += n
    a = np.frombuffer(data, np.int32, n, off); off += 4 * n
    b = np.frombuffer(data, np.int32, n, off); off += 4 * n
    cseq = np.frombuffer(data, np.int32, n, off); off += 4 * n
    rseq = np.frombuffer(data, np.int32, n, off); off += 4 * n
    text_off = np.frombuffer(data, np.int32, n + 1, off); off += 4 * (n + 1)
    tlen = int.from_bytes(data[off:off + 4], "little")
    off += 4
    text = data[off:off + tlen].decode()
    return ArrayBoxcar(
        tenant_id=tenant, document_id=doc, client_id=client, ds_id=ds,
        channel_id=ch, kind=kind, a=a, b=b, cseq=cseq, rseq=rseq,
        text=text, text_off=text_off, props=props, timestamp=ts)


def _u16str(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "little") + b


def _encode_binary(value: Any) -> bytes | None:
    from .array_batch import ArrayBoxcar, SequencedArrayBatch

    t = type(value)
    if t is ArrayBoxcar:
        cols = _cols_of(value)
        if cols is not None:
            return b"".join((
                bytes((_BIN_MARK, _BIN_RAW_COLS)),
                _u16str(value.tenant_id), _u16str(value.document_id),
                _u16str(value.client_id),
                _RAW_COLS_HDR.pack(value.timestamp),
                cols,
            ))
        return bytes((_BIN_MARK, _BIN_RAW_ABOX)) + _abox_bytes(value)
    if t is dict and value.keys() == {"tenant_id", "document_id",
                                      "abatch"}:
        batch = value.get("abatch")
        # the decoder reconstructs tenant_id/document_id FROM the boxcar,
        # so the binary path is only sound when the dict's fields equal
        # the boxcar's — any other record shape (renamed key, divergent
        # routing field) must round-trip through JSON verbatim
        if type(batch) is SequencedArrayBatch \
                and value["tenant_id"] == batch.boxcar.tenant_id \
                and value["document_id"] == batch.boxcar.document_id:
            return b"".join((
                bytes((_BIN_MARK, _BIN_ABATCH)),
                struct.pack("<qdI", batch.base_seq, batch.timestamp,
                            batch.n),
                np.ascontiguousarray(batch.msns, np.int64).tobytes(),
                _abox_bytes(batch.boxcar),
            ))
    return None


def _decode_binary(data: bytes) -> Any:
    from .array_batch import ArrayBoxcar, SequencedArrayBatch

    kind = data[1]
    if kind == _BIN_RAW_ABOX:
        return _abox_from(data, 2)
    if kind == _BIN_ABATCH:
        base_seq, ts, n = struct.unpack_from("<qdI", data, 2)
        off = 2 + struct.calcsize("<qdI")
        msns = np.frombuffer(data, np.int64, n, off)
        off += 8 * n
        box = _abox_from(data, off)
        return {"tenant_id": box.tenant_id,
                "document_id": box.document_id,
                "abatch": SequencedArrayBatch(
                    boxcar=box, base_seq=base_seq, msns=msns,
                    timestamp=ts)}
    if kind == _BIN_RAW_COLS:
        off = 2
        strs = []
        for _ in range(3):
            ln = int.from_bytes(data[off:off + 2], "little")
            off += 2
            strs.append(data[off:off + ln].decode())
            off += ln
        (ts,) = _RAW_COLS_HDR.unpack_from(data, off)
        off += _RAW_COLS_HDR.size
        sc, _ = binwire._read_cols(data, off)
        return ArrayBoxcar(
            tenant_id=strs[0], document_id=strs[1], client_id=strs[2],
            ds_id=sc.ds_id, channel_id=sc.channel_id, kind=sc.kind,
            a=sc.a, b=sc.b, cseq=sc.cseq, rseq=sc.rseq, text=sc.text,
            text_off=sc.text_off, props=sc.props, timestamp=ts,
            wire_cols=sc.cols)
    raise ValueError(f"unknown binary record kind {kind}")


def _encode_value(value: Any) -> bytes:
    data = _encode_binary(value)
    if data is not None:
        return data
    return encode_json_value(value)


def _decode_value(data: bytes) -> Any:
    if data[:1] == b"\xff":
        return _decode_binary(data)
    return decode_json_value(data)


def _sanitize(topic: str) -> str:
    """Bijective topic → file-name mapping (oplog topic names allow only
    [alnum._-]). '/' becomes '.'; a literal '.' in a tenant/doc id is
    escaped first so _desanitize can invert exactly — without the escape,
    a doc named 'notes.v2' would round-trip through list_topics as
    'notes/v2' and stage backchannel records would route to a
    nonexistent doc."""
    return topic.replace("_", "__").replace(".", "_d").replace("/", ".")


def _desanitize(name: str) -> str:
    out = []
    i, n = 0, len(name)
    while i < n:
        c = name[i]
        if c == ".":
            out.append("/")
        elif c == "_" and i + 1 < n:
            nxt = name[i + 1]
            if nxt == "_":
                out.append("_")
                i += 1
            elif nxt == "d":
                out.append(".")
                i += 1
            else:
                out.append(c)
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _legacy_messages(value: Any) -> list:
    """Materialize the sequenced messages a legacy deltas record holds
    (the backfill door's compat shim for SEG_JSON blocks)."""
    if not isinstance(value, dict):
        return []
    abatch = value.get("abatch")
    if abatch is not None:
        return abatch.messages()
    boxcar = value.get("boxcar")
    if boxcar is not None:
        return list(boxcar)
    msg = value.get("message")
    return [msg] if msg is not None else []


_UNSET = object()


class DurableLog(OrderedLogBase):
    """Persistent ordered topics with subscriber fan-out.

    ``readonly=True`` opens a CONSUMER-PROCESS view over a directory
    another process writes (the Kafka consumer-group role): appends are
    refused by the native layer, and :meth:`poll` tails newly flushed
    producer records into this process's subscribers. A producer makes
    its appends visible with :meth:`flush` (page cache, cheap) and
    durable with :meth:`sync` (fsync, checkpoint boundaries).

    ``segmented=False`` forces every topic onto the record lane (the
    pre-segment behavior; the bench scalar A/B rides this knob).
    ``segment_bytes`` overrides the 4 MiB segment roll threshold."""

    def __init__(self, directory: str, readonly: bool = False,
                 segmented: bool = True,
                 segment_bytes: Optional[int] = None,
                 fd_cap: Optional[int] = None):
        super().__init__()
        self.directory = directory
        self.readonly = readonly
        self._log = NativeOpLog(directory, readonly=readonly)
        self._segmented = segmented
        if segment_bytes is not None:
            self._log.seg_config(segment_bytes)
        # ~8 native handles per resident doc would blow RLIMIT_NOFILE at
        # fleet scale (a 10k-doc mass rehydration is the concrete case);
        # the native layer LRU-cycles cold handles under this cap while
        # topic metadata stays resident. 0 disables.
        self._log.fd_cap(LOG_FD_CAP if fd_cap is None else fd_cap)
        self.counters = tier_counters("storage")
        # last-record decode cache per topic, PRIMED at append: the
        # drain delivers each record to every subscriber back to back
        # (3× on the deltas topic), and in-process those deliveries
        # share the live object exactly like LocalLog — consumers treat
        # log records as immutable. Cuts per-record decodes from
        # k-subscribers to zero on the hot path.
        self._read_cache: dict[str, tuple] = {}
        # topic lengths are consulted ~4×/record by the drain machinery;
        # caching removes a ctypes round trip per query (appends and
        # refreshes keep it exact — this handle is the only writer)
        self._len_cache: dict[str, int] = {}
        self._san_cache: dict[str, str] = {}
        self._seg_route: dict[str, Optional[str]] = {}
        self._seg_last: dict[str, int] = {}  # highest indexed seq span end
        # reader LRU: each SegmentReader pins 1 fd per mmap (CPython
        # dups the fd behind mmap.mmap), so resident readers are fd
        # budget exactly like native handles — cold ones close and
        # rebuild on demand (refresh revalidates from the index, no
        # record decodes)
        from collections import OrderedDict
        cap = LOG_FD_CAP if fd_cap is None else fd_cap
        self._reader_cap = max(32, cap // 4) if cap else 0
        self._readers: "OrderedDict[str, SegmentReader]" = OrderedDict()
        self._torn_count = 0

    # ------------------------------------------------------ topic routing

    def _san(self, topic: str) -> str:
        s = self._san_cache.get(topic)
        if s is None:
            s = self._san_cache[topic] = _sanitize(topic)
        return s

    def _seg_stream(self, topic: str) -> Optional[str]:
        """Sanitized segment-stream name for ``topic``, or None when the
        topic rides the record lane (cached)."""
        s = self._seg_route.get(topic, _UNSET)
        if s is not _UNSET:
            return s
        s = None
        if self._segmented and topic.startswith("deltas/"):
            san = self._san(topic)
            # a record-format topic already on disk (a directory written
            # before the segment store) stays record-format, for reads
            # AND subsequent writes — mixing lanes would split its order
            if not os.path.exists(os.path.join(self.directory,
                                               san + ".idx")):
                s = san
        self._seg_route[topic] = s
        return s

    def segment_reader(self, topic: str) -> Optional[SegmentReader]:
        """The mmap'd reader over ``topic``'s segment stream (None for
        record-lane topics)."""
        stream = self._seg_stream(topic)
        if stream is None:
            return None
        r = self._readers.get(stream)
        if r is None:
            flush = None if self.readonly else self._log.flush
            r = self._readers[stream] = SegmentReader(
                self.directory, stream, flush=flush)
            while self._reader_cap and len(self._readers) > self._reader_cap:
                _, cold = self._readers.popitem(last=False)
                cold.close()
        else:
            self._readers.move_to_end(stream)
        return r

    # ---------------------------------------------------------- tailing

    def _refresh_one(self, topic: str) -> int:
        stream = self._seg_stream(topic)
        if stream is not None:
            n = self._log.seg_refresh(stream)
            if n == 0 and os.path.exists(
                    os.path.join(self.directory, self._san(topic)
                                 + ".idx")):
                # the producer turned out to be record-format (it opened
                # a pre-segment directory): reroute before anyone reads
                self._seg_route[topic] = None
                n = self._log.refresh(self._san(topic))
        else:
            n = self._log.refresh(self._san(topic))
        self._len_cache[topic] = n
        return n

    def poll(self) -> bool:
        """Refresh every subscribed topic from disk; mark grown topics
        dirty. Returns True when drain() has new work."""
        if self.fault_plane is not None:
            # chaos seam, read side: a consumer process resuming from a
            # stale position (lost position file, conservative restart)
            # re-reads an already-consumed window — every subscriber
            # must tolerate redelivery
            if self.fault_plane("log.poll", directory=self.directory) \
                    == "rewind":
                for topic in self._order:
                    self.rewind_subscribers(topic, 1)
        grew = False
        for topic in self._order:
            n = self._refresh_one(topic)
            if any(pos[0] < n for _, pos in self._subs.get(topic, ())):
                self._dirty[topic] = None
                grew = True
        return grew

    def list_topics(self, prefix: str = "") -> list[str]:
        """Topics present on disk (desanitized), optionally filtered by
        prefix — how a consumer process discovers per-doc topics."""
        out = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            if name.endswith(".segidx"):
                topic = _desanitize(name[:-7])
            elif name.endswith(".idx"):
                topic = _desanitize(name[:-4])
            else:
                continue
            if topic.startswith(prefix):
                out.add(topic)
        return sorted(out)

    def refresh_topic(self, topic: str) -> int:
        """Refresh ONE topic from disk; returns its record count."""
        return self._refresh_one(topic)

    @blocking("page-cache flush — bounded but off the async fast path")
    def flush(self) -> None:
        self._log.flush()

    # ------------------------------------------------- storage primitives

    def _store(self, topic: str, value: Any) -> int:
        stream = self._seg_stream(topic)
        if stream is not None:
            block, first, last, btype = self._seg_encode(topic, value)
            offset = self._log.seg_append(stream, first, last, block,
                                          btype)
            self._seg_last[topic] = last
            self.counters.inc("storage.segment.appends")
        else:
            data = _encode_value(value)
            if data[0] != _BIN_MARK and topic.startswith("deltas/"):
                self.counters.inc("storage.log.legacy_json")
            offset = self._log.append(self._san(topic), data)
        self._len_cache[topic] = offset + 1
        self._read_cache[topic] = (offset, value)
        return offset

    def _seg_encode(self, topic: str, value: Any):
        """Encode one deltas record as a segment block: columnar when it
        is the canonical abatch shape, else the legacy shim (opaque
        record encoding behind the deprecation counter)."""
        from .array_batch import SequencedArrayBatch

        if type(value) is dict and value.keys() == {"tenant_id",
                                                    "document_id",
                                                    "abatch"}:
            batch = value["abatch"]
            if type(batch) is SequencedArrayBatch:
                box = batch.boxcar
                # tenant/doc reconstruct FROM the topic on decode, so the
                # columnar block is only sound when they all agree
                if topic == "deltas/%s/%s" % (box.tenant_id,
                                              box.document_id) \
                        and value["tenant_id"] == box.tenant_id \
                        and value["document_id"] == box.document_id \
                        and "/" not in box.tenant_id:
                    cols = _cols_of(box)
                    if cols is not None:
                        block = binwire.encode_seg_block(
                            cols, box.client_id, batch.base_seq,
                            batch.msns, batch.timestamp, box.timestamp)
                        return (block, batch.base_seq, batch.last_seq,
                                binwire.SEG_COLS)
        data = _encode_value(value)
        first, last = self._record_span(topic, value)
        self.counters.inc("storage.log.legacy_json")
        return data, first, last, binwire.SEG_JSON

    def _record_span(self, topic: str, value: Any) -> tuple[int, int]:
        """Seq span a legacy record covers, for its index entry; records
        with no derivable span get an empty span at the current high
        mark (kept in range queries' superset, filtered by the shim)."""
        try:
            if isinstance(value, dict):
                abatch = value.get("abatch")
                if abatch is not None:
                    return abatch.base_seq, abatch.last_seq
                boxcar = value.get("boxcar")
                if boxcar:
                    return (boxcar[0].sequence_number,
                            boxcar[-1].sequence_number)
                msg = value.get("message")
                if msg is not None:
                    return msg.sequence_number, msg.sequence_number
        except Exception:
            pass
        last = self._seg_last.get(topic, 0)
        return last, last

    def _seg_decode(self, topic: str, payload: bytes) -> Any:
        """SEG_COLS payload → the canonical abatch record (vectorized
        frombuffer column reads — the recovery-replay decode)."""
        from .array_batch import ArrayBoxcar, SequencedArrayBatch

        box_ts, cid, base_seq, ts, sc, msns = binwire.read_seg_block(
            payload)
        _, tenant, doc = topic.split("/", 2)
        box = ArrayBoxcar(
            tenant_id=tenant, document_id=doc, client_id=cid,
            ds_id=sc.ds_id, channel_id=sc.channel_id, kind=sc.kind,
            a=sc.a, b=sc.b, cseq=sc.cseq, rseq=sc.rseq, text=sc.text,
            text_off=sc.text_off, props=sc.props, timestamp=box_ts,
            wire_cols=sc.cols)
        return {"tenant_id": tenant, "document_id": doc,
                "abatch": SequencedArrayBatch(
                    boxcar=box, base_seq=base_seq, msns=msns,
                    timestamp=ts)}

    def _load(self, topic: str, offset: int) -> Any:
        cached = self._read_cache.get(topic)
        if cached is not None and cached[0] == offset:
            return cached[1]
        stream = self._seg_stream(topic)
        if stream is not None:
            reader = self.segment_reader(topic)
            if offset >= reader.count:
                reader.refresh()
            btype, _, _, payload = reader.block(offset)
            if btype == binwire.SEG_COLS:
                value = self._seg_decode(topic, payload)
                self.counters.inc("storage.segment.decodes")
            else:
                value = _decode_value(payload)
                self.counters.inc("storage.log.legacy_json")
        else:
            value = _decode_value(self._log.read(self._san(topic), offset))
        self._read_cache[topic] = (offset, value)
        return value

    def _stored_length(self, topic: str) -> int:
        n = self._len_cache.get(topic)
        if n is not None:
            return n
        stream = self._seg_stream(topic)
        if stream is not None:
            n = self._log.seg_count(stream)
        else:
            n = self._log.length(self._san(topic))
        self._len_cache[topic] = n
        return n

    def _torn_append(self, topic: str, value: Any) -> int:
        stream = self._seg_stream(topic)
        if stream is None or self.readonly:
            return super()._torn_append(topic, value)
        # segment streams have a PHYSICAL torn representation: leave a
        # ragged half-written tail on disk (alternating between a torn
        # block and a torn index entry), then run the same
        # detect-truncate-rewrite cycle crash recovery runs. Deltas
        # records are already ticketed, so unlike the rawops torn
        # semantics the record itself must survive — a permanently
        # missing seq would stall every consumer on an unfillable gap.
        block, first, last, btype = self._seg_encode(topic, value)
        self._log.seg_tear(stream, first, last, block, btype,
                           mode=self._torn_count % 2)
        self._torn_count += 1
        self.counters.inc("storage.segment.torn")
        offset = self._log.seg_append(stream, first, last, block, btype)
        self._seg_last[topic] = last
        self.counters.inc("storage.segment.appends")
        self._len_cache[topic] = offset + 1
        self._read_cache[topic] = (offset, value)
        return offset

    def first_offset_covering(self, topic: str, seq: int) -> int:
        """Lazy cold-boot tail entry: the lowest record offset whose
        block may hold any seq' ≥ ``seq`` — one binary search over the
        mmap'd seq-span index, zero record decodes. Record-lane topics
        have no index and return 0 (the subscriber's skip absorbs the
        prefix)."""
        reader = self.segment_reader(topic)
        if reader is None:
            return 0
        reader.refresh()
        return reader.first_covering(seq)

    # ------------------------------------------------------ backfill door

    def delta_blocks(self, topic: str, from_seq: int, to_seq: int):
        """Columnar backfill: ``(payloads, legacy_msgs)`` covering every
        record with from_seq < seq < to_seq, or None when the topic
        rides the record lane (caller falls back to scriptorium).

        ``payloads`` are SEG_COLS block payloads copied straight out of
        the segment mmaps — zero decode server-side; a boundary block
        may span past the requested range, and the CLIENT trims by seq
        after decoding (binwire.seg_block_wire_body /
        read_cols_deltas). Legacy blocks materialize through the compat
        shim and come back as in-range message objects."""
        stream = self._seg_stream(topic)
        if stream is None:
            return None
        reader = self.segment_reader(topic)
        reader.refresh()
        payloads: list[bytes] = []
        legacy: list = []
        for i in reader.range_blocks(from_seq, to_seq):
            btype, _, _, payload = reader.block(i)
            if btype == binwire.SEG_COLS:
                payloads.append(payload)
            else:
                self.counters.inc("storage.log.legacy_json")
                for m in _legacy_messages(_decode_value(payload)):
                    if from_seq < m.sequence_number < to_seq:
                        legacy.append(m)
        if payloads:
            self.counters.inc("storage.backfill.byterange", len(payloads))
        return payloads, legacy

    # ------------------------------------------------------------- admin

    @blocking("msync to stable storage — the slow durability barrier, checkpoint/teardown only")
    def sync(self) -> None:
        self._log.sync()

    def close(self) -> None:
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        self._log.close()
