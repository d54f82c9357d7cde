"""NetworkFrontEnd: the socket front door (the Alfred analog).

JAX counterpart: ``fluidframework_tpu/service/front_end.py``; the port's
copy of the single-pipeline core, imports rebased to this package: the
frame protocol and every client door, the gateway backbone, the admin
status/counter RPCs, the stage backchannel, the service-summarizer loop,
``start_background``/``serve_forever`` and ``main()``. What the port does
not carry yet raises ``NotImplementedError`` naming its ROADMAP item: the
storage tier (``--storage-dir``, ``--storage-server``,
``--external-scribe`` and the backchannel's ``version`` record, A9) and
the tenancy, overload, placement and health planes (``--tenant``,
``--tenant-rate``, ``--slo``, ``--probe``, ``--shard-dir``,
``--topology``, ``--rebalance``, the sharded ``ShardHost``, A10). The
admin doors of the sharded core answer as a single-pipeline core does.

Ref: lambdas/src/alfred/index.ts:112-405 — the reference's front end is a
socket.io server doing the connect_document handshake (:159,:285),
submitOp ordering (:310), signal relay (:405), plus REST routes for delta
backfill and snapshot storage. Here it is one asyncio TCP server speaking
length-prefixed JSON frames, serving BOTH the live bidi op stream and the
request/response (REST-role) endpoints over the same wire format.

Frame = 4-byte big-endian length + JSON body {"t": <type>, ...}:

  client → server
    connect        {tenant, doc, details, rid}        → connected {clientId, seq, rid}
    submit         {ops: [DocumentMessage…]}          (fire-and-forget, like socket submitOp)
    signal         {content, type}
    get_deltas     {tenant, doc, from, to, rid}       → deltas {msgs, rid}
    get_deltas_cols {tenant, doc, from, to, rid}      → K × binary FT_COLS_DELTAS pushes,
                                                        then deltas {msgs, blocks, head, rid}
                                                        (direct core connections only)
    get_versions   {tenant, doc, count, rid}          → versions {versions, rid}
    get_tree       {tenant, doc, version, rid}        → tree {tree, rid}
    read_blob      {tenant, doc, id, rid}             → blob {hex, rid}
    write_blob     {tenant, doc, hex, rid}            → blob_id {id, rid}
    upload_summary {tenant, doc, summary, parent, rid} → version_id {id, rid}
    disconnect     {}
  server → client (push, after connect)
    ops {msgs: [SequencedDocumentMessage…]} | nack {nack} | signal {signal}
  server → client (error reply)
    error {message, rid?}

Gateway backbone (the Redis-pub/sub role — N gateway processes terminate
client sockets and mux them over ONE upstream connection each; see
service/gateway.py):

  gateway → core
    fconnect    {sid, tenant, doc, details, rid} → fconnected {sid, rid, …}
    fsubmit     {sid, ops} | fsignal {sid, content, type} | fdisconnect {sid}
    (storage/delta RPCs pass through unchanged — they are stateless)
  core → gateway
    fops {topic, msgs}   ONE per broadcast batch per gateway, however many
                         clients the gateway serves on that doc
    fnack {sid, nack} | fsignal {topic, signal}

Concurrency model: the ENTIRE service (LocalServer pipeline included) runs
on the event-loop thread, so no server-side locking is needed — the same
single-writer discipline the reference gets from Node's event loop.

Service limits: submits above ``max_message_size`` (16 KB default, ref
localDeltaConnectionServer.ts:96) are nacked with BAD_REQUEST without
entering the pipeline.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import threading
import time
from typing import Optional

from ..obs import get_journal, get_recorder, get_registry, tier_counters
from ..obs.probe import CANARY_TENANT
from ..utils.affinity import loop_only
from ..protocol import binwire
from ..protocol.messages import Nack, NackErrorType, Signal, TraceHop
from ..protocol.serialization import message_from_dict, message_to_dict
from ..utils.telemetry import (HOP_ADMIT, HOP_SERVICE_ACTION,
                               count_unknown_hops, hop_pairs)
from .admission import AdmissionController, retry_after_ms
from .array_batch import ArrayBoxcar
from .local_server import LocalServer, ServerConnection
from .presence import PresenceLane
from .rehydrate import BootPending
from .scriptorium import LogTruncatedError

MAX_FRAME = 8 * 1024 * 1024  # absolute wire-frame cap (storage payloads)
DEFAULT_MAX_MESSAGE_SIZE = 16 * 1024  # per-op cap, nacked (ref :96)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"front end {what} is not ported to fluidframework_tpu_torch yet "
        f"(ROADMAP {item})")


def _encode_frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode()
    return len(body).to_bytes(4, "big") + body


def _stamp_abatch(batch, topic=None, tenant=None) -> bytes:
    """Sequenced columnar broadcast body: splice deli's stamp onto the
    column bytes the submit frame carried (zero re-encode); a boxcar
    that arrived without them (in-proc submit_array, durable replay)
    re-packs its columns once here.

    Sampled boxcars carry the accumulated hop list; this is the egress
    point where the full server-side path is known, so the consecutive
    hop pairs (submit→relay→admit→deli→fanout) are observed into the
    process registry here — once per encode, which the fan-out caches
    make once per batch — and the list packs back into the broadcast
    frame's hoptail for the client's ack split."""
    box = batch.boxcar
    cols = box.wire_cols
    if cols is None:
        cols = binwire.encode_cols(
            box.ds_id, box.channel_id, box.kind, box.a, box.b,
            box.cseq, box.rseq, box.text, box.text_off, box.props)
    hops = box.hops
    if hops and tenant is None and topic:
        tenant = topic.partition("/")[0]
    if hops and tenant != CANARY_TENANT:
        # canary hops must not land in the windowed series the SLO
        # engine burns on: the probe measures the doors and may not
        # flip the shed machinery those windows gate
        reg = get_registry()
        unknown = count_unknown_hops(hops)
        if unknown:
            # a hop id past this build's taxonomy (version-skewed
            # client): COUNT it rather than silently dropping, so a
            # breakdown that quietly lost legs is visible in the scrape
            reg.inc("obs.trace.unknown_hops", unknown)
        for pair, ms in hop_pairs(hops):
            # cumulative summary (lifetime) and its windowed twin (the
            # SLO engine's read source) — both per sampled batch only,
            # labeled by tenant when the egress point knows it
            if tenant:
                reg.observe("obs.hop.ms", ms, pair=pair, tenant=tenant)
                reg.observe_windowed("obs.hop.window_ms", ms,
                                     pair=pair, tenant=tenant)
            else:
                reg.observe("obs.hop.ms", ms, pair=pair)
                reg.observe_windowed("obs.hop.window_ms", ms, pair=pair)
    return binwire.stamp_cols_ops(cols, box.client_id, batch.base_seq,
                                  batch.msns, batch.timestamp, topic=topic,
                                  hops=hops)


def _stamp_admit(ops) -> None:
    """frontend/admit hop on rec-frame ingress, SAMPLED ops only: an op
    carries traces iff the client armed tracing for it, so unsampled
    traffic pays one empty-list check per op."""
    svc, act = HOP_SERVICE_ACTION[HOP_ADMIT]
    for op in ops:
        if op.traces:
            op.traces.append(
                TraceHop(service=svc, action=act, timestamp=time.time()))


async def _read_body(reader: asyncio.StreamReader) -> Optional[bytes]:
    """Read one length-prefixed frame body (JSON or binary), None on EOF."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    n = int.from_bytes(header, "big")
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds cap {MAX_FRAME}")
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None


async def _read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    body = await _read_body(reader)
    return None if body is None else json.loads(body.decode())


#: Bulk backfill frame types deferred behind the interactive ops of
#: the same ingress wave (see _handle_conn lane priority).
_BULK_FRAMES = ("get_deltas_cols", "get_deltas", "get_snapshot_cols")


def _frame_buffered(reader: asyncio.StreamReader) -> bool:
    """True when a COMPLETE frame already sits in the stream buffer.

    The drain-batched read loops peek here: ``readexactly`` completes
    synchronously (no event-loop yield) when the buffer holds the bytes,
    so frames the kernel delivered in one wave are handled as one batch
    while flow control stays with the public StreamReader API. Reaching
    into ``_buffer`` is an asyncio-internal dependency, so fail safe:
    no buffer attribute means no batching, never an error."""
    buf = getattr(reader, "_buffer", None)
    if buf is None or len(buf) < 4:
        return False
    return len(buf) - 4 >= int.from_bytes(buf[:4], "big")


class _ClientSession:
    """Server-side state for one TCP connection."""

    def __init__(self, front: "NetworkFrontEnd",
                 writer: asyncio.StreamWriter):
        self.front = front
        self.writer = writer
        self.conn: Optional[ServerConnection] = None
        self.binary = False       # client opted into binary ops push
        self._fbinary = False     # gateway opted into binary fops push
        self._dropping = False
        self._loop = asyncio.get_running_loop()
        # gateway-mode state: sid → ServerConnection, and the doc topics
        # this gateway subscribes (each exactly once, refcounted by its
        # live sessions so the last fdisconnect unsubscribes)
        self._fsessions: dict[int, ServerConnection] = {}
        self._ftopics: dict[str, object] = {}  # topic → pubsub callbacks
        self._ftopic_refs: dict[str, int] = {}
        self._fsession_topics: dict[int, str] = {}
        # presence-lane subscriptions this session holds: (topic, fn)
        self._presence: list = []

    # -- push events (called synchronously from the pipeline drain, which
    # runs on the loop thread) --
    # a session whose unread outbound buffer passes this bound is dropped
    # (slow-consumer protection — fan-out writes are not awaited, so an
    # unread socket would otherwise buffer the doc's whole stream in RAM).
    # Snapshotted once per session: the chained config lookup was a
    # measurable cost at two checks per broadcast push.
    @functools.cached_property
    def MAX_BUFFERED(self) -> int:
        return self.front.server.config.max_buffered_bytes

    def _drop_slow_consumer(self) -> None:
        self.front.logger.error(
            "slow_consumer_dropped",
            client_id=self.conn.client_id if self.conn else None)
        self.closed()
        try:
            self.writer.close()
        except RuntimeError:
            pass

    def push(self, t: str, payload: dict) -> None:
        try:
            if self.writer.is_closing():
                return
            transport = self.writer.transport
            if transport.get_write_buffer_size() > self.MAX_BUFFERED:
                # defer the drop out of the fan-out path: closed() →
                # disconnect() re-enters the pipeline, and doing that from
                # inside a broadcast drain only works while drain iterates
                # a snapshot — schedule it instead of relying on that
                if not self._dropping:
                    self._dropping = True
                    self._loop.call_soon(self._drop_slow_consumer)
                return
            self.writer.write(_encode_frame({"t": t, **payload}))
        except RuntimeError:
            pass  # transport torn down mid-shutdown; peer is gone anyway

    def _push_op_batch(self, batch: list) -> None:
        """Encode a broadcast batch ONCE per format for all subscribers.

        The broadcaster delivers the same batch object to every session
        of the doc back to back; a one-entry cache on the front end keyed
        by (doc, first seq, len) — unique in an append-only stream —
        holds one slot per wire format, so the whole fan-out costs one
        binwire encode (+ one JSON encode ONLY if a legacy subscriber or
        an unpackable batch needs it) and N raw writes. ``False`` in the
        binary slot marks a batch that tried binwire and cannot pack
        (int outside the fixed-field range, >u16 batch) — every binary
        session then shares the JSON frame instead of re-attempting."""
        conn = self.conn
        front = self.front
        key = (conn.tenant_id, conn.document_id,
               batch[0].sequence_number, len(batch))
        cached_key, slots = front._batch_cache
        if cached_key != key:
            slots = [None, None]  # [binwire raw | False, JSON raw]
            front._batch_cache = (key, slots)
        if self.binary:
            raw = slots[0]
            if raw is None:
                try:
                    body = None
                    ctx = front._splice_ctx
                    if ctx is not None:
                        body = binwire.encode_ops_spliced(batch, *ctx)
                    if body is None:
                        body = binwire.encode_ops(batch)
                    raw = binwire.frame(body)
                except Exception:
                    raw = False
                slots[0] = raw
                front.counters.inc("net.fanout.encodes")
            else:
                front.counters.inc("net.fanout.cache_hits")
            if raw is not False:
                self.push_raw(raw)
                return
        raw = slots[1]
        if raw is None:
            raw = _encode_frame(
                {"t": "ops", "msgs": [message_to_dict(m) for m in batch]})
            slots[1] = raw
            front.counters.inc("net.fanout.encodes")
        else:
            front.counters.inc("net.fanout.cache_hits")
        self.push_raw(raw)

    def _push_abatch(self, batch) -> None:
        """Columnar twin of ``_push_op_batch`` for SequencedArrayBatch.

        The binary broadcast frame is the submit frame's column bytes
        with deli's stamp spliced on (``stamp_cols_ops``) — no per-op
        encode at all; the JSON slot materializes lazily only if a
        legacy subscriber shares the doc. Same one-entry cache, so the
        fan-out costs one splice total."""
        conn = self.conn
        front = self.front
        key = (conn.tenant_id, conn.document_id, batch.base_seq, batch.n)
        cached_key, slots = front._batch_cache
        if cached_key != key:
            slots = [None, None]  # [binwire raw | False, JSON raw]
            front._batch_cache = (key, slots)
        if self.binary:
            raw = slots[0]
            if raw is None:
                try:
                    raw = binwire.frame(
                        _stamp_abatch(batch, tenant=conn.tenant_id))
                except Exception:
                    raw = False
                slots[0] = raw
                front.counters.inc("net.fanout.encodes")
                # per-tenant fan-out accounting: once per encode (the
                # cache makes that once per batch), not per subscriber
                get_registry().inc("net.fanout.batches", batch.n,
                                   tenant=conn.tenant_id)
            else:
                front.counters.inc("net.fanout.cache_hits")
            if raw is not False:
                self.push_raw(raw)
                return
        raw = slots[1]
        if raw is None:
            raw = _encode_frame(
                {"t": "ops",
                 "msgs": [message_to_dict(m) for m in batch.messages()]})
            slots[1] = raw
            front.counters.inc("net.fanout.encodes")
        else:
            front.counters.inc("net.fanout.cache_hits")
        self.push_raw(raw)

    def push_raw(self, raw: bytes) -> None:
        try:
            if self.writer.is_closing():
                return
            transport = self.writer.transport
            if transport.get_write_buffer_size() > self.MAX_BUFFERED:
                if not self._dropping:
                    self._dropping = True
                    self._loop.call_soon(self._drop_slow_consumer)
                return
            self.writer.write(raw)
        except RuntimeError:
            pass

    def _subscribe_presence(self, topic: str) -> None:
        """Register this direct session on the doc's presence lane: one
        shared FT_PRESENCE frame for binary clients, legacy per-signal
        JSON otherwise."""
        if any(t == topic for t, _ in self._presence):
            return  # reconnect on a live socket: already registered

        def on_presence(pb):
            if self.binary:
                self.push_raw(pb.presence_frame())
            else:
                for d in pb.signal_dicts():
                    self.push("signal", {"signal": d})

        self.front.presence.subscribe(topic, on_presence)
        self._presence.append((topic, on_presence))

    @loop_only("core")
    def handle(self, frame: dict) -> None:
        t = frame.get("t")
        rid = frame.get("rid")
        try:
            if t == "connect":
                server = self.front.server_for(frame["tenant"],
                                               frame["doc"])
                readonly = bool(frame.get("readonly"))
                conn = server.connect(
                    frame["tenant"], frame["doc"], frame.get("details"),
                    token=frame.get("token"), readonly=readonly)
                if readonly:
                    # no join was ordered: nothing to flush, nothing on
                    # the op path — the whole point of the reader tier
                    self.front.counters.inc("session.readonly.connects")
                else:
                    self.front._dirty_servers.add(server)  # join appended
                self.conn = conn
                self.binary = bool(frame.get("bin"))
                self._subscribe_presence(
                    f"{frame['tenant']}/{frame['doc']}")
                # a broadcast batch rides the wire as ONE frame — at load
                # the per-op frame overhead (json + syscall each) was the
                # front end's dominant cost
                conn.on_ops = self._push_op_batch
                conn.on_abatch = self._push_abatch
                conn.on_nack = lambda n: self.push(
                    "nack", {"nack": message_to_dict(n)})
                conn.on_signal = lambda s: self.push(
                    "signal", {"signal": message_to_dict(s)})
                self.push("connected", {
                    "rid": rid,
                    "clientId": conn.client_id,
                    "seq": conn.initial_sequence_number,
                    "mode": getattr(conn, "mode", "write"),
                    "maxMessageSize": self.front.max_message_size,
                    # columnar backfill door (get_deltas_cols) — only on
                    # DIRECT core connections: the gateway relays rid
                    # replies as JSON and cannot route the binary
                    # FT_COLS_DELTAS pushes, so its own connected reply
                    # never advertises it
                    "colsBackfill": True,
                })
            elif t == "submit":
                if self.conn is None:
                    raise RuntimeError("submit before connect")
                # oversized ops nack without entering the pipeline (ref
                # 16KB limit, localDeltaConnectionServer.ts:96)
                ops = self._filter_oversized(
                    [message_from_dict(d) for d in frame["ops"]], None, None)
                ops = self._admit_or_shed(self.conn, ops, None)
                if ops:
                    self.conn.submit(ops)
                    self.front._dirty_servers.add(self.conn.server)
            elif t == "signal":
                if self.conn is None:
                    raise RuntimeError("signal before connect")
                # presence lane, not submit_signal: coalesce per
                # (doc, client, type) server-side and deliver batched on
                # the flush tick — never touches deli or the durable log
                self.front.presence.publish(
                    f"{self.conn.tenant_id}/{self.conn.document_id}",
                    Signal(client_id=self.conn.client_id,
                           type=frame.get("type", "signal"),
                           content=frame["content"]))
            elif t == "disconnect":
                if self.conn is not None:
                    self.front._dirty_servers.add(self.conn.server)
                    self.conn.disconnect()
                    self.conn = None
            elif t == "get_deltas":
                self._check_rpc_auth(frame, write=False)
                msgs = self.front.server_for(
                    frame["tenant"], frame["doc"]).get_deltas(
                    frame["tenant"], frame["doc"], frame["from"], frame["to"])
                self.push("deltas", {
                    "rid": rid, "msgs": [message_to_dict(m) for m in msgs]})
            elif t == "get_deltas_cols":
                # columnar backfill: the in-range segment blocks push as
                # raw FT_COLS_DELTAS bodies (stamped column bytes straight
                # off the storage mmap — zero re-encode), then ONE JSON
                # terminal carrying any compat-shim ops and the block
                # count so the client knows the pushes all arrived (same
                # wire, same thread: ordering is guaranteed)
                self._check_rpc_auth(frame, write=False)
                server = self.front.server_for(frame["tenant"], frame["doc"])
                res = server.get_delta_blocks(
                    frame["tenant"], frame["doc"], frame["from"], frame["to"])
                if res is None:  # no segment stream: scalar fallback
                    msgs = server.get_deltas(
                        frame["tenant"], frame["doc"],
                        frame["from"], frame["to"])
                    self.push("deltas", {
                        "rid": rid, "blocks": 0,
                        "msgs": [message_to_dict(m) for m in msgs]})
                else:
                    payloads, legacy, head = res
                    for p in payloads:
                        self.push_raw(binwire.frame(
                            binwire.cols_deltas_body(int(rid), p)))
                    self.push("deltas", {
                        "rid": rid, "blocks": len(payloads), "head": head,
                        "msgs": [message_to_dict(m) for m in legacy]})
            elif t == "get_snapshot_cols":
                self._check_rpc_auth(frame, write=False)
                self._handle_snapshot_cols(frame, rid)
            elif t in ("get_versions", "get_tree", "read_blob",
                       "write_blob", "upload_summary"):
                self._check_rpc_auth(
                    frame, write=t in ("write_blob", "upload_summary"))
                self._handle_storage(t, frame, rid)
            elif t in ("history_log", "history_at", "history_deltas"):
                self._check_rpc_auth(frame, write=False)
                self._handle_history(t, frame, rid)
            elif t in ("history_fork", "history_integrate"):
                # fork births a doc and integrate submits ops: both
                # mutate, so they ride the write scope like upload_summary
                self._check_rpc_auth(frame, write=True)
                self._handle_history(t, frame, rid)
            elif t in ("fconnect", "fsubmit", "fsignal", "fdisconnect"):
                self._handle_gateway(t, frame, rid)
            elif t in ("admin_status", "admin_docs", "admin_tenants",
                       "admin_counters", "admin_metrics_scrape",
                       "admin_slo_status", "admin_summarize",
                       "admin_tenant_add", "admin_tenant_remove",
                       "admin_placement", "admin_migrate_doc",
                       "admin_adopt_partition", "admin_core_heat",
                       "admin_tier_snapshot", "admin_rebalance_status",
                       "admin_placement_drain", "admin_migrate_part",
                       "admin_journal", "admin_metrics_history",
                       "admin_flight_dump", "admin_boot_status",
                       "admin_health"):
                self._handle_admin(t, frame, rid)
            elif t == "ping":
                # client liveness probe on an idle connection (the
                # driver's recv-timeout escalation, driver/network.py)
                self.push("pong", {})
            else:
                raise ValueError(f"unknown frame type {t!r}")
        except Exception as e:  # noqa: BLE001 — report, don't kill the loop
            self.front.logger.error("frame_error", frame_type=t,
                                    message=str(e))
            err = {"rid": rid, "message": str(e)}
            if isinstance(e, LogTruncatedError):
                # machine-readable: the driver maps this to its own
                # too-far-behind exception and switches to summary
                # catch-up instead of retrying a range that can never fill
                err["code"] = "log_truncated"
                err["base"] = e.base
                if getattr(e, "snapshot_seq", None) is not None:
                    # the snapshot-backed base: an acked summary at this
                    # seq boots the client past the hole
                    err["snapshotSeq"] = e.snapshot_seq
            elif isinstance(e, BootPending):
                # cold-start storm: the rehydration executor parked this
                # first-route — the driver retries after the hint
                # instead of surfacing a failed session
                err["code"] = "boot_pending"
                err["retryAfterMs"] = e.retry_after_ms
            self.push("error", err)

    def handle_binary(self, body: bytes) -> None:
        """Dispatch a binwire frame: the hot submit path (direct and
        gateway-muxed). Connect/signals/storage stay on the JSON path."""
        try:
            ftype = body[1]
            if ftype == binwire.FT_SUBMIT:
                if self.conn is None:
                    raise RuntimeError("submit before connect")
                _, ops, spans, blob, npool = binwire.decode_submit(
                    body, with_spans=True)
                ops = self._filter_oversized(ops, len(body), None)
                ops = self._admit_or_shed(self.conn, ops, None,
                                          nbytes=len(body))
                if ops:
                    _stamp_admit(ops)
                    # expose the splice context for the SYNCHRONOUS
                    # broadcast this submit triggers: the encoder reuses
                    # the submitted payload bytes instead of re-packing
                    self.front._splice_ctx = (spans, blob, npool)
                    try:
                        self.conn.submit(ops)
                    finally:
                        self.front._splice_ctx = None
                    self.front._dirty_servers.add(self.conn.server)
            elif ftype == binwire.FT_FSUBMIT:
                sid, ops, spans, blob, npool = binwire.decode_submit(
                    body, with_spans=True)
                conn = self._fsessions[sid]
                ops = self._filter_oversized(ops, len(body), sid)
                ops = self._admit_or_shed(conn, ops, sid,
                                          nbytes=len(body))
                if ops:
                    _stamp_admit(ops)
                    self.front._splice_ctx = (spans, blob, npool)
                    try:
                        conn.submit(ops)
                    finally:
                        self.front._splice_ctx = None
                    self.front._dirty_servers.add(conn.server)
            elif (ftype == binwire.FT_COLS_SUBMIT
                  or ftype == binwire.FT_COLS_FSUBMIT):
                self._submit_columns(body)
            else:
                raise ValueError(f"unexpected binary frame type {ftype}")
        except Exception as e:  # noqa: BLE001 — report, don't kill the loop
            self.front.logger.error("frame_error", frame_type="binary",
                                    message=str(e))
            self.push("error", {"message": str(e)})

    def _filter_oversized(self, ops: list, body_len: Optional[int],
                          sid) -> list:
        """Enforce the per-op service limit; nack what exceeds it.

        The limit is DEFINED as JSON size (so one op is admitted or
        nacked identically through either door); JSON callers pass
        ``body_len=None`` and every op is measured. Binary callers pass
        the frame length for a fast path: binwire is more compact than
        JSON — \\uXXXX escaping inflates a control/non-ASCII byte up to
        6× and the envelope keys add ~200 bytes — so a whole boxcar body
        under (limit - 512) / 6 cannot contain an op whose JSON measure
        exceeds the limit. Typical boxcars (KBs) pass in one comparison;
        only outsized frames pay per-op JSON dumps."""
        limit = self.front.max_message_size
        if body_len is not None and 6 * body_len + 512 <= limit:
            return ops
        kept = []
        for op in ops:
            d = message_to_dict(op)
            if len(json.dumps(d).encode()) > limit:
                nack = Nack(
                    operation=op, sequence_number=-1, code=413,
                    type=NackErrorType.BAD_REQUEST,
                    message=f"message exceeds {limit} byte limit")
                if sid is None:
                    self.push("nack", {"nack": message_to_dict(nack)})
                else:
                    self.push("fnack", {"sid": sid,
                                        "nack": message_to_dict(nack)})
            else:
                kept.append(op)
        return kept

    def _admit_or_shed(self, conn, ops: list, sid,
                       nbytes: int = 0) -> list:
        """THE admission gate: every rec-lane submit door passes its
        ops through here after the size filter (the columnar door runs
        the same check on its packed columns in ``_submit_columns``).
        Also the per-tenant ingress accounting point — one labeled
        registry inc per boxcar, never per op — and the per-partition
        heat recording point the rebalancer plans from (admitted ops
        only: shed traffic is load the partition did NOT carry)."""
        if not ops:
            return ops
        # synthetic canary traffic (obs/probe.py) rides the real door
        # but is invisible to the control loops: no ingress accounting,
        # no tenant bucket charge, no partition heat — probing can
        # never shed a tenant or trigger a rebalance. The seal bounce
        # DOES apply: a canary on a migrating partition should observe
        # exactly what a client would.
        canary = conn.tenant_id == CANARY_TENANT
        if not canary:
            get_registry().inc("net.ingress.ops", len(ops),
                               tenant=conn.tenant_id)
        if getattr(conn.server, "sealed", False):
            # partition mid-migration: the sharded core's bounce on the
            # shed-retry lane (the port's LocalServer is never sealed)
            raise _not_ported("migration seal", "A10")
        adm = self.front.admission
        if adm is not None and not canary:
            retry_s = adm.check(conn, len(ops),
                                ops[0].client_sequence_number)
            if retry_s > 0.0:
                self._push_shed_nacks(ops, retry_s, sid)
                return []
        if not canary:
            self.front.record_heat(conn.server, len(ops), nbytes)
        return ops

    def _push_shed_nacks(self, ops: list, retry_s: float, sid,
                         message: str = "tenant over admission "
                                        "budget") -> None:
        """Shed a whole boxcar through the shared nack door: one
        THROTTLING nack per op carrying the op itself plus
        ``retry_after_ms``, pushed over the same wire (or fnack-muxed
        for gateway clients) as every other refusal — the driver
        resubmits transparently after the backoff."""
        ms = retry_after_ms(retry_s)
        for op in ops:
            nack = Nack(
                operation=op, sequence_number=-1, code=429,
                type=NackErrorType.THROTTLING,
                message=message,
                retry_after_ms=ms)
            if sid is None:
                self.push("nack", {"nack": message_to_dict(nack)})
            else:
                self.push("fnack", {"sid": sid,
                                    "nack": message_to_dict(nack)})

    def _submit_columns(self, body: bytes) -> None:
        """Columnar ingress: hand a submit boxcar to deli's array lane
        with the op payload still in packed columns.

        Bulk admission happens in two vectorized stages, each with a
        per-op scalar fallback so nack semantics are byte-identical to
        the rec path: the front end verifies writability and the
        boxcar-level size bound here (failure → materialize +
        ``_filter_oversized`` + ``conn.submit``, same as a rec frame);
        deli's ``_ticket_array_boxcar`` verifies join/clientSeq/refSeq
        on the columns and falls back to the scalar ``_ticket`` loop
        itself when they don't hold. The admitted path never builds a
        per-op object: the columns become an ArrayBoxcar (frombuffer
        views) carrying the frame's column bytes for splice-stamped
        fan-out (``_push_abatch``)."""
        front = self.front
        sid, sc, hops = binwire.decode_submit_columns(body, with_hops=True)
        if sid is None:
            conn = self.conn
            if conn is None:
                raise RuntimeError("submit before connect")
        else:
            conn = self._fsessions[sid]
        n = len(sc.cseq)
        if n:
            # canary isolation, columnar door: same seams as
            # _admit_or_shed (no accounting, no bucket, no heat)
            canary = conn.tenant_id == CANARY_TENANT
            if not canary:
                get_registry().inc("net.ingress.ops", n,
                                   tenant=conn.tenant_id)
            if getattr(conn.server, "sealed", False):
                # mid-migration bounce (sharded core only)
                raise _not_ported("migration seal", "A10")
            adm = front.admission
            if adm is not None and not canary:
                retry_s = adm.check(conn, n, int(sc.cseq[0]))
                if retry_s > 0.0:
                    # shed is the cold path: materialize the ops once
                    # so the per-op nacks are byte-identical to the
                    # rec door's
                    self._push_shed_nacks(binwire.cols_to_ops(sc),
                                          retry_s, sid)
                    return
            if not canary:
                front.record_heat(conn.server, n, len(body))
        limit = front.max_message_size
        if (getattr(conn, "can_write", True)
                and 6 * len(body) + 512 <= limit):
            if hops:
                # sampled frame: stamp frontend/admit; downstream tiers
                # append to the same list and the egress encode packs it
                hops.append((HOP_ADMIT, time.time()))
            box = ArrayBoxcar(
                tenant_id="", document_id="", client_id="",
                ds_id=sc.ds_id, channel_id=sc.channel_id,
                kind=sc.kind, a=sc.a, b=sc.b, cseq=sc.cseq, rseq=sc.rseq,
                text=sc.text, text_off=sc.text_off, props=sc.props,
                wire_cols=sc.cols, hops=hops or None)
            conn.submit_array(box)
            front.counters.inc("net.ingress.columnar")
        else:
            # read-only connections nack PER OP through the scalar door
            # (the array door nacks once per boxcar); oversize frames
            # need the per-op JSON measure anyway
            ops = self._filter_oversized(binwire.cols_to_ops(sc),
                                         None, sid)
            if ops:
                conn.submit(ops)
            front.counters.inc("net.ingress.fallback")
        front._dirty_servers.add(conn.server)

    def _handle_gateway(self, t: str, frame: dict, rid) -> None:
        """Backbone mux for a gateway connection (see module docstring).

        The key property: broadcast fan-out to this gateway is ONE fops
        frame per batch per doc, not per client — the per-connection
        subscription server.connect() made is replaced by a per-topic
        subscription owned by this gateway session."""
        if t == "fconnect":
            sid = frame["sid"]
            from .broadcaster import BroadcasterLambda

            tenant, doc = frame["tenant"], frame["doc"]
            server = self.front.server_for(tenant, doc)
            # validate BEFORE creating the topic subscription: a refused
            # connect must not leak a subscription. Require only read
            # scope here — server.connect() below assigns read/write mode
            # from the token exactly as the direct door does, so a
            # read-only token gets a read-mode connection, not a refusal.
            if server.tenants is not None:
                raise _not_ported("tenant token validation", "A10")
            topic = BroadcasterLambda.topic(tenant, doc)
            self._fbinary = bool(frame.get("bin"))
            # the gateway's topic subscription must exist BEFORE the join
            # is ordered: connect() sequences + broadcasts the join
            # synchronously, and a lone client that misses its own join
            # never activates (nothing later triggers gap repair)
            if topic not in self._ftopics:
                if self._fbinary:
                    def on_batch(batch, topic=topic):
                        # one binwire encode per batch, shared across
                        # gateways via the front-end fops cache; a
                        # SequencedArrayBatch (columnar array lane)
                        # splice-stamps its column bytes instead
                        if type(batch) is not list:
                            key = (topic, batch.base_seq, batch.n)
                            ck, raw = self.front._fops_cache
                            if ck != key:
                                try:
                                    raw = binwire.frame(
                                        _stamp_abatch(batch, topic=topic))
                                except Exception:
                                    raw = None  # unpackable: JSON
                                self.front._fops_cache = (key, raw)
                                self.front.counters.inc(
                                    "net.fanout.encodes")
                                get_registry().inc(
                                    "net.fanout.batches", batch.n,
                                    tenant=topic.partition("/")[0])
                            else:
                                self.front.counters.inc(
                                    "net.fanout.cache_hits")
                            if raw is not None:
                                self.push_raw(raw)
                            else:
                                self.push("fops", {
                                    "topic": topic,
                                    "msgs": [message_to_dict(m)
                                             for m in batch.messages()]})
                            return
                        key = (topic, batch[0].sequence_number, len(batch))
                        ck, raw = self.front._fops_cache
                        if ck != key:
                            try:
                                body = None
                                ctx = self.front._splice_ctx
                                if ctx is not None:
                                    body = binwire.encode_ops_spliced(
                                        batch, *ctx, topic=topic)
                                if body is None:
                                    body = binwire.encode_ops(batch,
                                                              topic=topic)
                                raw = binwire.frame(body)
                            except Exception:
                                raw = None  # unpackable: JSON fallback
                            self.front._fops_cache = (key, raw)
                            self.front.counters.inc("net.fanout.encodes")
                        else:
                            self.front.counters.inc("net.fanout.cache_hits")
                        if raw is not None:
                            self.push_raw(raw)
                        else:
                            self.push("fops", {
                                "topic": topic,
                                "msgs": [message_to_dict(m) for m in batch]})
                else:
                    def on_batch(batch, topic=topic):
                        msgs = (batch if type(batch) is list
                                else batch.messages())
                        self.push("fops", {
                            "topic": topic,
                            "msgs": [message_to_dict(m) for m in msgs]})
                server.pubsub.subscribe(topic, on_batch)

                def on_signal(sig, topic=topic):
                    self.push("fsignal", {
                        "topic": topic, "signal": message_to_dict(sig)})
                server.pubsub.subscribe(f"signal/{tenant}/{doc}", on_signal)

                def on_presence(pb, topic=topic):
                    # one FT_FPRESENCE frame per flush shared by every
                    # backbone link; relays strip the topic by splice
                    if self._fbinary:
                        self.push_raw(pb.fpresence_frame())
                    else:
                        for d in pb.signal_dicts():
                            self.push("fsignal",
                                      {"topic": topic, "signal": d})
                self.front.presence.subscribe(topic, on_presence)
                self._ftopics[topic] = (on_batch, on_signal,
                                        f"signal/{tenant}/{doc}", server,
                                        on_presence)
            readonly = bool(frame.get("readonly"))
            conn = server.connect(tenant, doc, frame.get("details"),
                                  token=frame.get("token"),
                                  readonly=readonly)
            if readonly:
                self.front.counters.inc("session.readonly.connects")
            else:
                self.front._dirty_servers.add(server)  # join was appended
            self._fsessions[sid] = conn
            self._fsession_topics[sid] = topic
            self._ftopic_refs[topic] = self._ftopic_refs.get(topic, 0) + 1
            # drop the per-connection op/signal subscriptions (the topic
            # subscription above covers them ONCE per gateway — and their
            # handler-less buffers would otherwise grow unbounded); nacks
            # stay per-connection, routed by sid
            server.pubsub.unsubscribe(topic, conn._op_cb)
            server.pubsub.unsubscribe(f"signal/{tenant}/{doc}", conn._sig_cb)
            conn.on_nack = lambda n, sid=sid: self.push(
                "fnack", {"sid": sid, "nack": message_to_dict(n)})
            self.push("fconnected", {
                "rid": rid, "sid": sid,
                "clientId": conn.client_id,
                "seq": conn.initial_sequence_number,
                "mode": getattr(conn, "mode", "write"),
                "maxMessageSize": self.front.max_message_size,
            })
        elif t == "fsubmit":
            conn = self._fsessions[frame["sid"]]
            # same 16 KB service limit as the direct door
            ops = self._filter_oversized(
                [message_from_dict(d) for d in frame["ops"]], None,
                frame["sid"])
            ops = self._admit_or_shed(conn, ops, frame["sid"])
            if ops:
                conn.submit(ops)
                self.front._dirty_servers.add(conn.server)
        elif t == "fsignal":
            conn = self._fsessions[frame["sid"]]
            self.front.presence.publish(
                f"{conn.tenant_id}/{conn.document_id}",
                Signal(client_id=conn.client_id,
                       type=frame.get("type", "signal"),
                       content=frame["content"]))
        elif t == "fdisconnect":
            sid = frame["sid"]
            conn = self._fsessions.pop(sid, None)
            if conn is not None:
                self.front._dirty_servers.add(conn.server)
                conn.disconnect()
            topic = self._fsession_topics.pop(sid, None)
            if topic is not None:
                self._ftopic_refs[topic] -= 1
                if self._ftopic_refs[topic] == 0:
                    # the gateway's last session on this doc is gone:
                    # stop encoding/pushing its broadcasts
                    del self._ftopic_refs[topic]
                    self._unsubscribe_ftopic(topic)

    def _check_rpc_auth(self, frame: dict, write: bool) -> None:
        """Tenancy applies to the REST-role endpoints too: delta backfill
        and storage reads need doc:read, blob/summary writes need
        doc:write — otherwise a tokenless connection could read a secured
        doc's whole op stream or write into its storage."""
        if self.front.server.tenants is not None:
            raise _not_ported("tenant token validation", "A10")

    def _handle_snapshot_cols(self, frame: dict, rid) -> None:
        """Encode-once snapshot serving: push the latest snapcols
        version's chunks as FT_COLS_SNAP frames spliced from a
        per-(doc, version) cache of ALREADY-FRAMED bytes, then one JSON
        terminal with the version header. 10k joiners of the same doc get
        byte-identical splices — the cache frames each chunk exactly once
        per version (``storage.snapshot.encodes``), like the broadcast
        fan-out cache. Chunks the client proves it holds (``have``:
        content-addressed hashes from its snapshot cache) are skipped
        entirely. Chunk frames carry rid 0: the content hash, not the
        request, identifies the bytes — that rid-independence is what
        makes the cached frames shareable across joiners."""
        front = self.front
        tenant, doc = frame["tenant"], frame["doc"]
        storage = front.server_for(tenant, doc).storage(tenant, doc)
        versions = storage.get_versions(1)
        if not versions:
            self.push("snapshot", {"rid": rid, "version": None})
            return
        version = versions[0]
        entry = front._snap_cache.get((tenant, doc))
        if entry is None or entry[0] != version["id"]:
            root = json.loads(storage.read_blob(version["tree_id"]).decode())
            if root.get("t") != "snapcols":
                # pre-columnar summary at head: the client boots through
                # the legacy tree shim instead
                self.push("snapshot", {"rid": rid,
                                       "version": version["id"],
                                       "legacy": True})
                return
            framed = {h: binwire.frame(binwire.snap_chunk_body(
                0, h, storage.read_blob(h))) for h in root["chunks"]}
            entry = (version["id"], framed, root)
            front._snap_cache[(tenant, doc)] = entry
            front.counters.inc("storage.snapshot.encodes")
        else:
            front.counters.inc("storage.snapshot.cache_hits")
        vid, framed, root = entry
        have = set(frame.get("have") or ())
        sent = 0
        for h in root["chunks"]:
            if h in have:
                continue
            self.push_raw(framed[h])
            sent += 1
        front.counters.inc("storage.snapshot.served")
        self.push("snapshot", {
            "rid": rid, "version": vid, "chunks": list(root["chunks"]),
            "sent": sent, "seq": root["sequence_number"],
            "tree_seq": root["tree_seq"], "min_seq": root["min_seq"],
            "protocol": root["protocol"], "pkg": root["pkg"],
            "ds": root["ds"], "channel": root["channel"]})

    def _handle_storage(self, t: str, frame: dict, rid) -> None:
        storage = self.front.server_for(
            frame["tenant"], frame["doc"]).storage(
            frame["tenant"], frame["doc"])
        if t == "get_versions":
            self.push("versions", {
                "rid": rid,
                "versions": storage.get_versions(frame.get("count", 1))})
        elif t == "get_tree":
            # legacy shim: whole-tree JSON materialization per join — the
            # deprecation counter is the migration's progress gauge
            self.front.counters.inc("storage.snapshot.legacy_tree")
            self.push("tree", {
                "rid": rid,
                "tree": storage.get_snapshot_tree(frame.get("version"))})
        elif t == "read_blob":
            self.push("blob", {
                "rid": rid, "hex": storage.read_blob(frame["id"]).hex()})
        elif t == "write_blob":
            self.push("blob_id", {
                "rid": rid,
                "id": storage.write_blob(bytes.fromhex(frame["hex"]))})
        elif t == "upload_summary":
            self.push("version_id", {
                "rid": rid,
                "id": storage.upload_summary(frame["summary"],
                                             frame.get("parent"))})

    @loop_only("core")
    def _handle_history(self, t: str, frame: dict, rid) -> None:
        """Doc history doors onto the history plane. ``history_log``
        pushes each commit as one binary FT_HISTORY frame (the same
        refgraph codec the ref files use, so the driver exercises the
        torn-tail framing end to end) then a JSON terminal carrying the
        refs and the count — same wire, same thread, ordering holds.
        The other doors are plain JSON request/reply. Historical boots
        themselves ride the EXISTING storage doors (``get_tree`` with an
        explicit version) so replay adds no second snapshot path."""
        tenant, doc = frame["tenant"], frame["doc"]
        history = self.front.server_for(tenant, doc).history
        if t == "history_log":
            commits = history.log(tenant, doc, frame.get("count"))
            for c in commits:
                self.push_raw(binwire.frame(
                    binwire.encode_history_commit(int(rid), c)))
            self.push("history", {
                "rid": rid, "commits": len(commits),
                "refs": history.refs(tenant, doc)})
        elif t == "history_at":
            self.push("history", {
                "rid": rid,
                "at": history.replay_read(tenant, doc, frame["seq"])})
        elif t == "history_deltas":
            msgs = history.read_deltas(
                tenant, doc, frame["from"], frame["to"])
            self.push("history", {
                "rid": rid, "msgs": [message_to_dict(m) for m in msgs]})
        elif t == "history_fork":
            res = history.fork(tenant, doc, at_seq=frame.get("seq"),
                               new_doc=frame.get("new_doc"))
            self.push("history", {"rid": rid, "fork": res})
        elif t == "history_integrate":
            res = history.integrate(tenant, doc,
                                    batch=frame.get("batch", 64))
            self.push("history", {"rid": rid, "integrate": res})

    @loop_only("core")
    def _handle_admin(self, t: str, frame: dict, rid) -> None:
        """Management surface (ref: server/admin + riddler's
        tenantManager REST): per-doc pipeline status, doc listing, and
        tenant CRUD, secured by ``--admin-secret`` whenever one is set
        (and ALWAYS required once tenancy is enforcing — an open admin
        door next to secured tenants would be a bypass)."""
        front = self.front
        secret = front.admin_secret
        tenants = front.server.tenants
        if secret is not None:
            import hmac as _hmac

            if not _hmac.compare_digest(str(frame.get("secret") or ""),
                                        secret):
                raise PermissionError("bad admin secret")
        elif tenants is not None and tenants.enforcing:
            raise PermissionError(
                "admin surface requires --admin-secret on a secured "
                "deployment")
        if secret is None and t in ("admin_tenant_add",
                                    "admin_tenant_remove"):
            # no open bootstrap: on a secret-less deployment ANY client
            # could otherwise register the first tenant, flip tenancy to
            # enforcing, and lock every other client out
            raise PermissionError(
                "mutating admin calls require --admin-secret")
        if t == "admin_status":
            tenant, doc = frame["tenant"], frame["doc"]
            server = front.server_for(tenant, doc)
            orderer = server._orderers.get(f"{tenant}/{doc}")
            if orderer is None:
                self.push("admin", {"rid": rid, "status": None})
                return
            deli = orderer.deli
            clients = [
                {"clientId": c.client_id,
                 "clientSeq": c.client_sequence_number,
                 "refSeq": c.reference_sequence_number}
                for c in deli.clients.values()]
            msn = min((c.reference_sequence_number
                       for c in deli.clients.values()),
                      default=deli.sequence_number)
            self.push("admin", {"rid": rid, "status": {
                "tenant": tenant, "doc": doc,
                "seq": deli.sequence_number,
                "msn": msn,
                "clients": clients,
                "summaryHead": orderer.scribe.last_summary_head,
                "retainedBase": orderer.scriptorium.retained_base(
                    tenant, doc),
                "applierSeq": front.applier_status.get((tenant, doc)),
            }})
        elif t == "admin_docs":
            docs = []
            for server in front._all_servers():
                docs.extend(sorted(server._orderers))
            self.push("admin", {"rid": rid, "docs": docs})
        elif t == "admin_tenants":
            self.push("admin", {
                "rid": rid,
                "tenants": tenants.list_tenants() if tenants else []})
        elif t == "admin_counters":
            # read-only: the socket-tier batching counters, so bench and
            # soak can assert coalescing/flush-eliding actually engaged
            self.push("admin", {"rid": rid,
                                "counters": front.counters.snapshot()})
        elif t == "admin_metrics_scrape":
            # read-only: the process-wide registry as Prometheus text —
            # every live tier Counters plus the labeled hop-pair series
            self.push("admin", {"rid": rid,
                                "scrape": get_registry().scrape()})
        elif t == "admin_slo_status":
            # read-only: per-spec health rows from the SLO engine (the
            # `admin slo` CLI view); no engine → empty list, not an error
            engine = front.slo_engine
            self.push("admin", {
                "rid": rid,
                "slos": engine.status() if engine is not None else [],
                "shedding": (front.admission.shedding
                             if front.admission is not None else False)})
        elif t == "admin_summarize":
            # force ONE service summary now — the operator/bench door
            # onto the same machinery as the --summarize-every loop.
            # Synchronous by design (a loop tick blocks this event loop
            # identically): the reply returns only once the version is
            # committed and flushed, so the caller can immediately boot
            # a joiner through it. Not in the no-secret mutating set:
            # it only materializes state the op stream already holds.
            tenant, doc = frame["tenant"], frame["doc"]
            server = front.server_for(tenant, doc)
            if server._orderers.get(f"{tenant}/{doc}") is None:
                # non-creating lookup (like admin_status): a typo'd doc
                # must not be born as an empty committed summary
                raise ValueError(f"unknown doc {tenant}/{doc}")
            version = front._summarizer_for(server).summarize_doc(
                tenant, doc)
            if front._log_flush and hasattr(server.log, "flush"):
                server.log.flush()
            get_journal().emit("summary.commit", tenant=tenant, doc=doc,
                               version=version, forced=True)
            self.push("admin", {"rid": rid, "version": version})
        elif t == "admin_tenant_add":
            # the tenant registry (riddler role) comes with ROADMAP A10
            raise _not_ported("tenant registry", "A10")
        elif t == "admin_tenant_remove":
            self.push("admin", {"rid": rid, "ok": False})
        elif t in ("admin_placement", "admin_core_heat"):
            # read-only views of the sharded core's routing plane: a
            # single-pipeline core has none
            key = "placement" if t == "admin_placement" else "heat"
            self.push("admin", {"rid": rid, key: None})
        elif t in ("admin_migrate_doc", "admin_adopt_partition",
                   "admin_placement_drain", "admin_migrate_part"):
            raise ValueError("not a sharded core")
        elif t == "admin_tier_snapshot":
            # read-only: one tier's per-process counter sums — the
            # fleet-aggregation building block (obs.sum_counter_snapshots
            # over every core's reply = fleet totals)
            from ..obs import tier_snapshot

            self.push("admin", {
                "rid": rid,
                "counters": tier_snapshot(str(frame["tier"]))})
        elif t == "admin_rebalance_status":
            self.push("admin", {"rid": rid, "rebalance": {"armed": False}})
        elif t == "admin_journal":
            # read-only: this core's audit-journal tail (the `admin
            # journal` CLI and the fleet merge both read this); a
            # disarmed journal answers empty rather than erroring so a
            # fleet fan-out over mixed deployments still completes
            jr = get_journal()
            part = frame.get("part")
            entries = jr.tail(
                n=int(frame.get("n", 100)),
                kind=frame.get("kind") or None,
                doc=frame.get("doc"),
                part=int(part) if part is not None else None)
            self.push("admin", {"rid": rid, "journal": {
                "armed": jr.armed, "core": jr.core, "path": jr.path,
                "entries": entries}})
        elif t == "admin_metrics_history":
            # read-only: the windowed series' retained history rings.
            # Points are stamped on THIS process's monotonic clock, so
            # both clocks ride along and the caller rebases:
            # wall = now_wall - (now_mono - t)
            self.push("admin", {
                "rid": rid,
                "history": get_registry().window_history(
                    frame.get("name")),
                "now_mono": time.monotonic(),
                "now_wall": time.time()})
        elif t == "admin_boot_status":
            # read-only: this core's cold-start rehydration progress —
            # per-partition booted/pending docs, executor depth, and the
            # process's boot.part.* counters (tier-summed: the orderers
            # count on their own frontend-tier sheet, not front.counters)
            from ..obs import tier_snapshot

            boot_counts = {k: v
                           for k, v in tier_snapshot("frontend").items()
                           if k.startswith(("boot.part.", "topology."))}
            # one partition, booted eagerly: lazy boot and its executor
            # come with the sharded core (ROADMAP A10)
            parts = [{"part": None,
                      "docs_booted": len(front.server._orderers),
                      "docs_pending": 0}]
            self.push("admin", {"rid": rid, "boot": {
                "owner": None,
                "parts": parts,
                "executor": None,
                "counters": boot_counts}})
        elif t == "admin_flight_dump":
            # operator door onto the flight recorder: dump the rings NOW
            # (incident in progress, evidence wanted before it scrolls
            # out) and journal the dump so the bundle joins both
            jr = get_journal()
            op_id = jr.emit("operator.command", command=t,
                            reason=frame.get("reason") or "operator")
            path = get_recorder().dump(
                "operator", detail=frame.get("reason") or "operator")
            dump_id = jr.emit("flight.dump", cause=op_id,
                              reason="operator", path=path)
            self.push("admin", {"rid": rid, "path": path,
                                "journal": dump_id})
        elif t == "admin_health":
            # the streaming doctor (--probe) comes with ROADMAP A10: an
            # unarmed core answers verdict="unknown", as the JAX core does
            if frame.get("fleet"):
                raise _not_ported("fleet health", "A10")
            self.push("admin", {"rid": rid, "health": {
                "core": "", "verdict": "unknown", "components": {},
                "armed": False}})

    def _unsubscribe_ftopic(self, topic: str) -> None:
        entry = self._ftopics.pop(topic, None)
        if entry is not None:
            on_batch, on_signal, sig_topic, server, on_presence = entry
            pubsub = server.pubsub
            pubsub.unsubscribe(topic, on_batch)
            pubsub.unsubscribe(sig_topic, on_signal)
            self.front.presence.unsubscribe(topic, on_presence)

    def closed(self) -> None:
        if self.conn is not None:
            self.front._dirty_servers.add(self.conn.server)
            self.conn.disconnect()
            self.conn = None
        for conn in self._fsessions.values():
            self.front._dirty_servers.add(conn.server)
            conn.disconnect()
        self._fsessions.clear()
        self._fsession_topics.clear()
        self._ftopic_refs.clear()
        for topic in list(self._ftopics):
            self._unsubscribe_ftopic(topic)
        for topic, fn in self._presence:
            self.front.presence.unsubscribe(topic, fn)
        self._presence.clear()


class NetworkFrontEnd:
    """Owns the LocalServer pipeline and serves it over TCP.

    ``start_background()`` runs the event loop (and thus the whole
    pipeline) on a dedicated thread — the in-process deployment.
    ``serve_forever()`` blocks — the subprocess deployment
    (``python -m fluidframework_tpu_torch.service.front_end``).

    The sharded core (``shard_host``) is not ported (ROADMAP A10).
    """

    def __init__(self, server: Optional[LocalServer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_message_size: Optional[int] = None,
                 shard_host=None,
                 admin_secret: Optional[str] = None):
        if shard_host is not None:
            raise _not_ported("sharded core (shard_host)", "A10")
        self.admin_secret = admin_secret
        self.server = server if server is not None else LocalServer()
        self.logger = self.server.logger.child("front_end")
        self.host = host
        self.port = port
        # service limits come from the unified config registry unless a
        # caller overrides explicitly
        self.max_message_size = (
            max_message_size if max_message_size is not None
            else self.server.config.max_message_size)
        # (key, [binwire raw | False, JSON raw]) — one entry, one slot
        # per wire format (see _ClientSession._push_op_batch)
        self._batch_cache: tuple = (None, [None, None])
        self._fops_cache: tuple = (None, b"")
        # (tenant, doc) → (version_id, {chunk_hash: framed bytes}, root):
        # the encode-once snapshot serving cache (_handle_snapshot_cols)
        self._snap_cache: dict = {}
        # service-summarizer loop (enable_summarizer): per-LocalServer
        # summarizer instances + the ops-per-summary threshold
        self.summarize_every: Optional[int] = None
        self._summarizers: dict = {}
        # socket-tier batching telemetry (net.ingress.*, net.flush.*,
        # net.fanout.*), served read-only by the admin_counters RPC and
        # aggregated under tier="frontend" by the registry scrape
        self.counters = tier_counters("frontend")
        # ephemeral signal tier: network-origin signals coalesce here
        # per (doc, client, type) and batch out on the presence tick —
        # they never touch deli or the durable log (service/presence.py)
        self.presence = PresenceLane(self.counters)
        # partition servers dirtied by the current ingress batch; the
        # batch flushes exactly these (see _flush_dirty)
        self._dirty_servers: set = set()
        # splice context of the binary submit currently on the stack
        # (handle_binary sets it around conn.submit)
        self._splice_ctx: Optional[tuple] = None
        # split-service composition (stage_runner.py): stage backchannel
        # logs this core consumes, and whether the shared log needs
        # visibility flushes for external consumers
        self._backchannels: list = []
        self._bg_tasks: list = []  # strong refs; the loop's are weak
        self._log_flush = hasattr(self.server.log, "flush")
        # (tenant, doc) → applied seq reported by an applier stage
        self.applier_status: dict = {}
        # overload-control loop: the admission gate stays None (one
        # attribute check on the submit path) until a tenant rate or an
        # SLO engine is attached
        self.admission: Optional[AdmissionController] = None
        self.slo_engine = None
        # live _ClientSessions
        self._sessions: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._aio_server: Optional[asyncio.base_events.Server] = None

    def enable_admission(self) -> AdmissionController:
        """The admission gate: its per-tenant rates live in the tenant
        registry, and its burn signal in the SLO engine (ROADMAP A10)."""
        raise _not_ported("admission control", "A10")

    def attach_slo(self, engine, shedding: bool = True) -> "NetworkFrontEnd":
        raise _not_ported("SLO engine", "A10")

    def enable_boot_admission(self, boots_per_s: float = 200.0,
                              burst: int = 32) -> "NetworkFrontEnd":
        raise _not_ported("boot-storm admission (lazy boot)", "A10")

    def record_heat(self, server, n_ops: int, n_bytes: int) -> None:
        """Per-partition load accounting (the rebalancer's input).
        Single-pipeline deployments have no ``part_k`` and record nothing
        — there is nowhere to rebalance to."""
        if getattr(server, "part_k", None) is not None:
            raise _not_ported("partition heat", "A10")

    def enable_rebalancer(self, tick_s: float = 0.5,
                          dwell_s: float = 10.0, budget: int = 2,
                          improvement: float = 0.25) -> "NetworkFrontEnd":
        raise _not_ported("placement rebalancer", "A10")

    def enable_health(self, probe_tick_s: float = 2.0,
                      tick_s: float = 1.0, critical_ticks: int = 3,
                      probe_fail_critical: int = 3,
                      probe_timeout: float = 5.0,
                      max_route_peers: int = 2) -> "NetworkFrontEnd":
        raise _not_ported("live health plane (--probe)", "A10")

    def server_for(self, tenant: str, doc: str) -> LocalServer:
        """The LocalServer serving this doc: the single pipeline."""
        return self.server

    def _all_servers(self):
        return [self.server]

    def _flush_logs(self) -> None:
        for server in self._all_servers():
            if hasattr(server.log, "flush"):
                server.log.flush()

    def _flush_dirty(self) -> None:
        """Flush only the logs the current ingress batch dirtied.

        The old per-frame path flushed EVERY partition's log on every
        frame — at 2 cores each frame paid for all shards (the sharded
        regression's prime suspect). Read-only batches (pings, storage
        RPCs, signals) flush nothing at all."""
        dirty = self._dirty_servers
        n_all = 1
        if not dirty:
            self.counters.inc("net.flush.elided", n_all)
            return
        flushed = 0
        for server in dirty:
            log = server.log
            if hasattr(log, "flush"):
                try:
                    log.flush()
                except OSError:
                    continue  # partition revoked mid-teardown
                flushed += 1
        dirty.clear()
        self.counters.inc("net.flush.performed", flushed)
        if n_all > flushed:
            self.counters.inc("net.flush.elided", n_all - flushed)

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        import socket as _socket

        sock = writer.get_extra_info("socket")
        if sock is not None:
            # small latency-bound frames: disable Nagle coalescing
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        session = _ClientSession(self, writer)
        self._sessions.add(session)
        counters = self.counters
        recorder = get_recorder()
        conn_id = f"fe-{id(session) & 0xFFFFFF:06x}"
        try:
            while True:
                body = await _read_body(reader)
                if body is None:
                    break
                # drain-batched serving: every frame already buffered on
                # this socket is handled as ONE batch, then the dirtied
                # logs flush and the writer drains once for the whole
                # wave — the old per-frame flush+drain was the dominant
                # fixed cost of the socket tier. The cap keeps one hot
                # connection from starving its peers on the loop.
                n = 0
                deferred: list = []
                while body is not None:
                    n += 1
                    recorder.frame(conn_id, "in", body)
                    if binwire.is_binary(body):
                        session.handle_binary(body)
                    else:
                        frame = json.loads(body.decode())
                        if frame.get("t") in _BULK_FRAMES:
                            # lane priority: bulk backfill yields to the
                            # interactive ops of the same wave — a
                            # catch-up client's multi-MB range read must
                            # not sit between a submit and its ack
                            deferred.append(frame)
                        else:
                            session.handle(frame)
                    body = None
                    if n < 64 and _frame_buffered(reader):
                        # completes synchronously — the bytes are
                        # already in the stream buffer
                        body = await _read_body(reader)
                for frame in deferred:
                    session.handle(frame)
                if deferred:
                    counters.inc("net.ingress.deprioritized",
                                 len(deferred))
                counters.inc("net.ingress.frames", n)
                counters.inc("net.ingress.batches")
                if n > 1:
                    counters.inc("net.ingress.coalesced", n - 1)
                if self._log_flush:
                    # make this batch's appends visible to the stage
                    # processes tailing the shared log
                    self._flush_dirty()
                await writer.drain()
        except (ValueError, json.JSONDecodeError):
            pass  # malformed stream: drop the connection
        except (ConnectionResetError, BrokenPipeError):
            pass  # client died mid-frame: treat like a clean close
        except Exception as e:  # noqa: BLE001 — unhandled tier failure:
            # the per-frame handlers catch their own errors, so anything
            # arriving here escaped the serving machinery itself. Dump
            # the flight rings before dropping the connection.
            self.logger.error("conn_unhandled", message=str(e))
            try:
                path = recorder.dump("frontend_unhandled", conn=conn_id,
                                     error=str(e))
                get_journal().emit("flight.dump",
                                   reason="frontend_unhandled",
                                   path=path, conn=conn_id)
            except Exception:
                pass
        finally:
            self._sessions.discard(session)
            session.closed()
            if self._log_flush:
                # the teardown's leave records must reach the log too
                self._flush_dirty()
            try:
                writer.close()
            except Exception:
                pass

    def attach_backchannel(self, state_dir: str) -> None:
        """Consume a stage process's backchannel log (stage_runner.py):
        summary ack/nack raw messages are ordered into the stream,
        version commits land through the orderer's ref path, retention
        advances truncate, applier status is recorded."""
        from .durable_log import DurableLog
        from .stage_runner import BACKCHANNEL_TOPIC

        bc = DurableLog(state_dir, readonly=True)
        bc.subscribe(BACKCHANNEL_TOPIC, self._on_backchannel_record)
        self._backchannels.append(bc)

    def _on_backchannel_record(self, message) -> None:
        rec = message.value
        kind = rec.get("kind")
        tenant, doc = rec["tenant"], rec["doc"]
        orderer = self.server._get_orderer(tenant, doc)
        if kind == "raw":
            orderer.order(rec["raw"])
            self.server._maybe_drain()
        elif kind == "version":
            # an external scribe's version commit: the port's orderer
            # has no commit_external_version yet
            raise _not_ported("backchannel version record", "A9")
        elif kind == "retention":
            orderer.apply_retention(rec["capture_seq"])
        elif kind == "applied":
            self.applier_status[(tenant, doc)] = rec["applied_seq"]
            # hoptail thread across the process boundary: the applier
            # stage's stage/execute wall stamps fold into THIS core's
            # registry so net_hop_breakdown attributes device dispatch
            hops = rec.get("wave_hops")
            if hops and len(hops) == 2:
                ms = (hops[1] - hops[0]) * 1e3
                reg = get_registry()
                reg.observe("obs.hop.ms", ms, pair="stage_to_execute")
                reg.observe_windowed("obs.hop.window_ms", ms,
                                     pair="stage_to_execute")

    def enable_summarizer(self, every: int) -> "NetworkFrontEnd":
        """Arm the threshold-driven service-summarizer loop: every doc
        whose stream advanced ≥ ``every`` sequenced ops since its last
        summary gets a columnar snapcols summary (host-replica content
        source — no device applier in this process)."""
        self.summarize_every = every
        return self

    def _summarizer_for(self, server):
        summ = self._summarizers.get(id(server))
        if summ is None:
            from .service_summarizer import HostReplicaSource, ServiceSummarizer

            summ = ServiceSummarizer(
                server, HostReplicaSource(server),
                ops_per_summary=self.summarize_every)
            self._summarizers[id(server)] = summ
        return summ

    async def _presence_loop(self) -> None:
        """The presence tick: drain the LWW store to watchers. Runs on
        the serving loop AFTER any already-queued op pushes, so presence
        never overtakes a sequenced op it followed."""
        lane = self.presence
        while True:
            await asyncio.sleep(lane.flush_interval)
            try:
                lane.flush()
            except Exception as e:  # noqa: BLE001
                self.logger.error("presence_flush_error", message=str(e))

    async def _summarize_loop(self, interval: float = 0.05) -> None:
        while True:
            try:
                for server in self._all_servers():
                    by_tenant: dict = {}
                    for key in list(server._orderers):
                        tenant, _, doc = key.partition("/")
                        by_tenant.setdefault(tenant, []).append(doc)
                    summ = self._summarizer_for(server)
                    wrote = 0
                    for tenant, docs in by_tenant.items():
                        wrote += summ.run_pass(tenant, docs)
                    if wrote and self._log_flush and \
                            hasattr(server.log, "flush"):
                        server.log.flush()
                    if wrote:
                        get_journal().emit(
                            "summary.commit", docs=wrote,
                            part=getattr(server, "part_k", None))
            except Exception as e:  # noqa: BLE001 — the loop must outlive
                # one doc's refusal/IO error
                self.logger.error("summarize_loop_error", message=str(e))
            await asyncio.sleep(interval)

    async def _poll_backchannels(self) -> None:
        while True:
            moved = False
            for bc in self._backchannels:
                try:
                    if bc.poll():
                        bc.drain()
                        moved = True
                except Exception as e:  # noqa: BLE001
                    # drain advances the cursor BEFORE the handler runs,
                    # so continuing resumes at the NEXT record — one
                    # poisoned record must not kill every stage's
                    # pipeline (it used to: the task died silently)
                    self.logger.error("backchannel_record_error",
                                      message=str(e))
                    moved = True
            if moved and self._log_flush:
                # acks ordered above must become visible to the stages
                self.server.log.flush()
            await asyncio.sleep(0.002)

    async def _start(self) -> None:
        # deep backlog: load tests open hundreds of connections at once,
        # and an overflowing accept queue turns into 1-3 s SYN
        # retransmission outliers in the latency measurement
        self._aio_server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, backlog=1024)
        self.port = self._aio_server.sockets[0].getsockname()[1]
        if self._backchannels:
            # the loop holds only a WEAK ref to tasks: an unreferenced
            # poller is garbage-collected at an arbitrary gc cycle and
            # backchannel consumption silently stops (the
            # full-composition failure — summary acks never returned)
            self._bg_tasks.append(asyncio.get_running_loop().create_task(
                self._poll_backchannels()))
        if self.summarize_every is not None:
            self._bg_tasks.append(asyncio.get_running_loop().create_task(
                self._summarize_loop()))
        self._bg_tasks.append(asyncio.get_running_loop().create_task(
            self._presence_loop()))
        self._ready.set()

    def start_background(self) -> "NetworkFrontEnd":
        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self._start())
            loop.run_forever()
            # drain pending callbacks, then close
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="fluid-front-end")
        self._thread.start()
        self._ready.wait(timeout=10)
        return self

    def stop(self) -> None:
        if self._loop is not None:
            loop = self._loop

            def _shutdown():
                if self._aio_server is not None:
                    self._aio_server.close()
                loop.stop()

            loop.call_soon_threadsafe(_shutdown)
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._loop = None

    def serve_forever(self) -> None:
        import gc

        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        loop.run_until_complete(self._start())
        if not gc.isenabled():
            # The host disabled the cycle collector (see main()): sweep
            # accumulated cycles on a timer instead. Freeze after every
            # sweep, and sweep OFTEN (2 s): the sweep cost is one walk
            # over everything allocated since the last freeze, so the
            # cadence bounds the stall — at 30 s cadence with no freeze
            # the first sweep after a 10k-connection storm held the loop
            # ~1 s in the middle of steady-state traffic (the dominant
            # config-4 p99 tail); at 2 s each walk stays tens of ms and
            # the post-storm one lands while the deployment is still
            # settling. Frozen survivors are never rescanned — which
            # also means cyclic garbage that DIES after being frozen is
            # never reclaimed, so a long-lived core under connection
            # churn needs the rare FULL cycle below: unfreeze + collect
            # (one bounded stall every ~10 min) reclaims dead frozen
            # cycles and re-freezes the true survivors.
            sweep_n = [0]

            def _sweep():
                sweep_n[0] += 1
                if sweep_n[0] % 300 == 0:
                    gc.unfreeze()
                gc.collect()
                gc.freeze()
                loop.call_later(2.0, _sweep)
            loop.call_later(2.0, _sweep)
        if self._log_flush:
            # durable-log deployment: periodic pipeline checkpoints so a
            # killed core resumes from them (deli/scribe offsets +
            # scriptorium retention base ride the checkpoint topic)
            def _checkpoint():
                for server in self._all_servers():
                    server.checkpoint_all()
                self._flush_logs()
                loop.call_later(2.0, _checkpoint)
            loop.call_later(2.0, _checkpoint)
        # readiness marker for process supervisors / tests
        print(f"LISTENING {self.host}:{self.port}", flush=True)
        loop.run_forever()


def main() -> None:
    import gc

    parser = argparse.ArgumentParser(
        description="Fluid network front end (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--max-message-size", type=int, default=None)
    parser.add_argument("--tenant", action="append", default=[],
                        metavar="ID:SECRET",
                        help="register a tenant (token auth enforced; "
                             "not ported, ROADMAP A10)")
    # split-service composition (stage_runner.py): the core owns the
    # durable log + sockets + deli/scriptorium/broadcaster; the applier
    # runs as a separate OS process over the same log
    parser.add_argument("--log-dir", default=None,
                        help="durable C++ op log directory (this process "
                             "is its single writer)")
    parser.add_argument("--storage-dir", default=None,
                        help="native chunk-store directory for blobs "
                             "(not ported, ROADMAP A9)")
    parser.add_argument("--storage-server", default=None, metavar="PORT",
                        help="route ALL storage to a storage process "
                             "(not ported, ROADMAP A9)")
    parser.add_argument("--external-scribe", action="store_true",
                        help="scribe runs out of process (not ported, "
                             "ROADMAP A9)")
    parser.add_argument("--consume-backchannel", action="append",
                        default=[], metavar="STATE_DIR",
                        help="a stage process's state dir to consume")
    parser.add_argument("--shard-dir", default=None,
                        help="sharded-core deployment dir (not ported, "
                             "ROADMAP A10)")
    parser.add_argument("--shards", type=int, default=0,
                        help="number of doc partitions (not ported, "
                             "ROADMAP A10)")
    parser.add_argument("--prefer", default="", metavar="K[,K...]",
                        help="partitions to claim at startup (not "
                             "ported, ROADMAP A10)")
    parser.add_argument("--lease-ttl", type=float, default=None,
                        help="lease staleness threshold in seconds (not "
                             "ported, ROADMAP A10)")
    parser.add_argument("--admin-secret", default=None,
                        help="shared secret gating the admin RPCs")
    parser.add_argument("--journal", default=None, metavar="PATH",
                        help="arm the control-plane audit journal at "
                             "PATH")
    parser.add_argument("--tenant-rate", action="append", default=[],
                        metavar="ID:RATE[:BURST]",
                        help="cap a tenant's admission rate in ops/s "
                             "(not ported, ROADMAP A10)")
    parser.add_argument("--slo", action="append", default=[],
                        metavar="NAME=PAIR[@TENANT]:BUDGET_MS"
                                "[:WINDOW_S[:BURN_TICKS]]",
                        help="arm a windowed p99 SLO (not ported, "
                             "ROADMAP A10)")
    parser.add_argument("--no-shed", action="store_true",
                        help="evaluate SLOs but never shed (not "
                             "ported, ROADMAP A10)")
    parser.add_argument("--summarize-every", type=int, default=None,
                        metavar="N",
                        help="run the service summarizer loop: a new "
                             "columnar snapshot every N sequenced ops "
                             "per doc (the snapshot fast-boot plane)")
    parser.add_argument("--rebalance", action="store_true",
                        help="arm the placement rebalancer daemon (not "
                             "ported, ROADMAP A10)")
    parser.add_argument("--probe", action="store_true",
                        help="arm the live health plane (not ported, "
                             "ROADMAP A10)")
    parser.add_argument("--topology", default=None, metavar="SPEC.json",
                        help="start one core of a declarative fleet "
                             "spec (not ported, ROADMAP A10)")
    args = parser.parse_args()
    for flag, value, item in (
            ("--storage-dir", args.storage_dir, "A9"),
            ("--storage-server", args.storage_server, "A9"),
            ("--external-scribe", args.external_scribe, "A9"),
            ("--tenant", args.tenant, "A10"),
            ("--tenant-rate", args.tenant_rate, "A10"),
            ("--slo", args.slo, "A10"),
            ("--probe", args.probe, "A10"),
            ("--shard-dir", args.shard_dir, "A10"),
            ("--shards", args.shards, "A10"),
            ("--prefer", args.prefer, "A10"),
            ("--lease-ttl", args.lease_ttl, "A10"),
            ("--no-shed", args.no_shed, "A10"),
            ("--topology", args.topology, "A10"),
            ("--rebalance", args.rebalance, "A10")):
        if value:
            raise _not_ported(f"option {flag}", item)
    server = None
    if args.log_dir:
        from .durable_log import DurableLog

        server = LocalServer(log=DurableLog(args.log_dir))
    # GC posture for a long-lived service process: the op path allocates
    # acyclic object graphs only (messages, dicts, frames), so the cycle
    # collector buys nothing on the hot path — mid-drain collections
    # scanning the scriptorium logs were the largest latency-spike
    # source under load. Disable it and sweep cycles (asyncio exception
    # tracebacks etc.) on a coarse idle timer instead.
    gc.freeze()
    gc.disable()

    if args.journal:
        from ..obs import arm_journal

        jr = arm_journal(args.journal, core="fe")
        jr.emit("core.recover" if jr.seq else "core.start", owner="fe")
    front = NetworkFrontEnd(server=server, host=args.host, port=args.port,
                            max_message_size=args.max_message_size,
                            admin_secret=args.admin_secret)
    if args.summarize_every is not None:
        front.enable_summarizer(args.summarize_every)
    for state_dir in args.consume_backchannel:
        front.attach_backchannel(state_dir)
    front.serve_forever()


if __name__ == "__main__":
    main()
