"""NetworkFrontEnd: the socket front door (the Alfred analog).

JAX counterpart: ``fluidframework_tpu/service/front_end.py``; the port's
copy, imports rebased to this package: the frame protocol and every
client door, the gateway backbone, the admin RPCs, the stage backchannel,
the service-summarizer loop, tenant tokens and the tenant registry, the
sharded core (``ShardHost``, ``NetworkFrontEnd(shard_host=)``, the
migration seal and the placement admin doors, partition heat, the lease
poll, lazy boot admission and the rebalancer), the overload and health
plane (``enable_admission``, ``attach_slo``, ``enable_health``, fleet
``admin_health`` and the ``--tenant-rate``/``--slo``/``--no-shed``/
``--probe`` flags), the ``snapshot.chunk`` chaos seam,
``start_background``/``serve_forever`` and ``main()``. One repair
(ROADMAP C12): over a durable log, the frames an ingress batch writes
(acks included) leave after the batch's log flush, not before it.

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
from typing import Any, Optional

from ..obs import get_journal, get_recorder, get_registry, tier_counters
from ..obs.probe import CANARY_TENANT
from ..utils.affinity import loop_only, ticker_thread
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
# backoff hint on submits bounced off a sealed (mid-migration)
# partition: long enough for checkpoint+handoff of a hot partition,
# short enough to keep the client-visible migration blip small
MIGRATION_RETRY_S = 0.05


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
            self.front._write(self.writer, _encode_frame({"t": t, **payload}))
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
            self.front._write(self.writer, raw)
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
            # partition mid-migration: bounce on the shed-retry lane
            # (echoed op + retry_after_ms — the driver parks and
            # resubmits in cseq order against the new owner)
            from .placement_plane import placement_counters

            placement_counters().inc("placement.submits.redirected", len(ops))
            self._push_shed_nacks(
                ops, MIGRATION_RETRY_S, sid,
                message="partition migrating: resubmit shortly")
            return []
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
                # mid-migration bounce, cold path: materialize the ops
                # so the shed nacks are byte-identical to the rec door's
                from .placement_plane import placement_counters

                placement_counters().inc("placement.submits.redirected", n)
                self._push_shed_nacks(
                    binwire.cols_to_ops(sc), MIGRATION_RETRY_S, sid,
                    message="partition migrating: resubmit shortly")
                return
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
                from .tenants import SCOPE_READ
                server.tenants.validate(frame.get("token"), tenant, doc,
                                        required_scope=SCOPE_READ)
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
        tenants = self.front.server.tenants
        if tenants is None:
            return
        from .tenants import SCOPE_READ, SCOPE_WRITE

        tenants.validate(frame.get("token"), frame["tenant"], frame["doc"],
                         required_scope=SCOPE_WRITE if write else SCOPE_READ)

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
        plane = front.fault_plane
        sent = 0
        for h in root["chunks"]:
            if h in have:
                continue
            raw = framed[h]
            if plane is not None:
                directive = plane("snapshot.chunk", tenant=tenant,
                                  doc=doc, chunk=h)
                if directive == "drop":
                    continue  # the client sees a hole and falls back
                if directive == "torn":
                    # mangled wire bytes under the real hash: the
                    # client's sha256 verify must refuse them
                    raw = binwire.frame(binwire.snap_chunk_body(
                        0, h, b"\x00chaos-torn\x00"))
            self.push_raw(raw)
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

    def _reply_offloop(self, rid, work, reply) -> None:
        """Run ``work()`` on the default executor and push
        ``reply(result)`` from the future's done-callback, which asyncio
        runs back on the loop thread — so a slow fan-out (peer socket
        dials with multi-second timeouts) never stalls the event loop
        the way a synchronous call from ``handle()`` would. Failures get
        the same error frame the dispatcher's wrapper would have sent."""
        fut = self._loop.run_in_executor(None, work)

        def _done(f) -> None:
            try:
                reply(f.result())
            except Exception as e:  # noqa: BLE001 — report, don't kill the loop
                self.front.logger.error("frame_error", frame_type="admin",
                                        message=str(e))
                self.push("error", {"rid": rid, "message": str(e)})

        fut.add_done_callback(_done)

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
            if tenants is None:
                from .tenants import TenantManager

                tenants = front.server.tenants = TenantManager()
                for server in front._all_servers():
                    server.tenants = tenants
            tenants.register(frame["id"], frame["tenant_secret"])
            if front.shard_host is not None:
                # deployment-wide: the other cores reload the registry
                # file on their next lease poll
                front.shard_host.save_tenants()
            self.push("admin", {"rid": rid, "ok": True})
        elif t == "admin_tenant_remove":
            ok = tenants.remove(frame["id"]) if tenants else False
            if ok and front.shard_host is not None:
                front.shard_host.save_tenants()
            self.push("admin", {"rid": rid, "ok": ok})
        elif t == "admin_placement":
            # read-only: this core's view of the routing plane — the
            # epoch table, its own claims, the lease liveness view, and
            # the placement.* counter snapshot (net_smoke's gate source)
            sh = front.shard_host
            if sh is None:
                self.push("admin", {"rid": rid, "placement": None})
                return
            rec = sh.table.read()
            from ..obs import tier_snapshot

            placement = {
                "owner": sh.owner_id,
                "address": sh.address,
                "epoch": rec["epoch"],
                "parts": rec["parts"],
                "cores": rec.get("cores", {}),
                "owned": sorted(sh.servers),
                "leases": sh.placement.table(),
                "counters": None,
            }
            if frame.get("fleet"):
                # fleet totals: this core's snapshot summed with every
                # reachable peer's (admin_tier_snapshot fan-out) — the
                # operator sees migrations the WHOLE loop issued, not
                # just the local lane's. Each peer is a synchronous
                # socket dial with a multi-second timeout, so the
                # fan-out runs off-loop and the reply is pushed from
                # the done-callback.
                self._reply_offloop(
                    rid, lambda: front._fleet_placement_counters(rec),
                    lambda counters: self.push("admin", {
                        "rid": rid,
                        "placement": dict(placement,
                                          counters=counters)}))
                return
            snap = tier_snapshot("placement")
            placement["counters"] = {name: v for name, v in snap.items()
                                     if name.startswith("placement.")}
            self.push("admin", {"rid": rid, "placement": placement})
        elif t == "admin_migrate_doc":
            # live migration trigger: move the doc's PARTITION to the
            # named core. Synchronous ON the event loop by design — the
            # single-threaded seal→fence→handoff cannot interleave with
            # a submit frame, which is the no-two-writers proof for the
            # in-process window (deli's epoch fence covers the rest).
            # Not in the no-secret mutating set (like admin_summarize):
            # it moves state the deployment already holds, creates none.
            sh = front.shard_host
            if sh is None:
                raise ValueError("not a sharded core")
            from .stage_runner import doc_partition

            tenant, doc = frame["tenant"], frame["doc"]
            k = doc_partition(tenant, doc, sh.n)
            op_id = sh.journal.emit(
                "operator.command", command=t, tenant=tenant, doc=doc,
                part=k, target=frame["target"])
            result = front.migration_engine.migrate(
                k, frame["target"], on_flip=front._on_migration_flip,
                cause=op_id)
            self.push("admin", {"rid": rid, **result})
        elif t == "admin_adopt_partition":
            # core→core handoff target side (MigrationEngine._rpc_adopt)
            sh = front.shard_host
            if sh is None:
                raise ValueError("not a sharded core")
            result = front.migration_engine.adopt(
                int(frame["k"]), frame["from_owner"],
                cause=frame.get("journal_cause"),
                log_blob=frame.get("log_blob"))
            self.push("admin", {"rid": rid, **result})
        elif t == "admin_core_heat":
            # read-only: this core's windowed per-partition heat — the
            # rebalancer's fleet scrape AND the `admin placement heat`
            # table both read this; a failed dial here marks the core
            # unreachable (never a migration target)
            sh = front.shard_host
            if sh is None:
                self.push("admin", {"rid": rid, "heat": None})
                return
            from .rebalancer import HEAT_WINDOW_S, read_local_heat

            heat = read_local_heat(list(sh.servers))
            self.push("admin", {"rid": rid, "heat": {
                "owner": sh.owner_id,
                "addr": sh.address,
                "draining": bool(getattr(sh, "draining", False)),
                "window_s": HEAT_WINDOW_S,
                "parts": {str(k): {"ops": round(h.ops, 3),
                                   "bytes": round(h.bytes, 3)}
                          for k, h in sorted(heat.items())},
            }})
        elif t == "admin_tier_snapshot":
            # read-only: one tier's per-process counter sums — the
            # fleet-aggregation building block (obs.sum_counter_snapshots
            # over every core's reply = fleet totals)
            from ..obs import tier_snapshot

            self.push("admin", {
                "rid": rid,
                "counters": tier_snapshot(str(frame["tier"]))})
        elif t == "admin_rebalance_status":
            # read-only: the loop's own account of itself (armed, last
            # plan, suppressions, flap count) + optional fleet counters
            reb = front.rebalancer
            status = (reb.status() if reb is not None
                      else {"armed": False})
            if frame.get("fleet") and front.shard_host is not None:
                # same off-loop treatment as admin_placement: the peer
                # fan-out must not stall the loop
                table_rec = front.shard_host.table.read()
                self._reply_offloop(
                    rid,
                    lambda: front._fleet_placement_counters(table_rec),
                    lambda counters: self.push("admin", {
                        "rid": rid,
                        "rebalance": dict(status,
                                          fleet_counters=counters)}))
                return
            self.push("admin", {"rid": rid, "rebalance": status})
        elif t == "admin_placement_drain":
            # mark a member draining: every rebalancer tick on that core
            # now evacuates its partitions (dwell/threshold exempt) until
            # it owns nothing and flips itself to drained
            sh = front.shard_host
            if sh is None:
                raise ValueError("not a sharded core")
            from .placement_plane import CORE_DRAINING

            op_id = sh.journal.emit("operator.command", command=t,
                                    owner=frame["owner"])
            ok = sh.table.set_core_state(frame["owner"], CORE_DRAINING,
                                         cause=op_id)
            if not ok:
                raise ValueError(
                    f"unknown core {frame['owner']!r} (not registered)")
            self.push("admin", {"rid": rid, "ok": True,
                                "owner": frame["owner"]})
        elif t == "admin_migrate_part":
            # partition-addressed migration trigger (admin_migrate_doc's
            # sibling): the rebalancer daemon actuates through a loopback
            # RPC to THIS handler so the seal→fence→handoff runs on the
            # event loop — same single-threaded no-two-writers proof as
            # the operator door
            sh = front.shard_host
            if sh is None:
                raise ValueError("not a sharded core")
            # a rebalancer loopback carries its actuation entry id as
            # journal_cause; a bare operator call roots its own chain
            cause = frame.get("journal_cause") or sh.journal.emit(
                "operator.command", command=t, part=int(frame["k"]),
                target=frame["target"])
            result = front.migration_engine.migrate(
                int(frame["k"]), frame["target"],
                on_flip=front._on_migration_flip, cause=cause)
            self.push("admin", {"rid": rid, **result})
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
            sh = front.shard_host
            if sh is not None:
                parts = [s.boot_status()
                         for _, s in sorted(sh.servers.items())]
                rehydrator = sh.rehydrator
                owner = sh.owner_id
            else:
                parts = [front.server.boot_status()]
                rehydrator = front.server.rehydrator
                owner = None
            self.push("admin", {"rid": rid, "boot": {
                "owner": owner,
                "parts": parts,
                "executor": (rehydrator.status()
                             if rehydrator is not None else None),
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
            # read-only: the streaming doctor's live verdict for this
            # core (and, with fleet=1, every peer's — worst verdict
            # wins). An unarmed core answers verdict="unknown" rather
            # than erroring so a fan-out over a mixed deployment
            # (some cores without --probe) still completes.
            engine = front.health_engine
            if engine is not None:
                local = dict(engine.status(), armed=True)
            else:
                owner = (front.shard_host.owner_id
                         if front.shard_host is not None else "")
                local = {"core": owner, "verdict": "unknown",
                         "components": {}, "armed": False}
            if not frame.get("fleet"):
                self.push("admin", {"rid": rid, "health": local})
                return
            sh = front.shard_host
            rec = sh.table.read() if sh is not None else {}
            # each peer is a synchronous socket dial with a
            # multi-second timeout: fan out off-loop, push the
            # aggregate from the done-callback (admin_placement's
            # --fleet pattern)
            self._reply_offloop(
                rid, lambda: front._fleet_health(rec, local),
                lambda health: self.push(
                    "admin", {"rid": rid, "health": health}))

    def _unsubscribe_ftopic(self, topic: str) -> None:
        entry = self._ftopics.pop(topic, None)
        if entry is not None:
            on_batch, on_signal, sig_topic, server, on_presence = entry
            pubsub = server.pubsub
            pubsub.unsubscribe(topic, on_batch)
            pubsub.unsubscribe(sig_topic, on_signal)
            self.front.presence.unsubscribe(topic, on_presence)

    def drop_server(self, server) -> None:
        """Tear down everything this session holds on a revoked
        partition server (lease lost): direct connections close the
        socket (the client auto-reconnects to the takeover owner);
        gateway-muxed sids get an ``fdropped`` so the gateway closes
        just THAT client, not the whole backbone."""
        if self.conn is not None and self.conn.server is server:
            self.closed()
            try:
                self.writer.close()
            except Exception:
                pass
            return
        for sid in [s for s, c in self._fsessions.items()
                    if c.server is server]:
            conn = self._fsessions.pop(sid)
            conn.disconnect()
            topic = self._fsession_topics.pop(sid, None)
            if topic is not None:
                self._ftopic_refs[topic] -= 1
                if self._ftopic_refs[topic] == 0:
                    del self._ftopic_refs[topic]
                    self._unsubscribe_ftopic(topic)
            self.push("fdropped", {"sid": sid})

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


class ShardHost:
    """A core process's claim over doc partitions.

    Ref: memory-orderer/src/reservationManager.ts:21 + remoteNode.ts:92 —
    the reference's multi-node orderer leases documents and routes
    connections to the owner. Here the lease unit is the doc partition;
    partition ``k``'s pipeline is durable in ``<shard_dir>/log-<k>`` and
    whoever holds the lease resumes it from its checkpoints (the same
    restart path a single-core kill -9 recovery uses). ``prefer`` seeds
    the initial placement: non-preferred partitions are only claimed
    after the lease TTL grace (i.e. takeover of a dead peer).
    """

    def __init__(self, shard_dir: str, n: int, prefer=(),
                 storage_server=None, ttl_s: float = None,
                 table_client=None, host_id: Optional[str] = None,
                 claim_policy: Optional[str] = None):
        import os
        import uuid

        from .placement import DEFAULT_TTL_S

        self.shard_dir = shard_dir
        self.n = n
        self.prefer = set(prefer)
        self.storage_server = storage_server
        self.owner_id = uuid.uuid4().hex[:8]
        self.address: Optional[str] = None  # set once the port is bound
        # placement plane behind the TableClient split (table_client.py):
        # local (the raw flock-backed PlacementDir + EpochTable — zero
        # indirection) unless a remote client was injected, in which case
        # every lease/table op is an RPC into the placement host's table
        # door and the flock runs THERE. Either way ``self.placement`` /
        # ``self.table`` keep their historical shapes, so the fencing
        # layers below are implementation-blind.
        if table_client is None:
            from .table_client import LocalTableClient

            table_client = LocalTableClient(
                shard_dir, n,
                ttl_s if ttl_s is not None else DEFAULT_TTL_S)
        self.table_client = table_client
        self.placement = table_client.leases
        self.table = table_client.table
        # multi-host fleets: which host group this core runs in (None =
        # classic single-host). Advertised in the table's cores rows for
        # the rebalancer's locality tiebreak and gateway accounting.
        self.host_id = host_id
        # "prefer" pins this core to its preferred partitions — it never
        # claims outside them, not even stale leases. Multi-host fleets
        # without log replication run this way: a partition's durable
        # log lives in ONE host group's dir, so a cross-host takeover
        # (unlike a cross-host MIGRATION, which ships the log) could not
        # resume it. claim_policy=None/"any" is the historical behavior.
        self.claim_policy = claim_policy or "any"
        # epoch under which this host claimed each owned partition vs
        # the latest table epoch seen for it (refreshed once per poll):
        # table newer than claim ⇒ someone adopted it ⇒ deli's epoch
        # fence refuses with the current epoch (see _make_server)
        self.claim_epochs: dict[int, int] = {}
        self.table_epochs: dict[int, int] = {}
        # partitions mid-migration: poll must not re-claim them
        self.migrating: set[int] = set()
        # shared secret for core→core adoption RPCs (uniform deployment)
        self.admin_secret: Optional[str] = None
        self.servers: dict[int, LocalServer] = {}
        # ONE TenantManager shared by every partition server of this
        # process (including ones claimed later by takeover), kept in
        # sync with the DEPLOYMENT-WIDE registry file
        # <shard_dir>/tenants.json: admin tenant-add on any core secures
        # every core — other processes pick the file up on their next
        # lease poll, and a core started later loads it at boot. A
        # late-claimed or freshly-started tenant-less server would
        # otherwise silently accept unsigned connects (riddler's
        # tenantManager role, but file-backed like the leases).
        from .tenants import TenantManager

        self.tenants = TenantManager()
        self._tenants_path = os.path.join(shard_dir, "tenants.json")
        self._tenants_mtime = None
        self._reload_tenants()
        self._start_t = None
        # monotonic time of the last CONFIRMED lease per partition (the
        # fencing clock — see _make_server)
        self.hb_times: dict[int, float] = {}
        # fired as on_drop(k, server) AFTER a lost partition is revoked —
        # the front end closes the partition's live sessions so clients
        # reconnect to the takeover owner
        self.on_drop = None
        # control-plane audit journal (obs/journal.py): the process
        # singleton, disarmed (free) unless main() armed it — lease
        # lifecycle events land here next to the epoch bumps the table
        # itself records
        self.journal = get_journal()
        # elastic membership: set from the epoch table's cores section
        # each poll — a draining host claims nothing (the rebalancer
        # evacuates what it still owns)
        self.draining = False
        # fleet cold start (service/rehydrate.py): claiming a partition
        # builds NO doc pipelines; first routes boot O(snapshot+tail).
        # The rehydrator — when the front end arms one — bounds a boot
        # storm by parking excess first-routes on the retry lane.
        self.lazy_boot = True
        self.rehydrator = None
        self._cold_boot_noted = False

    def _make_server(self, k: int) -> LocalServer:
        import os
        import time

        from .durable_log import DurableLog

        log = DurableLog(os.path.join(self.shard_dir, f"log-{k}"))
        server = LocalServer(log=log, storage_server=self.storage_server,
                             tenants=self.tenants)
        # lease fencing: orders are refused unless the lease was
        # confirmed within 75% of the TTL — a stalled-and-resumed
        # process fails this check on its first buffered frame, before
        # its heartbeat loop has even run (see LocalServer.lease_fresh)
        margin = self.placement.ttl_s * 0.75
        server.lease_fresh = (
            lambda k=k, margin=margin:
            time.monotonic() - self.hb_times.get(k, 0.0) < margin)
        # placement epoch fence (deli admission): pure dict compares on
        # the hot path — the table file is read once per poll
        server.epoch_fence = (
            lambda k=k: (self.table_epochs[k]
                         if (self.table_epochs.get(k, 0)
                             > self.claim_epochs.get(k, 0))
                         else None))
        # which partition this server sequences — the front end's heat
        # recording labels the windowed series with it
        server.part_k = k
        server.lazy_boot = self.lazy_boot
        server.rehydrator = self.rehydrator
        if self.lazy_boot:
            pending = server.scan_boot_pending()
            if pending and not self._cold_boot_noted:
                # cold start: docs exist on disk and none are booted —
                # journal the recovery shape once per process
                self._cold_boot_noted = True
                self.journal.emit("core.cold_boot", owner=self.owner_id,
                                  part=k, docs_pending=pending)
        return server

    def _reload_tenants(self) -> None:
        import json
        import os

        try:
            mtime = os.stat(self._tenants_path).st_mtime_ns
        except OSError:
            return
        if mtime == self._tenants_mtime:
            return
        self._tenants_mtime = mtime
        try:
            with open(self._tenants_path) as f:
                self.tenants.replace_all(json.load(f))
        except (OSError, ValueError):
            pass  # mid-replace race: next poll rereads

    def save_tenants(self) -> None:
        """Persist the registry for the OTHER cores (atomic replace)."""
        import json
        import os

        tmp = self._tenants_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.tenants._secrets, f)
        os.replace(tmp, self._tenants_path)
        try:
            self._tenants_mtime = os.stat(
                self._tenants_path).st_mtime_ns
        except OSError:
            pass

    def poll(self) -> None:
        """Heartbeat owned partitions; claim unowned/stale ones."""
        import time

        self._reload_tenants()
        # refresh the epoch-fence view (one mtime-cached file read);
        # writes are flock-ordered, so this can only move forward
        self.table_epochs = self.table.part_epochs()
        if self.address:
            # membership: advertise this core (no-op when unchanged) and
            # pick up an operator drain mark — a draining host stops
            # claiming; the rebalancer evacuates what it still owns
            self.table.record_core(self.owner_id, self.address,
                                   host=self.host_id)
            from .placement_plane import CORE_DRAINED, CORE_DRAINING

            self.draining = self.table.core_state(self.owner_id) in (
                CORE_DRAINING, CORE_DRAINED)
        if self._start_t is None:
            self._start_t = time.monotonic()
        for k in list(self.servers):
            if k in self.migrating:
                continue  # the MigrationEngine owns k's lifecycle now
            if self.placement.heartbeat(k, self.owner_id):
                self.hb_times[k] = time.monotonic()
            else:
                # lease lost to a takeover: revoke (no further append
                # can reach the log this process no longer owns), then
                # let the front end tear down the live sessions. The
                # lease_fresh fence already refused orders the moment
                # the confirmation went stale, so there is no
                # two-writer window even if this heartbeat ran late.
                server = self.servers.pop(k)
                self.claim_epochs.pop(k, None)
                server.revoke()
                self.journal.emit("lease.takeover", part=k,
                                  lost_by=self.owner_id)
                if self.on_drop is not None:
                    self.on_drop(k, server)
        in_grace = (time.monotonic() - self._start_t
                    < self.placement.ttl_s + 0.5)
        if self.draining:
            return  # evacuating: never claim, not even takeovers
        for k in range(self.n):
            if k in self.servers or k in self.migrating:
                continue
            if k not in self.prefer and self.claim_policy == "prefer":
                continue  # pinned: this core's logs can't serve others
            if k not in self.prefer and in_grace:
                continue  # let the preferring core take it first
            if self.placement.try_claim(k, self.owner_id, self.address):
                claim_id = self.journal.emit(
                    "lease.claim", part=k, owner=self.owner_id,
                    takeover=k not in self.prefer)
                self.claim_epochs[k] = self.table.record_claim(
                    k, self.owner_id, self.address or "", cause=claim_id)
                self.table_epochs[k] = self.claim_epochs[k]
                self.hb_times[k] = time.monotonic()
                self.servers[k] = self._make_server(k)

    def release_all(self) -> None:
        for k in list(self.servers):
            self.placement.release(k, self.owner_id)
            rel_id = self.journal.emit("lease.release", part=k,
                                       owner=self.owner_id)
            self.table.record_release(k, self.owner_id, cause=rel_id)
            self.claim_epochs.pop(k, None)
        self.servers.clear()
        self.journal.emit("core.stop", owner=self.owner_id)


class NetworkFrontEnd:
    """Owns the LocalServer pipeline and serves it over TCP.

    ``start_background()`` runs the event loop (and thus the whole
    pipeline) on a dedicated thread — the in-process deployment.
    ``serve_forever()`` blocks — the subprocess deployment
    (``python -m fluidframework_tpu_torch.service.front_end``).

    With ``shard_host`` set the process serves only the doc partitions
    whose leases it holds — ``server_for`` routes each frame to the
    partition's LocalServer and refuses docs this core doesn't own.
    """

    #: chaos seam (chaos/plane.py): directives at
    #: ``snapshot.chunk`` corrupt ("torn") or withhold ("drop") a served
    #: chunk's WIRE bytes only — the encode-once cache and the durable
    #: blobs stay intact, so the client's hash check trips and its
    #: legacy-tree fallback still converges
    fault_plane = None

    def __init__(self, server: Optional[LocalServer] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_message_size: Optional[int] = None,
                 shard_host: Optional[ShardHost] = None,
                 admin_secret: Optional[str] = None):
        self.shard_host = shard_host
        self.admin_secret = admin_secret
        self.migration_engine = None
        if shard_host is not None:
            # config/tenants shell; never serves. Shares the shard
            # host's deployment-wide tenant registry so the admin
            # surface and enforcement checks see the same state.
            server = LocalServer(tenants=shard_host.tenants)
            from .placement_plane import MigrationEngine

            shard_host.admin_secret = admin_secret
            self.migration_engine = MigrationEngine(shard_host)
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
        self._log_flush = (shard_host is not None
                           or hasattr(self.server.log, "flush"))
        # outbound frames written while an ingress batch is handled wait
        # here for the batch's log flush (ROADMAP C12): an ack never
        # reaches a client before the op it acks is in the durable log
        self._held: Optional[list] = None
        # (tenant, doc) → applied seq reported by an applier stage
        self.applier_status: dict = {}
        # overload-control loop: the admission gate stays None (one
        # attribute check on the submit path) until a tenant rate or an
        # SLO engine is attached
        self.admission: Optional[AdmissionController] = None
        self.slo_engine = None
        # self-driving placement: armed by --rebalance (enable_rebalancer
        # stores the config; _start constructs the daemon once the port
        # is bound and the shard host registered in the epoch table)
        self.rebalancer = None
        self._rebalance_cfg: Optional[dict] = None
        # live health plane (--probe): a canary prober walking this
        # core's own doors + a HealthEngine running the doctor's rules
        # continuously. Config stored here; both start in _start once
        # the bound address exists (the canary dials it).
        self.prober = None
        self.health_engine = None
        self._health_cfg: Optional[dict] = None
        # live _ClientSessions (lease-loss teardown walks these)
        self._sessions: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._aio_server: Optional[asyncio.base_events.Server] = None

    def enable_admission(self) -> AdmissionController:
        """The admission gate, created on first use; rates are re-read
        from the tenant registry per boxcar so runtime changes apply."""
        if self.admission is None:
            self.admission = AdmissionController(self._rate_for)
        return self.admission

    def _rate_for(self, tenant: str):
        tm = self.server.tenants
        return None if tm is None else tm.rate_for(tenant)

    def attach_slo(self, engine, shedding: bool = True) -> "NetworkFrontEnd":
        """Close the loop: the engine's windowed verdicts arm (or, with
        ``shedding=False``, merely observe) the admission gate."""
        self.slo_engine = engine
        adm = self.enable_admission()
        adm.engine = engine
        adm.shedding = shedding
        return self

    def enable_boot_admission(self, boots_per_s: float = 200.0,
                              burst: int = 32) -> "NetworkFrontEnd":
        """Arm boot-storm admission: one rehydration executor per core
        shared by every partition server (current AND late-claimed —
        ShardHost stamps it in _make_server)."""
        from .rehydrate import RehydrationExecutor

        ex = RehydrationExecutor(boots_per_s, burst)
        if self.shard_host is not None:
            self.shard_host.rehydrator = ex
            for s in self.shard_host.servers.values():
                s.rehydrator = ex
        else:
            self.server.rehydrator = ex
        return self

    def record_heat(self, server, n_ops: int, n_bytes: int) -> None:
        """Per-partition load accounting (the rebalancer's input): one
        windowed observe per admitted boxcar, labeled with the serving
        partition. Single-pipeline deployments have no ``part_k`` and
        record nothing — there is nowhere to rebalance to."""
        k = getattr(server, "part_k", None)
        if k is None:
            return
        from .rebalancer import HEAT_BYTES, HEAT_OPS

        reg = get_registry()
        reg.observe_windowed(HEAT_OPS, float(n_ops), part=str(k))
        if n_bytes:
            reg.observe_windowed(HEAT_BYTES, float(n_bytes), part=str(k))

    def enable_rebalancer(self, tick_s: float = 0.5,
                          dwell_s: float = 10.0, budget: int = 2,
                          improvement: float = 0.25) -> "NetworkFrontEnd":
        """Arm the self-driving placement loop (--rebalance). Stored as
        config here; the daemon itself starts in ``_start`` once the
        bound address exists (migration targets need it)."""
        if self.shard_host is None:
            raise ValueError("--rebalance requires a sharded core")
        self._rebalance_cfg = {
            "tick_s": tick_s, "dwell_s": dwell_s,
            "budget": budget, "improvement": improvement}
        return self

    @ticker_thread("rebalancer")
    def _rebalance_actuate(self, k: int, target_addr: str,
                           cause: Optional[str] = None) -> None:
        """Actuation seam for the rebalancer's ticker THREAD: a loopback
        ``admin_migrate_part`` RPC against our own event loop, so the
        seal→fence→handoff runs exactly where the operator door runs it
        (single-threaded, no submit frame can interleave). ``cause`` is
        the rebalance.actuate journal id; it rides the frame so the
        migration chain roots at the plan, not at the loopback RPC."""
        from .placement_plane import admin_rpc

        frame = {"t": "admin_migrate_part", "k": k, "target": target_addr}
        if cause is not None:
            frame["journal_cause"] = cause
        if self.admin_secret:
            frame["secret"] = self.admin_secret
        admin_rpc(self.host, self.port, frame)

    def enable_health(self, probe_tick_s: float = 2.0,
                      tick_s: float = 1.0, critical_ticks: int = 3,
                      probe_fail_critical: int = 3,
                      probe_timeout: float = 5.0,
                      max_route_peers: int = 2) -> "NetworkFrontEnd":
        """Arm the live health plane (--probe): stored as config here;
        the prober and engine start in ``_start`` once the socket is
        bound (the canary dials our own listening address) and — on a
        sharded core — the first poll has claimed partitions, so the
        canary doc routes."""
        self._health_cfg = {
            "probe_tick_s": probe_tick_s, "tick_s": tick_s,
            "critical_ticks": critical_ticks,
            "probe_fail_critical": probe_fail_critical,
            "probe_timeout": probe_timeout,
            "max_route_peers": max_route_peers}
        return self

    def _arm_health(self) -> None:
        """Construct + start the canary prober and the health engine.

        Every engine source closes over LIVE surfaces and returns the
        bundle-shaped artifact the doctor would read offline — that is
        what makes the offline/live equivalence test possible. The
        prober's transport is the driver's ``_Transport`` (a real
        client dial, not a shortcut into the pipeline: the probe must
        traverse the same socket, reader thread, and frame codec a
        user does)."""
        from ..driver.network import _Transport
        from ..obs.health import HealthEngine
        from ..obs.probe import CANARY_DOC, CanaryProber

        cfg = self._health_cfg or {}
        sh = self.shard_host
        owner = sh.owner_id if sh is not None else "fe"
        timeout = cfg.get("probe_timeout", 5.0)

        def dial(host, port, timeout=timeout):
            return _Transport(host, port, timeout=timeout)

        def doc_fn():
            # a canary doc routed to THIS core: sharded cores refuse
            # docs whose partition they don't own, so walk suffixes
            # until one hashes into our claims (None while we own
            # nothing — the session doors idle, not fail)
            if sh is None:
                return CANARY_DOC
            from .stage_runner import doc_partition

            owned = set(sh.servers)
            if not owned:
                return None
            for i in range(64):
                doc = f"{CANARY_DOC}{i}"
                if doc_partition(CANARY_TENANT, doc, sh.n) in owned:
                    return doc
            return None

        def peers_fn():
            if sh is None:
                return {}
            try:
                rec = sh.table.read()
            except Exception:  # noqa: BLE001 — table read is advisory
                return {}
            # membership is append-only (a capacity advertisement, not
            # a route): a kill -9'd core's row outlives it forever.
            # Route-probe only owners a gateway would actually traverse
            # — those holding ≥1 partition NOW — so a replaced core's
            # stale row stops counting against fleet health the moment
            # its partitions are re-claimed.
            routed = {p.get("owner")
                      for p in (rec.get("parts") or {}).values()}
            return {o: {"addr": row.get("addr"),
                        "host": row.get("host")}
                    for o, row in (rec.get("cores") or {}).items()
                    if o in routed}

        def token_fn(tenant, doc):
            # canary auth: mint against a per-process secret, and
            # re-assert the registration per mint — the shared-registry
            # reload on the lease poll replaces the dict and would
            # silently drop us. On open (dev-mode) deployments we must
            # NOT register: the first registration flips tenancy to
            # enforcing and locks every real client out.
            tm = self.server.tenants
            if tm is None or not tm.enforcing:
                return None
            from .tenants import sign_token

            tm.register(CANARY_TENANT, self._canary_secret)
            return sign_token(tenant, doc, self._canary_secret)

        import secrets as _secrets

        self._canary_secret = _secrets.token_hex(16)
        self.prober = CanaryProber(
            dial, self.host, self.port, core=owner,
            doc_fn=doc_fn,
            peers_fn=peers_fn if sh is not None else None,
            token_fn=token_fn,
            tick_s=cfg.get("probe_tick_s", 2.0), timeout=timeout,
            snapshot=True,
            max_route_peers=cfg.get("max_route_peers", 2)).start()

        def boot_fn():
            from ..obs import tier_snapshot

            if sh is not None:
                parts = [s.boot_status()
                         for _, s in sorted(sh.servers.items())]
                rehydrator = sh.rehydrator
            else:
                parts = [self.server.boot_status()]
                rehydrator = self.server.rehydrator
            return {"parts": parts,
                    "executor": (rehydrator.status()
                                 if rehydrator is not None else None),
                    "counters": {k: v for k, v in
                                 tier_snapshot("frontend").items()
                                 if k.startswith("boot.part.")}}

        def slo_fn():
            eng = self.slo_engine
            return {"slos": eng.status() if eng is not None else []}

        self.health_engine = HealthEngine(
            core=owner,
            scrape_fn=get_registry().scrape,
            journal_fn=lambda: get_journal().tail(n=400),
            placement_fn=(sh.table.read if sh is not None else None),
            cores_fn=self.prober.peer_rows,
            slo_fn=slo_fn,
            boot_fn=boot_fn,
            probe_fn=self.prober.status,
            # a deliberately-unarmed journal (in-process fleets,
            # bare dev cores) is config, not a failure: report
            # journal_armed only when it IS armed, so the doctor's
            # disarmed rule (written for bundles, where a core that
            # SHOULD journal didn't) stays quiet live
            self_row_fn=lambda: (
                {"journal_armed": True} if get_journal().armed else {}),
            tick_s=cfg.get("tick_s", 1.0),
            critical_ticks=cfg.get("critical_ticks", 3),
            probe_fail_critical=cfg.get("probe_fail_critical", 3),
        ).start()

    def _fleet_health(self, table_rec: dict, local: dict) -> dict:
        """Fleet verdict: this core's health joined with every peer
        core's (``admin_health`` fan-out) — worst verdict wins, and an
        UNREACHABLE peer is critical, not skipped: the go/no-go gate
        must fail closed, a dead core cannot answer "I'm fine"."""
        from .placement_plane import admin_rpc

        order = {"ok": 0, "unknown": 1, "degraded": 2, "critical": 3}
        self_owner = (self.shard_host.owner_id
                      if self.shard_host is not None else None)
        cores = {local.get("core") or "": local}
        worst = local.get("verdict", "unknown")
        # same routed-owner filter as the prober's peers_fn: membership
        # rows never expire, so gate only on cores that currently hold
        # partitions — a kill -9'd core's stale row must not hold the
        # fleet at critical after its replacement claimed its parts
        routed = {p.get("owner")
                  for p in (table_rec.get("parts") or {}).values()}
        for owner, row in sorted(
                (table_rec.get("cores") or {}).items()):
            if owner == self_owner or owner not in routed:
                continue
            host_s, _, port_s = row.get("addr", "").rpartition(":")
            frame = {"t": "admin_health"}
            if self.admin_secret:
                frame["secret"] = self.admin_secret
            try:
                reply = admin_rpc(host_s or "127.0.0.1", int(port_s),
                                  frame, timeout=5.0)
                h = dict(reply.get("health") or {})
                h.setdefault("core", owner)
            except (OSError, ValueError, RuntimeError) as e:
                h = {"core": owner, "verdict": "critical",
                     "armed": False,
                     "reasons": [f"core {owner}: admin_health "
                                 f"unreachable ({e})"]}
            cores[owner] = h
            if (order.get(h.get("verdict"), 1)
                    > order.get(worst, 1)):
                worst = h.get("verdict")
        return {"fleet": True, "verdict": worst, "cores": cores}

    def _fleet_placement_counters(self, table_rec: dict) -> dict:
        """Fleet-total placement counters: this process's snapshot summed
        with every reachable peer core's (``admin_tier_snapshot``)."""
        from ..obs import sum_counter_snapshots, tier_snapshot
        from .rebalancer import peer_tier_snapshots

        snaps = [tier_snapshot("placement")]
        if self.shard_host is not None:
            snaps.extend(peer_tier_snapshots(
                table_rec, self.shard_host.owner_id, "placement",
                secret=self.admin_secret))
        total = sum_counter_snapshots(snaps)
        return {name: v for name, v in total.items()
                if name.startswith("placement.")}

    def server_for(self, tenant: str, doc: str) -> LocalServer:
        """The LocalServer serving this doc: the single pipeline, or the
        doc partition's server in a sharded core (which refuses docs
        whose lease this process doesn't hold — the gateway routes)."""
        if self.shard_host is None:
            return self.server
        from .stage_runner import doc_partition

        k = doc_partition(tenant, doc, self.shard_host.n)
        server = self.shard_host.servers.get(k)
        if server is None:
            raise RuntimeError(f"not the owner of partition {k}")
        return server

    def _all_servers(self):
        if self.shard_host is not None:
            return list(self.shard_host.servers.values())
        return [self.server]

    def _flush_logs(self) -> None:
        for server in self._all_servers():
            if hasattr(server.log, "flush"):
                server.log.flush()

    def _write(self, writer, data: bytes) -> None:
        """Write a frame, or hold it for the ingress batch's flush."""
        if self._held is not None:
            self._held.append((writer, data))
        else:
            writer.write(data)

    def _release_held(self) -> None:
        held, self._held = self._held, None
        for writer, data in held:
            if writer.is_closing():
                continue
            try:
                writer.write(data)
            except RuntimeError:
                pass  # transport torn down mid-shutdown; peer is gone

    def _flush_dirty(self) -> None:
        """Flush only the logs the current ingress batch dirtied.

        The old per-frame path flushed EVERY partition's log on every
        frame — at 2 cores each frame paid for all shards (the sharded
        regression's prime suspect). Read-only batches (pings, storage
        RPCs, signals) flush nothing at all."""
        dirty = self._dirty_servers
        n_all = (len(self.shard_host.servers)
                 if self.shard_host is not None else 1)
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

    def _on_migration_flip(self, k: int, target_addr: str, epoch: int,
                           server) -> None:
        """Post-handoff routing flip (MigrationEngine ``on_flip``, on the
        loop thread): push the new route to every gateway backbone FIRST
        — their routing caches patch in-memory, so the reconnects that
        the session drop below triggers resolve to the target without a
        table read — then tear down the sealed partition's sessions
        (direct clients reconnect, gateway sids get ``fdropped``)."""
        route = {"k": k, "addr": target_addr, "epoch": epoch}
        for session in list(self._sessions):
            if session._fsessions or session._ftopics:
                try:
                    session.push("fplacement", route)
                except Exception as e:  # noqa: BLE001
                    self.logger.error("fplacement_push_error",
                                      message=str(e))
        self._drop_server_sessions(server)

    def _drop_server_sessions(self, server) -> None:
        """Close every live session bound to a revoked partition server
        (runs on the loop thread via call_soon_threadsafe)."""
        self._dirty_servers.discard(server)
        for session in list(self._sessions):
            try:
                session.drop_server(server)
            except Exception as e:  # noqa: BLE001
                self.logger.error("drop_session_error", message=str(e))

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
                # this batch's writes (acks, fan-out, replies) wait for
                # its log flush (C12); a batch started while another is
                # suspended inside its reads shares the first one's hold
                outer = self._log_flush and self._held is None
                if outer:
                    self._held = []
                try:
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
                finally:
                    if outer:
                        self._release_held()
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
            orderer.commit_external_version(rec["handle"], rec["version"])
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
        if self.shard_host is not None:
            loop = asyncio.get_running_loop()

            def on_drop(k, server, loop=loop):
                # poll may run on an executor thread: hop to the loop
                loop.call_soon_threadsafe(self._drop_server_sessions,
                                          server)
            self.shard_host.on_drop = on_drop
            self.shard_host.address = f"{self.host}:{self.port}"
            self.shard_host.poll()  # claim preferred partitions NOW
            if self._rebalance_cfg is not None:
                # armed after the first poll: the bound address is in the
                # epoch table's membership, so peers can target us; the
                # ticker thread actuates via loopback admin RPCs
                from .rebalancer import Rebalancer

                self.rebalancer = Rebalancer(
                    self.shard_host, self.migration_engine,
                    slo_engine=self.slo_engine,
                    actuate=self._rebalance_actuate,
                    secret=self.admin_secret,
                    **self._rebalance_cfg).start()

            async def lease_loop():
                interval = self.shard_host.placement.ttl_s / 3.0
                while True:
                    await asyncio.sleep(interval)
                    try:
                        # takeover construction replays the partition's
                        # durable log — off the event loop, so live
                        # sessions on OTHER partitions never stall
                        await loop.run_in_executor(None,
                                                   self.shard_host.poll)
                    except Exception as e:  # noqa: BLE001
                        self.logger.error("lease_poll_error",
                                          message=str(e))
            self._bg_tasks.append(loop.create_task(lease_loop()))
        if self._health_cfg is not None:
            # after the first poll: the canary doc must route to a
            # claimed partition, and peers must see our address
            self._arm_health()
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
        if self.rebalancer is not None:
            self.rebalancer.stop()
            self.rebalancer = None
        if self.prober is not None:
            self.prober.stop()
            self.prober = None
        if self.health_engine is not None:
            self.health_engine.stop()
            self.health_engine = None
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


def _apply_overload_flags(front: "NetworkFrontEnd", args, parser) -> None:
    """Arm the overload-control loop from the CLI flags: per-tenant
    rate caps into the tenant registry, SLO specs into a ticking
    engine attached to the admission gate."""
    if args.tenant_rate:
        from .tenants import TenantManager

        tm = front.server.tenants
        if tm is None:
            # rates alone must NOT flip tenancy to enforcing — the
            # registry stays secret-less (open auth) and only carries
            # the budgets
            tm = front.server.tenants = TenantManager()
            for server in front._all_servers():
                server.tenants = tm
        for spec in args.tenant_rate:
            parts = spec.split(":")
            try:
                tm.set_rate(parts[0], float(parts[1]),
                            float(parts[2]) if len(parts) > 2 else None)
            except (IndexError, ValueError):
                parser.error(f"bad --tenant-rate {spec!r} "
                             "(want ID:RATE[:BURST])")
        front.enable_admission()
    if args.slo:
        from ..obs.slo import SloEngine, parse_slo_spec

        try:
            specs = [parse_slo_spec(s) for s in args.slo]
        except ValueError as e:
            parser.error(str(e))
        front.attach_slo(SloEngine(specs).start(),
                         shedding=not args.no_shed)


def main() -> None:
    import gc

    parser = argparse.ArgumentParser(
        description="Fluid network front end (PyTorch port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--max-message-size", type=int, default=None)
    parser.add_argument("--tenant", action="append", default=[],
                        metavar="ID:SECRET",
                        help="register a tenant (token auth enforced)")
    # split-service composition (stage_runner.py): the core owns the
    # durable log + sockets + deli/scriptorium/broadcaster; scribe and
    # the applier run as separate OS processes over the same log
    parser.add_argument("--log-dir", default=None,
                        help="durable C++ op log directory (this process "
                             "is its single writer)")
    parser.add_argument("--storage-dir", default=None,
                        help="native chunk-store directory for blobs")
    parser.add_argument("--storage-server", default=None, metavar="PORT",
                        help="route ALL storage to a storage_server.py "
                             "process (host:port or port on localhost)")
    parser.add_argument("--external-scribe", action="store_true",
                        help="scribe runs out of process; summary "
                             "uploads are announced on the log")
    parser.add_argument("--consume-backchannel", action="append",
                        default=[], metavar="STATE_DIR",
                        help="a stage process's state dir to consume")
    # sharded ordering core: N core processes share a
    # deployment dir; each claims doc partitions via placement leases
    # and serves only its docs; gateways route by partition
    parser.add_argument("--shard-dir", default=None,
                        help="sharded-core deployment dir (leases + "
                             "per-partition durable logs)")
    parser.add_argument("--shards", type=int, default=0,
                        help="number of doc partitions")
    parser.add_argument("--prefer", default="", metavar="K[,K...]",
                        help="partitions to claim at startup (others "
                             "only by stale-lease takeover)")
    parser.add_argument("--lease-ttl", type=float, default=None,
                        help="lease staleness threshold in seconds")
    parser.add_argument("--admin-secret", default=None,
                        help="shared secret gating the admin RPCs "
                             "(required when tenancy is enforcing)")
    parser.add_argument("--journal", default=None, metavar="PATH",
                        help="arm the control-plane audit journal at "
                             "PATH (sharded cores arm automatically "
                             "under the shard dir; this is the "
                             "single-pipeline / bench A/B door)")
    # overload-control loop (see service/admission.py + obs/slo.py)
    parser.add_argument("--tenant-rate", action="append", default=[],
                        metavar="ID:RATE[:BURST]",
                        help="cap a tenant's admission rate in ops/s "
                             "(unlisted tenants stay unlimited)")
    parser.add_argument("--slo", action="append", default=[],
                        metavar="NAME=PAIR[@TENANT]:BUDGET_MS"
                                "[:WINDOW_S[:BURN_TICKS]]",
                        help="arm a windowed p99 SLO; a sustained burn "
                             "sheds over-budget tenants")
    parser.add_argument("--no-shed", action="store_true",
                        help="evaluate SLOs but never shed (the "
                             "overload bench's control arm)")
    parser.add_argument("--summarize-every", type=int, default=None,
                        metavar="N",
                        help="run the service summarizer loop: a new "
                             "columnar snapshot every N sequenced ops "
                             "per doc (the snapshot fast-boot plane)")
    # self-driving placement (service/rebalancer.py): close the
    # load→decision→migration loop on this core
    parser.add_argument("--rebalance", action="store_true",
                        help="arm the placement rebalancer daemon "
                             "(requires --shard-dir)")
    parser.add_argument("--rebalance-tick", type=float, default=0.5,
                        metavar="S", help="planner tick interval")
    parser.add_argument("--rebalance-dwell", type=float, default=10.0,
                        metavar="S", help="per-partition minimum dwell "
                                          "between moves")
    parser.add_argument("--rebalance-budget", type=int, default=2,
                        metavar="N", help="max migrations per tick from "
                                          "this core")
    parser.add_argument("--rebalance-improvement", type=float,
                        default=0.25, metavar="F",
                        help="min hottest→coldest gap as a fraction of "
                             "mean load before a move is worth it")
    # live health plane (obs/probe.py + obs/health.py): canary probes
    # through this core's own doors + the doctor's rules evaluated
    # continuously, served by the admin_health RPC
    parser.add_argument("--probe", action="store_true",
                        help="arm the live health plane: a canary "
                             "prober walking this core's doors on the "
                             "reserved __canary__ tenant plus the "
                             "streaming doctor (admin_health)")
    parser.add_argument("--probe-tick", type=float, default=2.0,
                        metavar="S", help="canary probe interval")
    parser.add_argument("--health-tick", type=float, default=1.0,
                        metavar="S", help="health rule evaluation "
                                          "interval")
    parser.add_argument("--health-critical-ticks", type=int, default=3,
                        metavar="N",
                        help="consecutive anomalous ticks before a "
                             "component goes degraded → critical")
    # fleet topology spec (service/topology.py): the whole deployment
    # as one JSON object; every sharded construction path converges on
    # topology.build_core, so a restart from the spec IS the start
    parser.add_argument("--topology", default=None, metavar="SPEC.json",
                        help="start one core of a declarative fleet "
                             "spec (supersedes the --shard-dir flag "
                             "family)")
    parser.add_argument("--core-index", type=int, default=0,
                        metavar="I", help="which spec core this "
                                          "process is")
    parser.add_argument("--boot-rate", type=float, default=200.0,
                        metavar="N",
                        help="boot-storm admission: doc rehydrations "
                             "per second this core will run; excess "
                             "first-routes park on the retry lane "
                             "(0 disarms)")
    parser.add_argument("--boot-burst", type=int, default=32,
                        metavar="N",
                        help="boot-storm admission burst size")
    args = parser.parse_args()
    if args.rebalance and args.shard_dir is None and args.topology is None:
        parser.error("--rebalance requires --shard-dir")
    if args.topology is not None or args.shard_dir is not None:
        import gc as _gc

        from .topology import CoreSpec, TopologySpec, build_core

        if args.consume_backchannel or args.external_scribe:
            parser.error("sharded cores do not compose with per-stage "
                         "backchannels yet")
        if args.tenant or args.log_dir or args.storage_dir:
            # refuse loudly: silently dropping --tenant would start an
            # auth-less deployment the operator believes is secured
            parser.error("sharded cores do not compose with --tenant/"
                         "--log-dir/--storage-dir (per-partition logs "
                         "live under the shard dir; use "
                         "--storage-server for storage)")
        if args.topology is not None:
            spec = TopologySpec.load(args.topology)
            core_index = args.core_index
        else:
            # the flag family is now sugar: one single-core spec, same
            # construction path. The core's journal file is named by
            # its STABLE role (preferred partitions) so a restarted
            # core reopens its own journal and continues the id space
            # — that is what makes core.recover detectable.
            prefer = [int(k) for k in args.prefer.split(",") if k != ""]
            name = ("core-" + "-".join(str(k) for k in prefer)
                    if prefer else "")
            spec = TopologySpec(
                shard_dir=args.shard_dir, n_partitions=args.shards,
                cores=[CoreSpec(name=name, prefer=prefer,
                                port=args.port)],
                host=args.host, lease_ttl=args.lease_ttl,
                admin_secret=args.admin_secret,
                summarize_every=args.summarize_every,
                storage_server=args.storage_server,
                boot_rate=args.boot_rate, boot_burst=args.boot_burst,
                rebalance=({
                    "tick_s": args.rebalance_tick,
                    "dwell_s": args.rebalance_dwell,
                    "budget": args.rebalance_budget,
                    "improvement": args.rebalance_improvement,
                } if args.rebalance else None))
            core_index = 0
        _gc.freeze()
        _gc.disable()
        front = build_core(spec, core_index)
        if args.max_message_size is not None:
            front.max_message_size = args.max_message_size
        _apply_overload_flags(front, args, parser)
        if args.probe and front._health_cfg is None:
            # flag-armed on top of a spec without a health stanza
            # (spec.health goes through build_core)
            front.enable_health(
                probe_tick_s=args.probe_tick,
                tick_s=args.health_tick,
                critical_ticks=args.health_critical_ticks)
        front.serve_forever()
        return
    server = None
    tenants = None
    if args.tenant:
        from .tenants import TenantManager

        tenants = TenantManager()
        for spec in args.tenant:
            tid, _, secret = spec.partition(":")
            tenants.register(tid, secret)
    if args.tenant or args.log_dir or args.storage_dir \
            or args.external_scribe or args.storage_server:
        log = None
        if args.log_dir:
            from .durable_log import DurableLog

            log = DurableLog(args.log_dir)
        storage_server = None
        if args.storage_server:
            host, _, port = args.storage_server.rpartition(":")
            storage_server = (host or "127.0.0.1", int(port))
        server = LocalServer(tenants=tenants, log=log,
                             storage_dir=args.storage_dir,
                             external_scribe=args.external_scribe,
                             storage_server=storage_server)
        if args.external_scribe:
            def announce_upload(tenant, doc, vid, rec, server=server):
                server.log.append(f"uploads/{tenant}/{doc}",
                                  {"version_id": vid, "record": rec})
                server.log.flush()
            server.on_version_uploaded = announce_upload
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
    _apply_overload_flags(front, args, parser)
    if args.probe:
        front.enable_health(probe_tick_s=args.probe_tick,
                            tick_s=args.health_tick,
                            critical_ticks=args.health_critical_ticks)
    if args.summarize_every is not None:
        front.enable_summarizer(args.summarize_every)
    for state_dir in args.consume_backchannel:
        front.attach_backchannel(state_dir)
    front.serve_forever()


if __name__ == "__main__":
    main()
