"""Gateway: a horizontally-scalable front-end instance.

JAX counterpart: ``fluidframework_tpu/service/gateway.py``; the port's
copy of the single-core relay, imports rebased to this package. ``main``
runs the port's native relay (``csrc/gateway.cpp`` through
``native/gateway.py``) unless ``--python`` asks for the asyncio relay; a
native build or load failure raises and never falls back. Sharded-core
routing (``shard_dir``, ``table_server``) and the relay tree
(``--upstream-gateway``) are not ported yet (ROADMAP A10) and raise
``NotImplementedError``.

Ref: the reference runs N Alfred instances behind Redis-backed socket.io
(services/src/socketIoRedisPublisher.ts) — each Alfred terminates client
sockets and the pub/sub layer fans sequenced batches to every instance
once. Here each gateway process serves the standard client wire protocol
(driver/network.py speaks to it unchanged) and muxes all its sessions
over ONE upstream backbone connection to the core ordering process
(front_end.py's f* frames):

    clients ⇄ gateway (this module) ⇄ core NetworkFrontEnd + pipeline

What scales: socket termination, frame parsing, and broadcast fan-out
encode move to the gateways; the core sends each doc's batch ONCE per
gateway as raw bytes that the gateway re-frames once and relays to every
local subscriber. Submit frames pass through without re-encoding the op
payloads.

Relay tree: a gateway's upstream may itself be another
gateway (``--upstream-gateway H:P``) — every gateway SERVES the same
f* backbone protocol it dials, so tiers stack:

    clients ⇄ leaf gateways ⇄ mid gateways ⇄ core

A downstream gateway is an ordinary client socket here whose first
``fconnect`` marks it a LINK: it gets ONE topic registration per doc
(however many clients ride behind it), and upstream fan-out bytes relay
to it VERBATIM — the topic-slice splice happens once per tier, the
payload encode zero times (``fanout.relay.splices`` vs
``fanout.relay.encodes``). The core's per-doc cost is per CHILD, not
per client: 10× the readers behind a deeper tree is ~flat bytes/op at
the core.

Deployment: ``python -m fluidframework_tpu_torch.service.gateway
--core-host H --core-port P [--port N]``; add another tier with
``--upstream-gateway H:P`` (aliases the core address and keeps the
asyncio relay, which speaks the backbone protocol on both sides).

When to use it (measured honestly): on a single host the extra hop LOSES
— the core's one-encode batch cache makes direct fan-out writes cheap,
so bench.py keeps the direct topology. Gateways are the cross-HOST
scale-out story: socket termination under TLS/compression, thousands of
clients per doc, or a core that is NIC-bound — the same conditions that
motivate the reference's multi-Alfred deployment.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import socket as _socket
import time
from typing import Optional

from ..obs import get_recorder, tier_counters
from ..utils.affinity import loop_only
from ..protocol import binwire
from ..utils.telemetry import HOP_RELAY
from .front_end import (_BULK_FRAMES, _encode_frame, _frame_buffered,
                        _read_body)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"gateway {what} is not ported to fluidframework_tpu_torch yet "
        f"(ROADMAP {item})")


class _CoreError(RuntimeError):
    """An upstream error reply, with its machine-readable fields kept —
    a relayed ``boot_pending`` (cold-start admission parking) must reach
    the leaf client's retry lane intact through any number of tiers."""

    def __init__(self, reply: dict):
        super().__init__(f"core error: {reply.get('message')}")
        self.code = reply.get("code")
        self.retry_after_ms = reply.get("retryAfterMs")


def _error_frame(frame: dict, e: BaseException) -> dict:
    err = {"t": "error", "rid": frame.get("rid"), "message": str(e)}
    code = getattr(e, "code", None)
    if code:
        err["code"] = code
        retry = getattr(e, "retry_after_ms", None)
        if retry is not None:
            err["retryAfterMs"] = retry
    return err


class _GatewaySession:
    """One client connection terminated at this gateway.

    A downstream GATEWAY arrives on the same listener; its first
    ``fconnect`` flips ``is_link`` and the session becomes a relay-tree
    edge: many muxed sessions (``dsids``/``fsids``) over one socket,
    one topic registration per doc however many of them share it
    (``ftopic_refs``)."""

    def __init__(self, gw: "Gateway", writer: asyncio.StreamWriter):
        self.gw = gw
        self.writer = writer
        self.sid: Optional[int] = None
        self.topic: Optional[str] = None
        self.binary = False  # client negotiated binwire ops push
        self.up: Optional[_Upstream] = None  # owning core's backbone
        # While a connect awaits the core's auth verdict, broadcasts are
        # held here instead of the socket; flushed on success, dropped on
        # refusal. None = no gate (normal delivery).
        self._gate_buffer: Optional[list[bytes]] = None
        # relay-tree link state (this "client" is a downstream gateway)
        self.is_link = False
        self.dsids: dict[int, int] = {}  # downstream sid → parent sid
        self.fsids: dict[int, int] = {}  # parent sid → downstream sid
        self.fups: dict[int, _Upstream] = {}  # parent sid → owning core
        self.ftopic_names: dict[int, str] = {}  # parent sid → topic
        self.ftopic_refs: dict[str, int] = {}  # topic → live muxed sids

    def push_raw(self, raw: bytes) -> None:
        if self._gate_buffer is not None:
            self._gate_buffer.append(raw)
            return
        try:
            if not self.writer.is_closing():
                self.writer.write(raw)
        except RuntimeError:
            pass

    def push(self, obj: dict) -> None:
        self.push_raw(_encode_frame(obj))

    async def handle(self, frame: dict) -> None:
        t = frame.get("t")
        gw = self.gw
        if t == "connect":
            # A re-connect on a live session must first release the old
            # registration, else the prior sid's core-side connection and
            # topic refcount leak until the socket closes.
            if self.sid is not None:
                self.detach()
            self.sid = next(gw.sid_counter)
            self.binary = bool(frame.get("bin"))
            self.topic = f"{frame['tenant']}/{frame['doc']}"
            # Register NOW (the core broadcasts this client's own join
            # synchronously with the fconnect — miss it and the client
            # never activates) but GATE delivery behind the core's auth
            # verdict: buffered frames flush only on success, and a
            # refusal unregisters + drops the buffer, so a rejected
            # (tokenless) client never receives a byte of the doc's live
            # stream even while authorized clients keep the topic open.
            self._gate_buffer = []
            gw.sessions[self.sid] = self
            gw.topic_sessions.setdefault(self.topic, set()).add(self)
            try:
                # route to the doc's owning core (sharded mode resolves
                # the partition lease; classic mode returns THE core).
                # The gateway ALWAYS asks for binary fops — it relays
                # them to binary clients by byte-slicing and re-encodes
                # JSON locally for legacy clients, keeping the expensive
                # per-op encode off the core either way.
                self.up = await gw.upstream_for(frame["tenant"],
                                                frame["doc"])
                self.up.sessions.add(self.sid)
                reply = await gw.upstream_request({
                    "t": "fconnect", "sid": self.sid,
                    "tenant": frame["tenant"], "doc": frame["doc"],
                    "details": frame.get("details"),
                    "token": frame.get("token"), "bin": 1,
                    "readonly": frame.get("readonly")}, self.up)
            except BaseException:
                self._gate_buffer = None
                self.detach()
                gw.note_route_failure(frame["tenant"], frame["doc"])
                raise
            self._gate_buffer, buffered = None, self._gate_buffer
            self.push({"t": "connected", "rid": frame.get("rid"),
                       "clientId": reply["clientId"], "seq": reply["seq"],
                       "mode": reply.get("mode", "write"),
                       "maxMessageSize": reply.get("maxMessageSize")})
            for raw in buffered:
                self.push_raw(raw)
        elif t == "submit":
            if self.up is None:
                raise RuntimeError("submit before connect")
            # ops pass through verbatim — no payload re-encode
            gw.upstream_send({"t": "fsubmit", "sid": self.sid,
                              "ops": frame["ops"]}, self.up)
        elif t == "signal":
            if self.up is None:
                raise RuntimeError("signal before connect")
            gw.upstream_send({"t": "fsignal", "sid": self.sid,
                              "content": frame["content"],
                              "type": frame.get("type", "signal")},
                             self.up)
        elif t == "disconnect":
            self.detach()
        elif t == "ping":
            # answered HERE, not relayed: the probe checks this hop's
            # liveness, and the upstream has its own reader watchdog
            self.push({"t": "pong"})
        elif t == "gateway_counters":
            # THIS tier's relay counters (splices / encodes / upstream
            # frames+bytes) — answered locally, unlike admin_counters
            # which relays to the core. The read-storm bench asserts
            # the zero-re-encode contract through this door.
            self.push({"t": "gateway_counters", "rid": frame.get("rid"),
                       "counters": gw.counters.snapshot()})
        elif t == "fconnect":
            # a downstream GATEWAY muxing a session through this tier
            await self._handle_fconnect(frame)
        elif t == "fsubmit":
            psid = self.dsids.get(frame["sid"])
            if psid is None:
                raise RuntimeError("fsubmit on unknown downstream sid")
            gw.upstream_send({"t": "fsubmit", "sid": psid,
                              "ops": frame["ops"]}, self.fups[psid])
        elif t == "fsignal":
            psid = self.dsids.get(frame["sid"])
            if psid is None:
                raise RuntimeError("fsignal on unknown downstream sid")
            gw.upstream_send({"t": "fsignal", "sid": psid,
                              "content": frame["content"],
                              "type": frame.get("type", "signal")},
                             self.fups[psid])
        elif t == "fdisconnect":
            psid = self.dsids.pop(frame["sid"], None)
            if psid is not None:
                self._release_link_sid(psid)
        elif t in ("get_deltas", "get_versions", "get_tree", "read_blob",
                   "write_blob", "upload_summary"):
            up = await gw.upstream_for(frame["tenant"], frame["doc"])
            reply = await gw.upstream_request(
                {k: v for k, v in frame.items() if k != "rid"}, up)
            reply["rid"] = frame.get("rid")
            self.push(reply)
        elif t in ("get_deltas_cols", "get_snapshot_cols"):
            await self._relay_bulk(frame)
        else:
            self.push({"t": "error", "rid": frame.get("rid"),
                       "message": f"unknown frame type {t!r}"})

    async def _handle_fconnect(self, frame: dict) -> None:
        """Open a muxed downstream session through this tier: allocate a
        parent-side sid, register the LINK on the doc topic (once per
        topic — fan-out to the whole downstream subtree is one frame),
        and splice the fconnect upstream.

        No gate buffer on links: the frames that reach a downstream
        gateway before ITS client's auth verdict land in that client's
        own gate buffer, so an unauthorized client still never sees a
        byte — the gate lives at the tree's leaves."""
        gw = self.gw
        dsid = frame["sid"]
        if not self.is_link:
            self.is_link = True
            self.binary = True  # links always speak binwire
            gw.links.add(self)
        stale = self.dsids.pop(dsid, None)
        if stale is not None:
            # downstream reused a sid before its fdisconnect drained
            self._release_link_sid(stale)
        tenant, doc = frame["tenant"], frame["doc"]
        topic = f"{tenant}/{doc}"
        psid = next(gw.sid_counter)
        # register BEFORE the upstream fconnect for the same reason the
        # client path does: the join broadcast is synchronous with it
        gw.sessions[psid] = self
        self.dsids[dsid] = psid
        self.fsids[psid] = dsid
        self.ftopic_names[psid] = topic
        self.ftopic_refs[topic] = self.ftopic_refs.get(topic, 0) + 1
        if self.ftopic_refs[topic] == 1:
            gw.topic_sessions.setdefault(topic, set()).add(self)
        try:
            up = await gw.upstream_for(tenant, doc)
            up.sessions.add(psid)
            self.fups[psid] = up
            reply = await gw.upstream_request({
                "t": "fconnect", "sid": psid, "tenant": tenant,
                "doc": doc, "details": frame.get("details"),
                "token": frame.get("token"), "bin": 1,
                "readonly": frame.get("readonly")}, up)
        except BaseException:
            self.dsids.pop(dsid, None)
            self._release_link_sid(psid, fdisconnect=False)
            gw.note_route_failure(tenant, doc)
            raise
        self.push({"t": "fconnected", "rid": frame.get("rid"),
                   "sid": dsid, "clientId": reply["clientId"],
                   "seq": reply["seq"],
                   "mode": reply.get("mode", "write"),
                   "maxMessageSize": reply.get("maxMessageSize")})

    def _release_link_sid(self, psid: int, fdisconnect: bool = True
                          ) -> None:
        gw = self.gw
        gw.sessions.pop(psid, None)
        self.fsids.pop(psid, None)
        topic = self.ftopic_names.pop(psid, None)
        if topic is not None and topic in self.ftopic_refs:
            self.ftopic_refs[topic] -= 1
            if not self.ftopic_refs[topic]:
                del self.ftopic_refs[topic]
                peers = gw.topic_sessions.get(topic)
                if peers is not None:
                    peers.discard(self)
                    if not peers:
                        gw.topic_sessions.pop(topic, None)
        up = self.fups.pop(psid, None)
        if up is not None:
            up.sessions.discard(psid)
            if fdisconnect and not up.writer.is_closing():
                gw.upstream_send({"t": "fdisconnect", "sid": psid}, up)

    async def _relay_bulk(self, frame: dict) -> None:
        """Columnar bulk RPCs (snapshot chunks, delta blocks) stream
        multi-frame responses, and snapshot chunk pushes carry rid 0 —
        they can't be demuxed on the shared backbone. Relay them over a
        DEDICATED upstream connection per request instead: every frame
        passes through verbatim (chunk bytes splice down the tree with
        zero re-encode) until the JSON terminal, which carries the
        caller's rid unchanged. Stacks through gateway tiers: the
        parent tier sees an ordinary client-protocol bulk RPC."""
        gw = self.gw
        up = await gw.upstream_for(frame["tenant"], frame["doc"])
        host, _, port = up.address.rpartition(":")
        reader, writer = await asyncio.open_connection(
            host or "127.0.0.1", int(port))
        try:
            writer.write(_encode_frame(frame))
            await writer.drain()
            while True:
                body = await _read_body(reader)
                if body is None:
                    raise ConnectionError("core closed during bulk relay")
                if binwire.is_binary(body):
                    self.push_raw(binwire.frame(body))
                    continue
                self.push(json.loads(body.decode()))  # rid-tagged terminal
                break
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def detach(self) -> None:
        if self.is_link:
            # the downstream gateway's socket is gone: release every
            # muxed session it held (core-side fdisconnects drain the
            # quorum exactly as if each client had left)
            for psid in list(self.dsids.values()):
                self._release_link_sid(psid)
            self.dsids.clear()
            self.gw.links.discard(self)
            self.is_link = False
        if self.sid is not None:
            self.gw.sessions.pop(self.sid, None)
            if self.topic is not None:
                peers = self.gw.topic_sessions.get(self.topic)
                if peers is not None:
                    peers.discard(self)
                    if not peers:  # prune emptied topics
                        self.gw.topic_sessions.pop(self.topic, None)
            if self.up is not None:
                self.up.sessions.discard(self.sid)
                if not self.up.writer.is_closing():
                    self.gw.upstream_send(
                        {"t": "fdisconnect", "sid": self.sid}, self.up)
                self.up = None
            self.sid = None


class _Upstream:
    """One backbone connection to one core process."""

    def __init__(self, gw: "Gateway", address: str,
                 writer: asyncio.StreamWriter):
        self.gw = gw
        self.address = address
        self.writer = writer
        self.sessions: set[int] = set()  # sids registered on this core
        self.pending_rids: set[int] = set()  # in-flight requests HERE


class Gateway:
    """The classic single-core topology. ``shard_dir``/``shards`` and
    ``table_server`` (sharded-core routing: each doc to the core holding
    its partition's lease) are ROADMAP A10 and raise."""

    def __init__(self, core_host: str, core_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 shard_dir: Optional[str] = None, shards: int = 0,
                 table_server: Optional[str] = None):
        self.core_host, self.core_port = core_host, core_port
        self.host, self.port = host, port
        self.sessions: dict[int, _GatewaySession] = {}
        self.topic_sessions: dict[str, set[_GatewaySession]] = {}
        self.sid_counter = itertools.count(1)
        self._rid_counter = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        if shard_dir is not None or shards or table_server:
            # sharded-core routing: the placement leases, the epoch
            # table and its routing cache come with the sharded core
            raise _not_ported("sharded-core routing", "A10")
        self._upstreams: dict[str, _Upstream] = {}
        self._upstream_dials: dict[str, "asyncio.Future"] = {}
        self._up_default: Optional[_Upstream] = None
        # relay-tree: downstream gateway link sessions (fplacement
        # pushes forward to every one of them)
        self.links: set[_GatewaySession] = set()
        # splice-vs-encode accounting for the fan-out tier
        # (fanout.relay.splices should dwarf fanout.relay.encodes on an
        # all-binary tree — the acceptance gate asserts encodes == 0)
        self.counters = tier_counters("fanout")

    # ----------------------------------------------------------- upstream

    async def _open_upstream(self, address: str) -> _Upstream:
        while True:
            up = self._upstreams.get(address)
            if up is not None and not up.writer.is_closing():
                return up
            dial = self._upstream_dials.get(address)
            if dial is None:
                break
            # another session is already dialing this core: share its
            # connection. Two concurrent dials would open TWO backbone
            # connections to one core — the core tracks its per-topic
            # fan-out subscription per connection, so every broadcast
            # would reach this gateway (and its clients) TWICE.
            up = await asyncio.shield(dial)
            if up is not None and not up.writer.is_closing():
                return up
        fut = asyncio.get_running_loop().create_future()
        self._upstream_dials[address] = fut
        try:
            host, _, port = address.rpartition(":")
            reader, writer = await asyncio.open_connection(
                host or "127.0.0.1", int(port))
            sock = writer.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            up = _Upstream(self, address, writer)
            self._upstreams[address] = up
            # keep a strong ref on the upstream: the loop's refs are
            # weak, and a gc'd reader task silently freezes every
            # session on this core (acks stop; clients stall until
            # reconnect)
            up.reader_task = asyncio.get_running_loop().create_task(
                self._upstream_loop(reader, up))
            fut.set_result(up)
            return up
        finally:
            del self._upstream_dials[address]
            if not fut.done():
                # dial failed: waiters retry (and dial themselves);
                # the failure propagates to THIS caller via the raise
                fut.set_result(None)

    async def _connect_upstream(self) -> None:
        self._up_default = await self._open_upstream(
            f"{self.core_host}:{self.core_port}")

    async def upstream_for(self, tenant: str, doc: str) -> _Upstream:
        """The backbone connection of the core owning this doc: the one
        core (sharded-core routing is ROADMAP A10)."""
        if self._up_default is None or self._up_default.writer.is_closing():
            self._up_default = None
            await self._connect_upstream()
        return self._up_default

    def note_route_failure(self, tenant: str, doc: str) -> None:
        """A core refused the doc. A sharded-core gateway drops its
        cached route here; the one core has none to drop."""

    def upstream_send(self, obj: dict, up: Optional[_Upstream] = None
                      ) -> None:
        (up or self._up_default).writer.write(_encode_frame(obj))

    def upstream_send_raw(self, raw: bytes,
                          up: Optional[_Upstream] = None) -> None:
        (up or self._up_default).writer.write(raw)

    async def upstream_request(self, obj: dict,
                               up: Optional[_Upstream] = None) -> dict:
        rid = next(self._rid_counter)
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        target = up or self._up_default
        if target is None:
            raise ConnectionError("no live core connection")
        target.pending_rids.add(rid)
        try:
            self.upstream_send(dict(obj, rid=rid), target)
            reply = await fut
        finally:
            target.pending_rids.discard(rid)
            self._pending.pop(rid, None)
        if reply.get("t") == "error":
            raise _CoreError(reply)
        return reply

    async def _upstream_loop(self, reader: asyncio.StreamReader,
                             up: _Upstream) -> None:
        try:
            while True:
                body = await _read_body(reader)
                if body is None:
                    break
                self.counters.inc("fanout.upstream.frames")
                self.counters.inc("fanout.upstream.bytes", len(body) + 4)
                if binwire.is_binary(body):
                    self._dispatch_upstream_binary(body)
                else:
                    self._dispatch_upstream(json.loads(body.decode()))
        finally:
            # this upstream is gone: only ITS clients are dead. In
            # sharded mode the takeover core will serve them on
            # reconnect. A relay LINK's writer closing kills the whole
            # downstream gateway socket — crash-equivalent on purpose:
            # the downstream tier's own upstream-loss teardown then
            # closes ITS clients, whose drivers reconnect and gap-repair
            # through the driver catch-up fetch.
            self._upstreams.pop(up.address, None)
            if self._up_default is up:
                self._up_default = None
            for sid in list(up.sessions):
                session = self.sessions.get(sid)
                if session is not None:
                    try:
                        session.writer.close()
                    except Exception:
                        pass
            # fail exactly THIS core's in-flight requests — a request
            # pending on a live core must keep waiting for its reply
            for rid in list(up.pending_rids):
                fut = self._pending.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_exception(
                        ConnectionError("core disconnected"))

    @loop_only("gateway")
    def _dispatch_upstream_binary(self, body: bytes) -> None:
        """Relay a binary fops batch or fpresence flush: downstream
        gateway LINKS get the backbone bytes VERBATIM (topic intact —
        their own dispatch splices again), binary clients get the
        topic-stripped slice, and only a legacy JSON client costs a
        re-encode (lazy, once per frame however many legacy clients).
        The op/signal payloads are never decoded on the binary path —
        that's the relay-tree invariant the smoke gate counter-asserts:
        ``fanout.relay.encodes`` stays 0 above the first tier."""
        if body[1] == binwire.FT_FPRESENCE:
            topic, client_body = binwire.fpresence_strip_topic(body)
        else:
            topic, client_body = binwire.fops_strip_topic(body)
        self.counters.inc("fanout.relay.splices")
        raw = fraw = json_raw = None
        for session in self.topic_sessions.get(topic, ()):
            if session.is_link:
                if fraw is None:
                    fraw = binwire.frame(body)
                session.push_raw(fraw)
            elif session.binary:
                if raw is None:
                    raw = binwire.frame(client_body)
                session.push_raw(raw)
            else:
                if json_raw is None:
                    json_raw = self._legacy_json(body, client_body)
                    self.counters.inc("fanout.relay.encodes")
                session.push_raw(json_raw)

    def _legacy_json(self, body: bytes, client_body: bytes) -> bytes:
        """Materialize the JSON wire form of a binary fan-out frame for
        a legacy client (possibly several frames concatenated — the
        stream is length-prefixed, one write carries them all)."""
        from ..protocol.serialization import message_to_dict

        if body[1] == binwire.FT_FPRESENCE:
            return b"".join(
                _encode_frame({"t": "signal",
                               "signal": message_to_dict(s)})
                for s in binwire.decode_presence(client_body))
        _, msgs = binwire.decode_ops(client_body)
        return _encode_frame(
            {"t": "ops", "msgs": [message_to_dict(m) for m in msgs]})

    @loop_only("gateway")
    def _dispatch_upstream(self, frame: dict) -> None:
        rid = frame.get("rid")
        if rid is not None:
            fut = self._pending.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_result(frame)
            return
        t = frame.get("t")
        if t == "fops":
            # ONE re-encode for all local subscribers of the doc;
            # downstream links get the backbone frame verbatim
            raw = fraw = None
            for session in self.topic_sessions.get(frame["topic"], ()):
                if session.is_link:
                    if fraw is None:
                        fraw = _encode_frame(frame)
                    session.push_raw(fraw)
                else:
                    if raw is None:
                        raw = _encode_frame({"t": "ops",
                                             "msgs": frame["msgs"]})
                    session.push_raw(raw)
        elif t == "fnack":
            session = self.sessions.get(frame["sid"])
            if session is not None:
                if session.is_link:
                    dsid = session.fsids.get(frame["sid"])
                    if dsid is not None:
                        session.push({"t": "fnack", "sid": dsid,
                                      "nack": frame["nack"]})
                else:
                    session.push({"t": "nack", "nack": frame["nack"]})
        elif t == "fsignal":
            raw = fraw = None
            for session in self.topic_sessions.get(frame["topic"], ()):
                if session.is_link:
                    if fraw is None:
                        fraw = _encode_frame(frame)
                    session.push_raw(fraw)
                else:
                    if raw is None:
                        raw = _encode_frame({"t": "signal",
                                             "signal": frame["signal"]})
                    session.push_raw(raw)
        elif t == "fplacement":
            # routing flip push: a sharded core committed a migration.
            # The one core's gateway has no routing cache to patch
            # (ROADMAP A10); relay tiers forward the push verbatim so the
            # whole tree learns the flip at once.
            raw = None
            for session in list(self.links):
                if raw is None:
                    raw = _encode_frame(frame)
                session.push_raw(raw)
        elif t == "fdropped":
            # the core revoked this client's partition (lease moved):
            # close just that client; its auto-reconnect re-resolves the
            # owner and lands on the takeover core. For a muxed session
            # on a relay LINK, the drop forwards downstream and releases
            # only that sid — the link (its other docs) stays up.
            session = self.sessions.get(frame["sid"])
            if session is None:
                pass
            elif session.is_link:
                psid = frame["sid"]
                dsid = session.fsids.get(psid)
                if dsid is not None:
                    session.dsids.pop(dsid, None)
                session._release_link_sid(psid, fdisconnect=False)
                if dsid is not None:
                    session.push({"t": "fdropped", "sid": dsid})
            else:
                try:
                    session.writer.close()
                except Exception:
                    pass

    # ------------------------------------------------------------- clients

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        session = _GatewaySession(self, writer)
        recorder = get_recorder()
        conn_id = f"gw-{id(session) & 0xFFFFFF:06x}"
        try:
            while True:
                body = await _read_body(reader)
                if body is None:
                    break
                # drain-batched serving (same shape as the core's
                # _handle_conn): relay every frame already buffered on
                # this socket, then drain the writer once per wave — a
                # client's coalesced submit burst costs one drain, not
                # one per frame
                n = 0
                deferred: list = []
                while body is not None:
                    n += 1
                    recorder.frame(conn_id, "in", body)
                    if binwire.is_binary(body):
                        # hot path: rewrite submit → fsubmit by
                        # prepending the sid — op payloads are relayed,
                        # never decoded here
                        ft = body[1] if len(body) >= 2 else 0
                        if (ft in (binwire.FT_SUBMIT,
                                   binwire.FT_COLS_SUBMIT)
                                and session.sid is not None
                                and session.up is not None):
                            if (ft == binwire.FT_COLS_SUBMIT
                                    and body[-1]):
                                # sampled frame (hoptail count > 0):
                                # append gateway/relay in place —
                                # unsampled frames cost one byte read
                                body = binwire.append_hop(
                                    body, HOP_RELAY, time.time())
                            self.upstream_send_raw(binwire.frame(
                                binwire.submit_to_fsubmit(body,
                                                          session.sid)),
                                session.up)
                        elif (ft in (binwire.FT_FSUBMIT,
                                     binwire.FT_COLS_FSUBMIT)
                                and session.is_link):
                            # relay-tree write path: re-address the
                            # muxed sid to this tier's sid, payload
                            # bytes untouched
                            psid = session.dsids.get(
                                binwire.fsubmit_sid(body))
                            up = session.fups.get(psid)
                            if up is not None:
                                if (ft == binwire.FT_COLS_FSUBMIT
                                        and body[-1]):
                                    body = binwire.append_hop(
                                        body, HOP_RELAY, time.time())
                                self.upstream_send_raw(binwire.frame(
                                    binwire.fsubmit_rewrite_sid(body,
                                                                psid)),
                                    up)
                        else:
                            session.push(
                                {"t": "error",
                                 "message": "unexpected binary frame"})
                    else:
                        frame = json.loads(body.decode())
                        if frame.get("t") in _BULK_FRAMES:
                            # lane priority (mirrors the core's
                            # _handle_conn): bulk backfill relays run
                            # after the wave's interactive frames
                            deferred.append(frame)
                        else:
                            try:
                                await session.handle(frame)
                            except (RuntimeError, ConnectionError) as e:
                                # a core error reply (auth refusal,
                                # storage failure) answers THIS request
                                # — it must not kill the socket
                                session.push(_error_frame(frame, e))
                    body = None
                    if n < 64 and _frame_buffered(reader):
                        body = await _read_body(reader)
                for frame in deferred:
                    try:
                        await session.handle(frame)
                    except (RuntimeError, ConnectionError) as e:
                        session.push(_error_frame(frame, e))
                await writer.drain()
        except (ValueError, json.JSONDecodeError):
            pass
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception as e:  # noqa: BLE001 — unhandled tier failure:
            # dump the flight recorder so the frames preceding the
            # escape are preserved for post-mortem
            try:
                recorder.dump("gateway_unhandled",
                              conn=conn_id, error=str(e))
            except Exception:
                pass
        finally:
            session.detach()
            try:
                writer.close()
            except Exception:
                pass

    async def _start(self) -> None:
        await self._connect_upstream()
        server = await asyncio.start_server(
            self._handle_client, self.host, self.port, backlog=1024)
        self.port = server.sockets[0].getsockname()[1]

    def serve_forever(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(self._start())
        print(f"LISTENING {self.host}:{self.port}", flush=True)
        loop.run_forever()


def main() -> None:
    import gc

    p = argparse.ArgumentParser(
        description="Fluid gateway front end (PyTorch port)")
    p.add_argument("--core-host", default="127.0.0.1")
    p.add_argument("--core-port", type=int, default=0,
                   help="the ordering core's port")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--shard-dir", default=None,
                   help="sharded-core deployment dir (not ported, "
                        "ROADMAP A10)")
    p.add_argument("--shards", type=int, default=0,
                   help="number of doc partitions in the sharded core "
                        "(not ported, ROADMAP A10)")
    p.add_argument("--table-server", default=None, metavar="HOST:PORT",
                   help="remote-host routing (not ported, ROADMAP A10)")
    p.add_argument("--host-id", default=None,
                   help="this gateway's host group id (multi-host "
                        "fleets; not ported, ROADMAP A10)")
    p.add_argument("--upstream-gateway", default=None, metavar="HOST:PORT",
                   help="relay-tree mode (not ported, ROADMAP A10)")
    p.add_argument("--python", action="store_true",
                   help="use the asyncio relay (compat path: serves "
                        "JSON-ops legacy clients the native loop refuses)")
    args = p.parse_args()
    for flag, value in (("--shard-dir", args.shard_dir),
                        ("--shards", args.shards),
                        ("--host-id", args.host_id),
                        ("--table-server", args.table_server),
                        ("--upstream-gateway", args.upstream_gateway)):
        if value:
            raise _not_ported(f"option {flag}", "A10")
    if not args.core_port:
        p.error("--core-port is required")
    if not args.python:
        # default: the C++ epoll relay (csrc/gateway.cpp) — zero Python
        # on the hot path. A build or load failure raises: only
        # --python selects the asyncio relay.
        from ..native.gateway import NativeGateway

        ng = NativeGateway(args.core_host, args.core_port,
                           host=args.host, port=args.port)
        print(f"LISTENING {args.host}:{ng.port}", flush=True)
        raise SystemExit(0 if ng.run() == 0 else 1)
    # relay path allocates acyclic graphs only; cycle-collector pauses
    # would land directly on forwarded-frame latency (see front_end main)
    gc.freeze()
    gc.disable()
    Gateway(args.core_host, args.core_port,
            host=args.host, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
