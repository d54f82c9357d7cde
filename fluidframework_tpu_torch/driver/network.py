"""Network driver: client stack ⇄ NetworkFrontEnd over TCP.

JAX counterpart: ``fluidframework_tpu/driver/network.py``; the port's
copy, imports rebased to this package. It speaks the same wire as the
JAX package's front end and gateway, so either package's client talks to
either package's service. One repair (ROADMAP C9): the shed-retry lane
parks ops in clientSeq order (``_queue_shed_retry``), resubmits only a
gap-free run with no unresolved op before it (``_shed_run``), and holds
newer ops until the ops whose shed nacks were still on the way when it
resubmitted are resolved (``_held``), for as long as the connection
lives: a disconnect resolves them all, since the reconnect resubmits
every unacked op. The JAX driver appends in nack order and resubmits
the whole lane with whatever is pending.

Ref: packages/drivers/routerlicious-driver (documentService.ts:22 wires
stream + delta storage + snapshot storage to the service endpoints) and
driver-base/src/documentDeltaConnection.ts:53 (the socket client emitting
connect_document/submitOp and listening op/nack/signal). Same wire format
as service/front_end.py: 4-byte length-prefixed JSON frames.

Concurrency: a daemon reader thread dispatches pushed events (op, nack,
signal) into the client callbacks under ``self.lock``; submits take the
same lock, so the client replica never interleaves a local submit with a
remote dispatch. Request/response calls (deltas, storage) ride the same
connection, matched by request id.

Ingress coalescing: binary submits pass through an adaptive window —
ops submitted within the window (or while a send is in flight) merge
into ONE binwire boxcar frame, so a hot client pays one sendall + one
server-side parse per wave instead of per op. The window self-tunes
from observed ack latency (EWMA over own-op round trips): an idle or
fast client sees window 0 and keeps the old inline sub-millisecond
submit; only a client whose acks already take milliseconds trades a
fraction of that latency for frame amortization. Set
``conn.coalesce_window`` to force a fixed window (tests, soak).
"""

from __future__ import annotations

import bisect
import itertools
import json
import random
import socket
import threading
import time
from typing import Any, Callable, Optional

from ..obs import tier_counters
from ..utils.affinity import blocking
from ..protocol import binwire
from ..protocol.messages import MessageType, TraceHop
from ..protocol.serialization import message_from_dict, message_to_dict
from ..utils.telemetry import HOP_SHED, HOP_SUBMIT, Counters
from .definitions import (
    DocumentDeltaConnection,
    DocumentDeltaStorage,
    DocumentService,
    DocumentServiceFactory,
    DocumentStorage,
)

#: chaos seam (chaos/ of this package): when set, transports constructed
#: while installed route outbound frames through the hook for drop /
#: duplicate / delay / reorder / mid-frame-truncate faults. Captured per
#: transport at construction so arming cannot race live connections.
FRAME_FAULT_HOOK = None

#: the longest a connect waits for the reader thread's backlog (``settle``)
SETTLE_TIMEOUT_S = 5.0

#: binwire boxcars carry a u16 op count; chunk well below it so the
#: string pool of a pathological wave cannot overflow either
_MAX_BOXCAR_OPS = 60000

#: how long a shed lane waits before it looks again when an op sent
#: before its first is still unresolved (its nack or ack is on the way)
_SHED_HOLD_S = 0.05

#: adaptive-window tuning: below this observed ack latency the client
#: counts as fast/idle and submits inline (window 0); above it the
#: window is ack_ewma/8 capped here — always a small fraction of the
#: latency the client is already paying
_COALESCE_MIN_ACK_S = 0.005
_COALESCE_MAX_WINDOW_S = 0.004


class LogTruncatedError(RuntimeError):
    """The requested backfill range reaches below the server's retention
    base: the prefix is summary-covered and gone from the op log — catch
    up from the latest summary instead of retrying a range that can
    never fill. (The driver's own class, mirroring the service-side
    exception: drivers never import service modules.)"""

    def __init__(self, base: int, snapshot_seq=None):
        super().__init__(
            f"op log truncated below seq {base}: reload from the latest "
            "acked summary")
        self.base = base
        # the snapshot-backed base the server advertised: an acked
        # summary at this seq boots past the hole (always ≥ base)
        self.snapshot_seq = snapshot_seq


class BootPendingError(RuntimeError):
    """The doc's first route landed during a cold-start boot storm and
    the core's rehydration executor parked it: retry after the hinted
    backoff (the connect-side twin of the admission shed lane). The
    driver's connect loop absorbs this transparently."""

    def __init__(self, retry_after: int):
        super().__init__(
            f"doc boot parked by cold-start admission; retry in "
            f"{retry_after}ms")
        self.retry_after_ms = retry_after


#: Give a parked connect this long to win a boot slot before erroring
#: out — covers a 10k-doc storm draining through a bounded executor.
_BOOT_RETRY_MAX_S = 60.0


class _Transport:
    """One framed TCP connection + reader thread + rid-matched requests."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        # op frames are small and latency-bound: Nagle coalescing adds
        # tens of ms per hop under load
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.timeout = timeout
        self.lock = threading.RLock()  # serializes dispatch vs. submit
        self._wlock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: dict[int, dict] = {}  # rid → reply frame
        # rid → decoded backfill messages from FT_COLS_DELTAS pushes; the
        # pushes and the terminal JSON reply ride the same wire and the
        # same reader thread, so by the time the reply is matched every
        # block for that rid has landed here
        self._blocks: dict[int, list] = {}
        # chunk_hash → raw snapcols chunk bytes from FT_COLS_SNAP pushes
        # (content-addressed, so the hash — not a rid — is the key; same
        # same-thread ordering guarantee as _blocks)
        self._snap_chunks: dict[str, bytes] = {}
        # rid → decoded history commits from FT_HISTORY pushes (the
        # history_log listing; same same-thread ordering as _blocks)
        self._history: dict[int, list] = {}
        self._pending_cv = threading.Condition()
        self._push_handlers: dict[str, Callable[[dict], None]] = {}
        # binary ops batches bypass the dict layer entirely
        self.on_binary_ops: Optional[Callable[[list], None]] = None
        # coalesced FT_PRESENCE batches (the ephemeral signal lane)
        self.on_presence: Optional[Callable[[list], None]] = None
        self.on_disconnect: Optional[Callable[[str], None]] = None
        self._closed = False
        self._fault = FRAME_FAULT_HOOK
        self._held: list[bytes] = []  # delayed frames awaiting overtake
        self._idle_windows = 0  # consecutive recv-timeout windows
        # frames the reader has taken off the socket, and those it has
        # finished handling (``settle``; counted under _pending_cv)
        self._frames_read = 0
        self._frames_done = 0
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="fluid-net-reader")
        self._reader.start()

    # ------------------------------------------------------------- sending

    def send(self, frame: dict) -> None:
        self.send_body(json.dumps(frame, separators=(",", ":")).encode(),
                       kind=frame.get("t"))

    def send_body(self, body: bytes, kind: Optional[str] = None) -> None:
        """Send a length-prefix-framed body (JSON or binwire)."""
        if self._fault is not None:
            self._send_with_faults(body, kind)
            return
        with self._wlock:
            self.sock.sendall(len(body).to_bytes(4, "big") + body)

    def _send_with_faults(self, body: bytes, kind: Optional[str]) -> None:
        """Chaos-armed send path: consult the fault plane per frame.

        - ``drop``: the frame vanishes (a lost datagram-equivalent; TCP
          never does this, but a dying proxy/LB absolutely does).
        - ``dup``: the frame arrives twice (an at-least-once relay).
        - ``delay``/``reorder``: the frame is held and flushed AFTER the
          next frame — a later frame overtakes it on the wire.
        - ``truncate``: half the body is sent under a full-length header,
          then the connection dies mid-frame — the peer's framed read
          blocks on bytes that never come and sees the close.
        """
        directive = self._fault("net.send", kind=kind, size=len(body))
        if directive in ("delay", "reorder"):
            self._held.append(body)
            return
        if directive == "truncate":
            with self._wlock:
                try:
                    self.sock.sendall(
                        len(body).to_bytes(4, "big")
                        + body[:len(body) // 2])
                except OSError:
                    pass
            self.close()
            return
        if directive == "drop":
            frames = []
        elif directive == "dup":
            frames = [body, body]
        else:
            frames = [body]
        with self._wlock:
            # held (delayed) frames flush AFTER this one: the overtake
            # IS the reorder
            frames += self._held
            self._held = []
            for b in frames:
                self.sock.sendall(len(b).to_bytes(4, "big") + b)

    def request(self, frame: dict) -> dict:
        """Send a frame with a request id; block for the matching reply."""
        return self.request_rid(frame)[1]

    @blocking("parks the calling thread on a condition variable until the reply frame or timeout")
    def request_rid(self, frame: dict) -> tuple[int, dict]:
        """Like :meth:`request` but also returns the rid, so callers can
        collect rid-tagged binary pushes (:meth:`take_blocks`)."""
        rid = next(self._rid)
        self.send(dict(frame, rid=rid))
        with self._pending_cv:
            ok = self._pending_cv.wait_for(
                lambda: rid in self._pending or self._closed,
                timeout=self.timeout)
            if not ok or rid not in self._pending:
                self._blocks.pop(rid, None)
                self._history.pop(rid, None)
                raise ConnectionError(
                    f"no reply for {frame.get('t')} (connection "
                    f"{'closed' if self._closed else 'timed out'})")
            reply = self._pending.pop(rid)
        if reply.get("t") == "error":
            self._blocks.pop(rid, None)
            self._history.pop(rid, None)
            if reply.get("code") == "log_truncated":
                raise LogTruncatedError(int(reply.get("base", 0)),
                                        snapshot_seq=reply.get("snapshotSeq"))
            if reply.get("code") == "boot_pending":
                raise BootPendingError(int(reply.get("retryAfterMs", 50)))
            raise RuntimeError(f"server error: {reply.get('message')}")
        return rid, reply

    def settle(self, timeout: float) -> None:
        """Wait until the reader has handled every frame it had read when
        called (one it holds while waiting for ``lock`` included), or the
        connection closed, or ``timeout`` passed."""
        target = self._frames_read
        with self._pending_cv:
            self._pending_cv.wait_for(
                lambda: self._frames_done >= target or self._closed,
                timeout=timeout)

    def take_blocks(self, rid: int) -> list:
        """Claim the decoded backfill messages pushed for ``rid``."""
        return self._blocks.pop(rid, [])

    def take_snap_chunks(self) -> dict:
        """Claim the snapshot chunks pushed ahead of the last
        get_snapshot_cols terminal reply."""
        chunks, self._snap_chunks = self._snap_chunks, {}
        return chunks

    def take_history(self, rid: int) -> list:
        """Claim the decoded history commits pushed for ``rid``."""
        return self._history.pop(rid, [])

    # ------------------------------------------------------------ receiving

    def _recv_exactly(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except TimeoutError:
                # the connect timeout stays on the socket, but a PUSH
                # connection is legitimately silent for long stretches
                # (an idle doc; a paused/backlogged pipeline). Treating
                # the timeout as EOF killed the reader thread after 30 s
                # of server silence — the client then ignored every
                # later push (acks, ops) while looking connected (the
                # full composition's failure). Idle is not death —
                # but a VANISHED peer (powered off, partitioned,
                # SIGSTOPped core) sends no FIN either, so idle windows
                # escalate: probe with a ping (every terminator — core,
                # python gateway, native gateway — answers pong/error,
                # and ANY bytes prove liveness); two unanswered probe
                # windows in a row mean the peer is gone and the
                # disconnect path (auto-reconnect/failover) must run.
                if self._closed:
                    return None
                self._idle_windows += 1
                if self._idle_windows > 2:
                    return None
                try:
                    self.send({"t": "ping"})
                except OSError:
                    return None
                continue
            except (OSError, ValueError):
                return None
            if not chunk:
                return None
            self._idle_windows = 0
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        reason = "connection closed by server"
        try:
            while not self._closed:
                header = self._recv_exactly(4)
                if header is None:
                    break
                body = self._recv_exactly(int.from_bytes(header, "big"))
                if body is None:
                    break
                self._frames_read += 1
                try:
                    if binwire.is_binary(body):
                        if body[1] == binwire.FT_COLS_SNAP:
                            # snapshot chunk push: stage raw bytes by content
                            # hash for the booting requester (decode happens
                            # on the boot thread, not the reader)
                            _, h, chunk = binwire.read_snap_chunk(body)
                            self._snap_chunks[h] = chunk
                            continue
                        if body[1] == binwire.FT_COLS_DELTAS:
                            # rid-tagged backfill block: decode the column
                            # section client-side and stage it for the
                            # requester (the terminal JSON reply arrives
                            # after, on this same thread)
                            brid, msgs = binwire.read_cols_deltas(body)
                            self._blocks.setdefault(brid, []).extend(msgs)
                            continue
                        if body[1] == binwire.FT_HISTORY:
                            # rid-tagged history commit (the history_log
                            # listing): decode through the refgraph codec
                            # and stage for the requester
                            hrid, commit = binwire.decode_history_commit(body)
                            self._history.setdefault(hrid, []).append(commit)
                            continue
                        if body[1] == binwire.FT_PRESENCE:
                            # coalesced presence batch: one frame, N signals
                            # (the ephemeral lane — never sequenced)
                            cb = self.on_presence
                            if cb is not None:
                                sigs = binwire.decode_presence(body)
                                with self.lock:
                                    cb(sigs)
                            continue
                        cb = self.on_binary_ops
                        if cb is not None:
                            _, msgs = binwire.decode_ops(body)
                            with self.lock:
                                cb(msgs)
                        continue
                    frame = json.loads(body.decode())
                    rid = frame.get("rid")
                    if rid is not None:
                        with self._pending_cv:
                            self._pending[rid] = frame
                            self._pending_cv.notify_all()
                    else:
                        handler = self._push_handlers.get(frame.get("t"))
                        if handler is not None:
                            with self.lock:
                                handler(frame)
                finally:
                    with self._pending_cv:
                        self._frames_done += 1
                        self._pending_cv.notify_all()
        except Exception as e:  # a raising push handler must not leave
            reason = f"reader failed: {e}"  # requesters hanging silently
        finally:
            # wake any blocked requester, then notify disconnect
            with self._pending_cv:
                self._closed = True
                self._pending_cv.notify_all()
            if self.on_disconnect is not None:
                self.on_disconnect(reason)

    def on_push(self, t: str, handler: Callable[[dict], None]) -> None:
        self._push_handlers[t] = handler

    def close(self) -> None:
        # under the cv: a requester blocked in wait_for must observe the
        # flag and wake now, not when the reader thread happens to die
        with self._pending_cv:
            self._closed = True
            self._pending_cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class NetworkDeltaConnection(DocumentDeltaConnection):
    """The live stream over the shared transport. Events arriving before a
    callback is attached are buffered and flushed on attach (same contract
    as the in-proc ServerConnection)."""

    def __init__(self, transport: _Transport, tenant_id: str,
                 document_id: str, details: Any = None,
                 token: Optional[str] = None, binary: bool = True,
                 cache=None, counters: Optional[Counters] = None,
                 readonly: bool = False):
        self._t = transport
        self.lock = transport.lock
        self._binary = binary
        self.readonly = readonly
        self._tenant = tenant_id
        self._doc = document_id
        self._cache = cache
        self.counters = (counters if counters is not None
                         else tier_counters("driver"))
        #: 1-in-N submit tracing (0 = disarmed): every Nth boxcar gets a
        #: client/submit hop — columnar frames via the 9-byte hoptail
        #: append, rec frames via a TraceHop on the last op — so arming
        #: costs one counter increment per flush, not per op
        self.trace_sample_n = 0
        self._trace_seq = 0
        self._handlers: dict[str, Optional[Callable]] = {
            "op": None, "nack": None, "signal": None}
        self._buffers: dict[str, list] = {"op": [], "nack": [], "signal": []}
        self.on_disconnect = None
        self._disc_fired = False
        #: None = adaptive (tuned from ack latency); a float forces a
        #: fixed coalescing window in seconds (0.0 = always inline)
        self.coalesce_window: Optional[float] = None
        self._coal_cv = threading.Condition(threading.Lock())
        self._pending_ops: list = []
        self._send_inflight = False
        self._flush_deadline: Optional[float] = None
        self._flusher: Optional[threading.Thread] = None
        self._coal_closed = False
        self._inflight_ts: dict[int, float] = {}  # own cseq → submit time
        self._ack_ewma: Optional[float] = None
        # admission-shed retry state (under _coal_cv): ops the server
        # nacked with retry_after_ms, held in arrival (= clientSeq)
        # order; nothing newer may flush past them or the clientSeq
        # stream would gap at deli
        self._shed_ops: list = []
        self._shed_deadline: Optional[float] = None
        # wall clock of the EARLIEST park since the last shed flush:
        # when the held ops finally flush, the frame carries a HOP_SHED
        # stamp at this time so shed_to_submit measures park duration
        self._shed_park_wall: Optional[float] = None
        self._pending_shed_wall: Optional[float] = None
        # clientSeqs on the wire and neither acked nor nacked yet (noops,
        # which deli may consume unsequenced, are not counted): a
        # resubmit may not start past one of them. Written under
        # _coal_cv, except the ack's discard, which takes no lock: every
        # read of the set is one C call (min, copy, &=), never a Python
        # loop over it
        self._unresolved: set = set()
        # unresolved ops sent before the last resubmit and past its end
        # (their shed nacks are on the way): nothing newer may go out
        # before them, since the resubmit may clear the server's resume
        # watermark that sheds them
        self._stragglers: set = set()

        def on_ops(f):
            for d in f["msgs"]:
                self._deliver("op", message_from_dict(d))

        def on_binary_ops(msgs):
            for m in msgs:
                self._deliver("op", m)

        transport.on_push("ops", on_ops)
        transport.on_binary_ops = on_binary_ops
        transport.on_push("op", lambda f: self._deliver(
            "op", message_from_dict(f["msg"])))
        transport.on_push("nack", self._on_nack_frame)
        transport.on_push("signal", lambda f: self._deliver(
            "signal", message_from_dict(f["signal"])))

        def on_presence(sigs):
            for s in sigs:
                self._deliver("signal", s)

        transport.on_presence = on_presence
        transport.on_disconnect = self._fire_disconnect
        connect_frame = {
            "t": "connect", "tenant": tenant_id, "doc": document_id,
            "details": details, "token": token,
            "bin": 1 if binary else 0}
        if readonly:
            # fast reader session: no join op is ordered, the clientId
            # never enters the quorum — the session is free on the core's
            # op path (boots from snapshot cache + bounded backfill)
            connect_frame["readonly"] = 1
        # cold-start storm lane: a parked first-route (boot_pending)
        # retries with the server's jittered backoff instead of failing
        # the session — the connect-side twin of the shed-retry lane
        deadline = time.monotonic() + _BOOT_RETRY_MAX_S
        while True:
            try:
                reply = transport.request(connect_frame)
                break
            except BootPendingError as e:
                delay = (e.retry_after_ms / 1000.0) \
                    * (1.0 + 0.5 * random.random())
                if time.monotonic() + delay >= deadline:
                    raise
                self.counters.inc("boot.parked.retries")
                time.sleep(delay)
        self.client_id = reply["clientId"]
        self.initial_sequence_number = reply["seq"]
        self.mode = reply.get("mode", "write")
        self.max_message_size = reply.get("maxMessageSize")
        # server advertises the columnar backfill door only on direct
        # core connections (a gateway cannot relay the binary pushes)
        self.cols_backfill = bool(reply.get("colsBackfill"))

    def _on_nack_frame(self, f: dict) -> None:
        """Reader-thread nack dispatch: an admission shed (THROTTLING +
        retry_after_ms + the op echoed back) is a transparent retry,
        not an app-visible refusal — hold the op and flush it after the
        server's backoff. Every other nack delivers to ``on_nack``."""
        nack = message_from_dict(f["nack"])
        if (self._binary and nack.retry_after_ms
                and nack.operation is not None):
            self._queue_shed_retry(nack.operation, nack.retry_after_ms)
            return
        cseq = getattr(nack.operation, "client_sequence_number", None)
        with self._coal_cv:
            self._unresolved.discard(cseq)
        self._deliver("nack", nack)

    def _queue_shed_retry(self, op, retry_ms: int) -> None:
        # the parked ops stay in clientSeq order, the resubmit order the
        # server's resume watermark expects. Appending is not enough:
        # when the backoff runs out mid-nack-wave the flusher resends
        # the parked prefix, and if that prefix is shed again its nacks
        # arrive AFTER the wave's tail — appended, the next resubmit
        # would lead with a clientSeq past the watermark and be shed
        # for ordering on every retry (a livelock the JAX driver still
        # has). Jitter keeps a shed fleet from re-flooding in lockstep.
        delay = (retry_ms / 1000.0) * (1.0 + 0.5 * random.random())
        with self._coal_cv:
            if self._coal_closed:
                return
            self._unresolved.discard(op.client_sequence_number)
            bisect.insort(self._shed_ops, op,
                          key=lambda o: o.client_sequence_number)
            if self._shed_park_wall is None:
                self._shed_park_wall = time.time()
            self._shed_deadline = max(self._shed_deadline or 0.0,
                                      time.monotonic() + delay)
            self._ensure_flusher()
            self._coal_cv.notify_all()
        self.counters.inc("driver.submit.shed_retries")

    def _deliver(self, kind: str, event) -> None:
        if kind == "op" \
                and getattr(event, "client_id", None) == getattr(
                    self, "client_id", None):
            # own op came back sequenced: close the ack-latency loop the
            # adaptive coalescing window tunes from
            self._unresolved.discard(event.client_sequence_number)
            t0 = self._inflight_ts.pop(event.client_sequence_number, None)
            if t0 is not None:
                dt = time.monotonic() - t0
                e = self._ack_ewma
                self._ack_ewma = dt if e is None else e + 0.25 * (dt - e)
        if kind == "op" and self._cache is not None \
                and event.type == MessageType.SUMMARY_ACK:
            # a newer summary committed: the cached boot snapshot is
            # stale — drop it so the NEXT boot fetches the new head
            self._cache.invalidate(self._tenant, self._doc)
        cb = self._handlers[kind]
        if cb is None:
            self._buffers[kind].append(event)
        else:
            cb(event)

    def _set_handler(self, kind: str, cb) -> None:
        with self._t.lock:
            self._handlers[kind] = cb
            if cb is not None:
                pending, self._buffers[kind] = self._buffers[kind], []
                for event in pending:
                    cb(event)

    on_op = property(lambda self: self._handlers["op"],
                     lambda self, cb: self._set_handler("op", cb))
    on_nack = property(lambda self: self._handlers["nack"],
                       lambda self, cb: self._set_handler("nack", cb))
    on_signal = property(lambda self: self._handlers["signal"],
                         lambda self, cb: self._set_handler("signal", cb))

    def submit(self, messages) -> None:
        if self.readonly:
            # fail client-side: a readonly session has no quorum seat
            # and the server would only scope-nack the op anyway
            raise RuntimeError("cannot submit on a readonly connection")
        messages = list(messages)
        if not messages:
            return
        if not self._binary:
            with self._t.lock:
                self._t.send({"t": "submit",
                              "ops": [message_to_dict(m) for m in messages]})
            return
        cseq = getattr(messages[-1], "client_sequence_number", None)
        if cseq is not None:
            if len(self._inflight_ts) > 256:
                # evict only the OLDEST entry (dicts are insertion-
                # ordered): wiping the whole map here discarded every
                # in-flight ack-latency sample under a deep burst and
                # froze the coalescing EWMA at its pre-burst value
                del self._inflight_ts[next(iter(self._inflight_ts))]
                self.counters.inc("driver.inflight.evicted")
            self._inflight_ts[cseq] = time.monotonic()
        with self._coal_cv:
            if self._coal_closed:
                raise OSError("delta connection closed")
            if self._pending_ops:
                self.counters.inc("driver.submit.coalesced", len(messages))
            self._pending_ops.extend(messages)
            if self._shed_ops:
                # a shed backoff is running: the held ops must reach the
                # wire before anything newer, so this submit parks until
                # the flusher releases the whole queue at the deadline
                self._ensure_flusher()
                self._coal_cv.notify_all()
                return
            if self._send_inflight:
                # the in-flight flush drains the buffer before it parks:
                # these ops ride the next boxcar without a new wakeup
                return
            window = self._window()
            if window > 0.0:
                if self._flush_deadline is None:
                    self._flush_deadline = time.monotonic() + window
                self._ensure_flusher()
                self._coal_cv.notify_all()
                return
            self._send_inflight = True
        self._drain_and_send()

    def _window(self) -> float:
        w = self.coalesce_window
        if w is not None:
            return w
        e = self._ack_ewma
        if e is None or e < _COALESCE_MIN_ACK_S:
            return 0.0
        return min(_COALESCE_MAX_WINDOW_S, e * 0.125)

    def _ensure_flusher(self) -> None:
        if self._flusher is None or not self._flusher.is_alive():
            self._flusher = threading.Thread(
                target=self._flusher_loop, daemon=True,
                name="fluid-net-coalesce")
            self._flusher.start()

    def _flusher_loop(self) -> None:
        while True:
            with self._coal_cv:
                if self._coal_closed:
                    return
                d = (self._shed_deadline if self._shed_ops
                     else self._flush_deadline)
                if d is None or self._send_inflight \
                        or not (self._pending_ops or self._shed_ops):
                    self._coal_cv.wait(0.1)
                    continue
                now = time.monotonic()
                if now < d:
                    self._coal_cv.wait(d - now)
                    continue
                self._send_inflight = True
            try:
                self._drain_and_send()
            except OSError:
                # peer gone mid-flush: _send_ops already requeued the
                # unsent tail; a genuinely dead socket is the reader
                # thread's to notice and turn into a disconnect
                pass

    def _drain_and_send(self) -> None:
        """Flush the coalescing buffer, then keep draining anything that
        arrived while the send was on the wire. Runs with
        ``_send_inflight`` held; always releases it."""
        try:
            while True:
                with self._coal_cv:
                    self._flush_deadline = None
                    if self._shed_ops:
                        now = time.monotonic()
                        if (self._shed_deadline is not None
                                and now < self._shed_deadline):
                            # backoff still running: nothing may pass
                            # the held ops (clientSeq order); the
                            # flusher re-enters at the deadline
                            return
                        ops = self._shed_run()
                        if not ops:
                            self._shed_deadline = now + _SHED_HOLD_S
                            return
                        self._shed_deadline = (now + _SHED_HOLD_S
                                               if self._shed_ops else None)
                        self._pending_shed_wall = self._shed_park_wall
                        self._shed_park_wall = None
                        last = ops[-1].client_sequence_number
                        self._stragglers = {
                            c for c in self._unresolved.copy() if c > last}
                    elif self._pending_ops and self._held():
                        self._flush_deadline = (time.monotonic()
                                                + _SHED_HOLD_S)
                        self._ensure_flusher()
                        return
                    else:
                        ops, self._pending_ops = self._pending_ops, []
                    if not ops:
                        return
                    self._unresolved.update(
                        op.client_sequence_number for op in ops
                        if op.type != MessageType.NOOP)
                self._send_ops(ops)
        finally:
            with self._coal_cv:
                self._send_inflight = False
                self._coal_cv.notify_all()

    def _held(self) -> bool:
        """Whether new ops must wait for the last resubmit's stragglers.
        Called under ``_coal_cv``."""
        self._stragglers &= self._unresolved
        return bool(self._stragglers)

    def _shed_run(self) -> list:
        """Take the resubmit: the held ops, then the newer pending ones,
        as far as their clientSeqs run without a gap from the lane's
        first; nothing while an op sent before that first is
        unresolved. A resubmit the server admits must not skip an op
        whose shed nack is still on the way (the backoff can run out
        mid-nack-wave): deli would nack everything past the gap. Called
        under ``_coal_cv``."""
        lane, pending = self._shed_ops, self._pending_ops
        first = lane[0].client_sequence_number
        if min(self._unresolved, default=first) < first:
            return []
        run = []
        for op in itertools.chain(lane, pending):
            if op.client_sequence_number != first + len(run):
                break
            run.append(op)
        held = min(len(run), len(lane))
        self._shed_ops = lane[held:]
        self._pending_ops = pending[len(run) - held:]
        return run

    def _send_ops(self, ops: list) -> None:
        for i in range(0, len(ops), _MAX_BOXCAR_OPS):
            try:
                self._send_chunk(ops[i:i + _MAX_BOXCAR_OPS])
            except OSError:
                # the peer stopped reading long enough for the send to
                # fail (buffer-full timeout under a nack storm): the
                # drained batch must NOT vanish — requeue everything
                # unsent at the head of the shed lane and back off. If
                # the failure left a partial frame on the wire the
                # server's framed read breaks and drops the connection,
                # which runs the visible disconnect path; either way an
                # op is never lost silently.
                with self._coal_cv:
                    if not self._coal_closed:
                        for op in ops[i:]:
                            self._unresolved.discard(
                                op.client_sequence_number)
                            bisect.insort(
                                self._shed_ops, op,
                                key=lambda o: o.client_sequence_number)
                        if self._shed_park_wall is None:
                            self._shed_park_wall = time.time()
                        self._shed_deadline = max(
                            self._shed_deadline or 0.0,
                            time.monotonic() + 0.5)
                        self._ensure_flusher()
                        self._coal_cv.notify_all()
                raise

    def _send_chunk(self, chunk: list) -> None:
        shed_wall, self._pending_shed_wall = self._pending_shed_wall, None
        sample = False
        if self.trace_sample_n:
            self._trace_seq += 1
            # shed flushes are force-sampled: park time is exactly the
            # tail latency the hop breakdown exists to attribute
            sample = (self._trace_seq % self.trace_sample_n == 0
                      or shed_wall is not None)
        # columnar first: a canonical chanop boxcar rides the
        # fixed-stride column frame the server admits without
        # materializing per-op objects (kind stays "submit" so the
        # chaos net.send rules fault both frame families alike)
        columnar = False
        body = binwire.encode_submit_columns(chunk)
        if body is not None:
            columnar = True
            if sample:
                # hoptail append keeps the op columns untouched —
                # stamping traces on the op itself would kick the
                # boxcar off the columnar path entirely
                if shed_wall is not None:
                    body = binwire.append_hop(
                        body, HOP_SHED, shed_wall)
                body = binwire.append_hop(
                    body, HOP_SUBMIT, time.time())
                self.counters.inc("driver.trace.sampled")
        else:
            if sample:
                if shed_wall is not None:
                    chunk[-1].traces.append(TraceHop(
                        service="frontend", action="shed",
                        timestamp=shed_wall))
                chunk[-1].traces.append(TraceHop(
                    service="client", action="submit",
                    timestamp=time.time()))
                self.counters.inc("driver.trace.sampled")
            try:
                body = binwire.encode_submit(chunk)
            except Exception:
                # a boxcar binwire cannot pack (>u16 ops, int outside
                # the fixed-field range) still goes through: the
                # server accepts both frame kinds on any connection
                body = None
        with self._t.lock:
            if body is not None:
                self._t.send_body(body, kind="submit")
            else:
                self._t.send(
                    {"t": "submit",
                     "ops": [message_to_dict(m) for m in chunk]})
        self.counters.inc("driver.submit.frames")
        self.counters.inc("driver.submit.ops", len(chunk))
        if columnar:
            self.counters.inc("driver.submit.columnar")

    def submit_signal(self, content: Any, type: str = "signal") -> None:
        self._t.send({"t": "signal", "content": content, "type": type})

    def settle(self) -> None:
        """Let the reader thread handle every frame it has read: the
        delta manager's connect-time catch-up holds ``lock``, so a frame
        that arrived meanwhile (behind a gateway, the client's own join)
        waits on it (ROADMAP C14)."""
        self._t.settle(SETTLE_TIMEOUT_S)

    def _fire_disconnect(self, reason: str) -> None:
        """Exactly-once disconnect notification: close() and the reader
        thread's exit path both land here, and callers should not need to
        de-register handlers to avoid a double callback."""
        with self._t._pending_cv:
            if self._disc_fired:
                return
            self._disc_fired = True
        with self._coal_cv:
            # no ack or nack comes on a dropped connection: the shed
            # lane stops holding for them (the reconnect resubmits every
            # unacked op)
            self._unresolved.clear()
            self._stragglers.clear()
            self._coal_cv.notify_all()
        if self.on_disconnect:
            self.on_disconnect(reason)

    def close(self) -> None:
        # drain the coalescing window first: close must not drop submits
        # the caller already handed over
        with self._coal_cv:
            self._coal_closed = True
            deadline = time.monotonic() + 0.5
            while self._send_inflight and time.monotonic() < deadline:
                self._coal_cv.wait(0.05)
            # held shed ops flush too (ahead of the buffer — clientSeq
            # order holds even on the close path)
            pending = self._shed_ops + self._pending_ops
            self._shed_ops, self._pending_ops = [], []
            self._coal_cv.notify_all()
        if pending:
            try:
                self._send_ops(pending)
            except OSError:
                pass
        try:
            self._t.send({"t": "disconnect"})
        except OSError:
            pass
        self._t.close()
        self._fire_disconnect("client closed connection")


class NetworkDeltaStorage(DocumentDeltaStorage):
    """``cols`` is a late-bound flag (callable or bool): whether the
    server advertised the columnar backfill door on the delta-stream
    connect (it may connect after this object is built)."""

    def __init__(self, transport: _Transport, tenant_id: str,
                 document_id: str, token_provider=None, cols=False):
        self._t = transport
        self._tenant = tenant_id
        self._doc = document_id
        self._token_provider = token_provider
        self._cols = cols

    def get_deltas(self, from_seq: int, to_seq: int):
        token = (self._token_provider(self._tenant, self._doc)
                 if self._token_provider else None)
        cols = self._cols() if callable(self._cols) else self._cols
        if cols:
            # columnar door: blocks arrive as rid-tagged binary pushes
            # (already decoded into take_blocks by the reader thread); a
            # boundary block may overhang the range, so trim by seq here
            rid, reply = self._t.request_rid({
                "t": "get_deltas_cols", "tenant": self._tenant,
                "doc": self._doc, "from": from_seq, "to": to_seq,
                "token": token})
            msgs = [message_from_dict(d) for d in reply.get("msgs", [])]
            blocks = self._t.take_blocks(rid)
            if blocks:
                msgs.extend(m for m in blocks
                            if from_seq < m.sequence_number < to_seq)
                msgs.sort(key=lambda m: m.sequence_number)
            return msgs
        reply = self._t.request({
            "t": "get_deltas", "tenant": self._tenant, "doc": self._doc,
            "from": from_seq, "to": to_seq, "token": token})
        return [message_from_dict(d) for d in reply["msgs"]]


class NetworkStorage(DocumentStorage):
    """Snapshot storage RPCs, with an optional driver-side cache.

    With a :class:`~.snapshot_cache.SnapshotCache` attached (the
    odsp-driver lesson, odspCache.ts), a re-boot of an unchanged doc
    serves version+tree from the cache and issues ZERO storage round
    trips; the delta connection invalidates the entry when a newer
    summary commits (summaryAck on the live stream)."""

    def __init__(self, transport: _Transport, tenant_id: str,
                 document_id: str, token_provider=None, cache=None,
                 counters: Optional[Counters] = None):
        self._t = transport
        self._tenant = tenant_id
        self._doc = document_id
        self._token_provider = token_provider
        self._cache = cache
        self.counters = (counters if counters is not None
                         else tier_counters("driver"))
        self.rpcs = 0  # storage round trips issued (cache hits don't count)

    def _req(self, t: str, **kw) -> dict:
        self.rpcs += 1
        token = (self._token_provider(self._tenant, self._doc)
                 if self._token_provider else None)
        return self._t.request(
            {"t": t, "tenant": self._tenant, "doc": self._doc,
             "token": token, **kw})

    def get_versions(self, count: int = 1) -> list[dict]:
        if self._cache is not None and count == 1:
            entry = self._cache.get(self._tenant, self._doc)
            if entry is not None:
                return [dict(entry["version"])]
        return self._req("get_versions", count=count)["versions"]

    def get_snapshot_tree(self, version: Optional[dict] = None):
        if self._cache is not None:
            entry = self._cache.get(self._tenant, self._doc)
            if entry is not None and (
                    version is None
                    or version.get("id") == entry["version"].get("id")):
                return entry["tree"]
        if version is not None:
            # explicit (possibly historical) version: serve it through
            # the tree shim but never cache it — it must not demote a
            # newer cached head
            return self._req("get_tree", version=version)["tree"]
        epoch = (self._cache.epoch(self._tenant, self._doc)
                 if self._cache is not None else None)
        # snapshot fast path first: columnar chunks, content-addressed
        # client dedupe, zero server-side re-serialization
        head = tree = None
        try:
            head, tree = self._snapcols_boot()
        except (RuntimeError, ValueError, KeyError):
            # torn/missing chunk, decode failure, or a server predating
            # the RPC: fall back to the legacy whole-tree path, which
            # materializes from the same durable store
            self.counters.inc("boot.snapshot.fallback")
            head = tree = None
        if head is None and tree is None:
            versions = self._req("get_versions", count=1)["versions"]
            if not versions:
                return None
            head = versions[0]
            tree = self._req("get_tree", version=head)["tree"]
        if tree is not None and self._cache is not None:
            # epoch-guarded: if a summary ack invalidated mid-fetch,
            # this put is dropped rather than resurrecting stale state
            self._cache.put(self._tenant, self._doc, dict(head), tree,
                            epoch=epoch)
        return tree

    def _snapcols_boot(self):
        """Boot through the columnar door: one get_snapshot_cols RPC
        (advertising cached chunk hashes), FT_COLS_SNAP pushes for only
        the missing chunks, client-side np.frombuffer decode. Returns
        ``(version, tree)`` — ``(None, None)`` when the doc has no
        summary yet; raises when the head predates snapcols or a chunk
        arrives torn/missing (callers fall back to the tree shim)."""
        import hashlib

        from ..protocol import snapcols

        self.rpcs += 1
        token = (self._token_provider(self._tenant, self._doc)
                 if self._token_provider else None)
        have = (self._cache.chunk_hashes()
                if self._cache is not None else [])
        _, reply = self._t.request_rid({
            "t": "get_snapshot_cols", "tenant": self._tenant,
            "doc": self._doc, "token": token, "have": have})
        pushed = self._t.take_snap_chunks()
        if reply.get("version") is None:
            return None, None
        if reply.get("legacy"):
            raise ValueError("head summary predates snapcols")
        chunks = []
        fetched = cached = 0
        for h in reply["chunks"]:
            data = pushed.get(h)
            if data is not None:
                if hashlib.sha256(data).hexdigest() != h:
                    raise ValueError(f"torn snapshot chunk {h[:12]}")
                if self._cache is not None:
                    self._cache.put_chunk(h, data)
                fetched += 1
            else:
                data = (self._cache.get_chunk(h)
                        if self._cache is not None else None)
                if data is None:
                    raise ValueError(f"missing snapshot chunk {h[:12]}")
                cached += 1
            chunks.append(data)
        self.counters.inc("boot.chunks.fetched", fetched)
        self.counters.inc("boot.chunks.cached", cached)
        mergetree = snapcols.decode_snapshot_chunks(
            chunks, reply["min_seq"], reply["tree_seq"])
        tree = {
            "protocol": reply["protocol"],
            "runtime": {"dataStores": {reply["ds"]: {
                "pkg": reply["pkg"],
                "snapshot": {"channels": {reply["channel"]: {
                    "type": "shared-string",
                    "snapshot": {"mergetree": mergetree,
                                 "intervals": {}},
                }}},
            }}},
            "sequence_number": reply["seq"],
        }
        self.counters.inc("boot.snapshot.used")
        return {"id": reply["version"]}, tree

    def read_blob(self, blob_id: str) -> bytes:
        return bytes.fromhex(self._req("read_blob", id=blob_id)["hex"])

    def write_blob(self, content: bytes) -> str:
        return self._req("write_blob", hex=content.hex())["id"]

    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        from ..protocol.summary import (
            SummaryAttachment,
            SummaryBlob,
            SummaryHandle,
            SummaryTree,
            summary_to_wire,
        )

        if isinstance(summary, (SummaryTree, SummaryBlob, SummaryHandle,
                                SummaryAttachment)):
            summary = summary_to_wire(summary)
        return self._req("upload_summary", summary=summary, parent=parent)["id"]


class NetworkDocumentService(DocumentService):
    """One document's bindings over the network. The delta stream gets its
    own TCP connection (it carries the push traffic); delta/snapshot
    storage share a second, request-only connection — mirroring the
    reference's socket + REST split."""

    def __init__(self, host: str, port: int, tenant_id: str, document_id: str,
                 timeout: float = 30.0, token_provider=None,
                 binary: bool = True, cache=None,
                 counters: Optional[Counters] = None,
                 readonly: bool = False):
        self._host, self._port, self._timeout = host, port, timeout
        self._tenant = tenant_id
        self._doc = document_id
        self._token_provider = token_provider
        self._binary = binary
        self._cache = cache
        self._readonly = readonly
        self.counters = (counters if counters is not None
                         else tier_counters("driver"))
        self._rpc: Optional[_Transport] = None
        self._cols_backfill = False  # learned from the stream connect

    def _rpc_transport(self) -> _Transport:
        if self._rpc is None or self._rpc._closed:
            self._rpc = _Transport(self._host, self._port, self._timeout)
        return self._rpc

    def connect_to_delta_stream(self, details: Any = None) -> NetworkDeltaConnection:
        t = _Transport(self._host, self._port, self._timeout)
        token = (self._token_provider(self._tenant, self._doc)
                 if self._token_provider else None)
        conn = NetworkDeltaConnection(t, self._tenant, self._doc, details,
                                      token=token, binary=self._binary,
                                      cache=self._cache,
                                      counters=self.counters,
                                      readonly=self._readonly)
        self._cols_backfill = conn.cols_backfill
        return conn

    def connect_to_delta_storage(self) -> NetworkDeltaStorage:
        return NetworkDeltaStorage(self._rpc_transport(), self._tenant,
                                   self._doc, self._token_provider,
                                   cols=lambda: self._cols_backfill)

    def connect_to_storage(self) -> NetworkStorage:
        return NetworkStorage(self._rpc_transport(), self._tenant,
                              self._doc, self._token_provider,
                              cache=self._cache, counters=self.counters)

    def history(self):
        from .history import NetworkHistoryClient

        return NetworkHistoryClient(self)


class NetworkDocumentServiceFactory(DocumentServiceFactory):
    """``token_provider(tenant, doc) -> str`` supplies the signed JWT the
    front door validates when tenancy is enforced (ref:
    routerlicious-driver tokens.ts TokenProvider)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 token_provider=None, binary: bool = True,
                 snapshot_cache: bool = True,
                 counters: Optional[Counters] = None,
                 readonly: bool = False):
        from .snapshot_cache import SnapshotCache

        self._host, self._port, self._timeout = host, port, timeout
        self._token_provider = token_provider
        self._binary = binary
        self._readonly = readonly
        # one cache shared by every document of this factory (the
        # odspCache shape); reachable as factory.snapshot_cache for
        # stats/assertions
        self.snapshot_cache = SnapshotCache() if snapshot_cache else None
        # one Counters shared by every connection of this factory, so
        # bench/soak/tests can assert submit coalescing engaged; the
        # registry-vended instance also surfaces in the metrics scrape
        # under tier="driver"
        self.counters = (counters if counters is not None
                         else tier_counters("driver"))

    def create_document_service(
        self, tenant_id: str, document_id: str
    ) -> NetworkDocumentService:
        return NetworkDocumentService(
            self._host, self._port, tenant_id, document_id, self._timeout,
            token_provider=self._token_provider, binary=self._binary,
            cache=self.snapshot_cache, counters=self.counters,
            readonly=self._readonly)
