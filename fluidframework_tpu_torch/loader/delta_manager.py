"""DeltaManager: the client op pump.

JAX counterpart: ``fluidframework_tpu/loader/delta_manager.py``; the port's copy,
imports rebased to this package. One repair (ROADMAP C2): work a caller's
thread does on the stream (submits, the connect-time catch-up, stepping
the inbound queue) holds the lock the connection's reader thread
dispatches under (``dispatch_guard``), and the runtime holds it around
record-then-send and the reconnect replay.

Ref: loader/container-loader/src/deltaManager.ts — inbound sequenced ops
with gap detection + reorder buffer and backfill fetch (:1188, :432, :647),
outbound submission with clientSeq assignment (:583), connect/reconnect
state machine (:444). Everything is synchronous and deterministic here;
async pacing (DeltaScheduler time-slicing) is a host-side concern the farm
build handles at the batch boundary instead.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional

from ..driver.definitions import DocumentService
from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    Nack,
    SequencedDocumentMessage,
    Signal,
)


class DeltaManager:
    """Pumps one document's op stream for one client.

    ``process_handler(msg)`` is called exactly once per sequenced message,
    in strict sequence order, regardless of delivery order or gaps.
    """

    def __init__(self, service: DocumentService):
        self._service = service
        self._delta_storage = service.connect_to_delta_storage()
        self.connection = None
        self._pending_connection = None  # opened, but our join not yet seen
        # True while the CLIENT chose to be offline (disconnect()); a
        # server-initiated drop leaves it False, which is what an
        # auto-reconnect policy keys on
        self.user_disconnected = False
        self.client_id: Optional[str] = None
        self.last_processed_seq = 0
        self.duplicates_received = 0
        # the handshake's seq: a live op at or below it also came in the
        # connect-time catch-up (an expected overlap, not a duplicate)
        self._backfill_to = 0
        self.minimum_sequence_number = 0
        self._client_seq = 0
        # the dispatch guard's lock for a connection that has none of
        # its own (the in-process driver)
        self._submit_lock = threading.RLock()
        self._reorder: dict[int, SequencedDocumentMessage] = {}
        self.process_handler: Optional[Callable[[SequencedDocumentMessage], None]] = None
        self.nack_handler: Optional[Callable[[Nack], None]] = None
        self.signal_handler: Optional[Callable[[Signal], None]] = None
        self.connection_handler: Optional[Callable[[bool, Optional[str]], None]] = None
        self._details: Any = None
        # DeltaScheduler role (deltaScheduler.ts:25): long catch-up drains
        # call this hook every `inbound_slice` messages so a host can
        # yield/paint/heartbeat between slices of a big backlog
        self.inbound_yield: Optional[Callable[[int], None]] = None
        self.inbound_slice = 256
        self._drained_since_yield = 0
        # noop heartbeat (ref: submit coalescing + noop heuristics,
        # deltaManager.ts:583): a watch-only client must still advance
        # its refSeq through the sequencer or it pins the document's msn
        # — and with it the collaboration window and the device zamboni
        # floor. After this many remote ops with no local submission, a
        # NOOP goes out. 0 disables.
        self.noop_frequency = 50
        self._remote_since_submit = 0
        # per-client inbound pause (the OpProcessingController role,
        # opProcessingController.ts:16): tests freeze ONE replica's
        # delivery to force specific interleavings, then step/resume
        self._paused = False
        self._pause_buffer: list[SequencedDocumentMessage] = []
        # log-truncation reanchor hook (the container wires this): the
        # backfill range reached below the server's retention base —
        # return True after re-booting from the latest summary (which
        # advances last_processed_seq past the hole) to retry the tail
        self.on_log_truncated: Optional[Callable[[Exception], bool]] = None
        # boot-shape telemetry shared with the driver tier when the
        # service exposes one (boot.backfill.* — was the catch-up bounded
        # by a snapshot, or a whole-log replay?)
        self.counters = getattr(service, "counters", None)
        self._first_catchup = True

    @property
    def connected(self) -> bool:
        return self.connection is not None

    # ------------------------------------------------------------ connect

    def connect(self, details: Any = None) -> str:
        """Open the live stream and backfill pre-subscription history.

        The connection only becomes ACTIVE (connection_handler fires, write
        path opens) once our own join is processed from the stream — by
        then every op of a previous incarnation has been sequenced and
        acked, so pending-op replay cannot duplicate in-flight ops (ref:
        container.ts treats a connection as pending until the join op
        round-trips; deli fences old-client ops behind the leave).
        """
        if self.connection is not None or self._pending_connection is not None:
            return self.client_id
        self.user_disconnected = False
        self._details = details if details is not None else self._details
        conn = self._service.connect_to_delta_stream(self._details)
        self._pending_connection = conn
        try:
            conn.on_nack = self._on_nack
            conn.on_signal = self._on_signal
            conn.on_disconnect = lambda reason: self._on_disconnect(reason)
            # classify the boot shape BEFORE the op handler goes live:
            # assigning on_op flushes buffered events (our own join can
            # already be sitting there), and a buffered op with a gap
            # runs the whole gap repair inline — which advances
            # last_processed_seq and would mislabel a whole-log replay
            # as snapshot-bounded
            if self._first_catchup and self.counters is not None \
                    and conn.initial_sequence_number > 0:
                self._first_catchup = False
                self.counters.inc(
                    "boot.backfill.bounded" if self.last_processed_seq > 0
                    else "boot.backfill.full")
            with self.dispatch_guard():
                self._backfill_to = conn.initial_sequence_number
                conn.on_op = self._enqueue  # flushes buffered events
                # repair any gap between our head and the pre-
                # subscription history; everything from the handshake on
                # arrives live (incl. our join)
                self._fetch_missing(upto=conn.initial_sequence_number)
        except BaseException:
            # a half-opened connection must not wedge future connects: a
            # still-pending _pending_connection makes connect() an early-
            # return no-op, which an auto-reconnect loop would read as
            # success and stop retrying
            if self._pending_connection is conn:
                self._pending_connection = None
            conn.on_disconnect = None
            try:
                conn.close()
            except Exception:
                pass
            raise
        if getattr(conn, "mode", "write") in ("read", "readonly"):
            # read/readonly connections never join the quorum, so there
            # is no join round-trip to wait for: they go active
            # immediately (and the write path below refuses their
            # submissions)
            if self._pending_connection is conn:
                self._activate_connection()
        return conn.client_id

    def _activate_connection(self) -> None:
        conn, self._pending_connection = self._pending_connection, None
        self.connection = conn
        self.client_id = conn.client_id
        self._client_seq = 0
        if self.connection_handler:
            self.connection_handler(True, self.client_id)

    @property
    def pending_connection(self):
        """The opened-but-not-yet-active connection (join in flight)."""
        return self._pending_connection

    def abort_pending(self) -> None:
        """Drop a pending connection WITHOUT marking a user disconnect —
        the auto-reconnect loop's cleanup when a join never lands."""
        conn, self._pending_connection = self._pending_connection, None
        if conn is not None:
            conn.on_disconnect = None
            try:
                conn.close()
            except Exception:
                pass

    def disconnect(self, reason: str = "client disconnect") -> None:
        self.user_disconnected = True
        conn = self.connection or self._pending_connection
        if conn is None:
            return
        was_active = self.connection is not None
        self.connection = self._pending_connection = None
        self.client_id = None
        conn.on_disconnect = None  # avoid re-entrant notification
        conn.close()
        if was_active and self.connection_handler:
            self.connection_handler(False, None)

    def reconnect(self, reason: str = "reconnect") -> str:
        self.disconnect(reason)
        return self.connect()

    def _on_disconnect(self, reason: str) -> None:
        # server-initiated drop: notify; the container decides when to
        # reconnect (auto-reconnect policy lives above, container.ts:294)
        was_active = self.connection is not None
        self.connection = self._pending_connection = None
        self.client_id = None
        if was_active and self.connection_handler:
            self.connection_handler(False, None)

    # ------------------------------------------------------------- submit

    def submit(
        self,
        type: MessageType,
        contents: Any,
        metadata: Optional[dict] = None,
    ) -> int:
        """Send one message on the live connection; returns clientSeq."""
        with self.dispatch_guard():
            return self._submit_locked(type, contents, metadata)

    @contextlib.contextmanager
    def dispatch_guard(self):
        """Hold the lock under which the connection dispatches inbound
        events: the socket driver's reader thread holds its ``lock``
        while it delivers ops, so the inbound drain, the activation
        replay and the refSeq heartbeat run under it (ROADMAP C2). A
        submit from another thread that holds it too cannot land between
        two replayed ops, and clientSeqs reach the connection in the
        order they were given; a catch-up on another thread cannot drain
        beside the reader thread's. Re-entrant; re-taken if the
        connection changed while waiting."""
        while True:
            conn = self._pending_connection or self.connection
            lock = getattr(conn, "lock", None) or self._submit_lock
            with lock:
                if (self._pending_connection or self.connection) is conn:
                    yield
                    return

    def _submit_locked(self, type: MessageType, contents: Any,
                       metadata: Optional[dict]) -> int:
        if self.connection is None:
            raise RuntimeError("cannot submit while disconnected")
        mode = getattr(self.connection, "mode", "write")
        if mode == "readonly":
            raise PermissionError(
                "readonly session: opened with readonly=True, no quorum "
                "membership to write from")
        if mode == "read":
            raise PermissionError(
                "read connection: this client's token lacks doc:write")
        self._remote_since_submit = 0
        self._client_seq += 1
        self.connection.submit(
            [
                DocumentMessage(
                    client_sequence_number=self._client_seq,
                    reference_sequence_number=self.last_processed_seq,
                    type=type,
                    contents=contents,
                    metadata=metadata,
                )
            ]
        )
        return self._client_seq

    def submit_batch(self, type: MessageType,
                     contents_list: list) -> list[int]:
        """Send a flushed batch as ONE submission: consecutive clientSeqs,
        one shared refSeq, first/last marked with batch metadata (ref:
        outbound DeltaQueue batch flush, deltaManager.ts:583 + the
        batchBegin/batchEnd metadata convention). The whole batch rides
        the raw log as one boxcar, so it is sequenced contiguously."""
        with self.dispatch_guard():
            return self._submit_batch_locked(type, contents_list)

    def _submit_batch_locked(self, type: MessageType,
                             contents_list: list) -> list[int]:
        if self.connection is None:
            raise RuntimeError("cannot submit while disconnected")
        msgs = []
        seqs = []
        ref = self.last_processed_seq
        n = len(contents_list)
        for i, contents in enumerate(contents_list):
            self._client_seq += 1
            seqs.append(self._client_seq)
            metadata = None
            if n > 1:
                if i == 0:
                    metadata = {"batch": True}
                elif i == n - 1:
                    metadata = {"batch": False}
            msgs.append(DocumentMessage(
                client_sequence_number=self._client_seq,
                reference_sequence_number=ref,
                type=type,
                contents=contents,
                metadata=metadata,
            ))
        self.connection.submit(msgs)
        return seqs

    def submit_signal(self, content: Any, type: str = "signal") -> None:
        if self.connection is None:
            raise RuntimeError("cannot signal while disconnected")
        self.connection.submit_signal(content, type)

    # ------------------------------------------------------------ inbound

    def pause_inbound(self) -> None:
        """Freeze delivery to THIS replica; arriving ops buffer."""
        self._paused = True

    def resume_inbound(self) -> None:
        """Deliver everything buffered, in order, then go live again."""
        with self.dispatch_guard():
            self._paused = False
            pending, self._pause_buffer = self._pause_buffer, []
            for msg in pending:
                self._enqueue(msg)

    def step_inbound(self, count: int = 1) -> int:
        """Deliver up to ``count`` buffered messages while staying paused
        (the process/processIncoming stepping surface). Returns how many
        were delivered.

        Steps in SEQUENCE order, not arrival order: stepping an
        out-of-order arrival would trigger gap repair that pulls ops
        still sitting in the pause buffer from delta storage — delivering
        more than ``count`` and leaving silent duplicates behind."""
        with self.dispatch_guard():
            return self._step_inbound(count)

    def _step_inbound(self, count: int) -> int:
        delivered = 0
        while delivered < count and self._pause_buffer:
            msg = min(self._pause_buffer, key=lambda m: m.sequence_number)
            self._pause_buffer.remove(msg)
            self._paused = False
            try:
                self._enqueue(msg)
            finally:
                self._paused = True
            delivered += 1
        return delivered

    def _enqueue(self, msg: SequencedDocumentMessage) -> None:
        """Strict-order delivery with reorder buffer + gap repair
        (ref: processInboundMessage deltaManager.ts:1188)."""
        if self._paused:
            self._pause_buffer.append(msg)
            return
        if msg.sequence_number <= self.last_processed_seq:
            # dedupe is correctness (reconnect backfill overlap), but a
            # STEADY duplicate stream is a delivery bug upstream (e.g.
            # the gateway double-upstream race) that dedupe would mask —
            # count it so tests and telemetry can see it. The reader
            # thread waits out the catch-up (dispatch_guard), so a live
            # op inside the handshake's range arrives after it: overlap
            if msg.sequence_number > self._backfill_to:
                self.duplicates_received += 1
            return
        self._reorder[msg.sequence_number] = msg
        self._drain_reorder()
        if self._reorder:
            # a gap remains: repair from delta storage
            self._fetch_missing(upto=min(self._reorder))
            self._drain_reorder()
        self._maybe_heartbeat()

    def _maybe_heartbeat(self) -> None:
        """Send the refSeq-advancing NOOP when we have only been
        watching (outside the drain loop: submitting mid-drain would
        re-enter processing on a synchronous service)."""
        if (
            self.noop_frequency
            and self.connection is not None
            and getattr(self.connection, "mode", "write") == "write"
            and self._remote_since_submit >= self.noop_frequency
        ):
            self._remote_since_submit = 0
            self.submit(MessageType.NOOP, None)

    def _drain_reorder(self) -> None:
        while self.last_processed_seq + 1 in self._reorder:
            msg = self._reorder.pop(self.last_processed_seq + 1)
            self.last_processed_seq = msg.sequence_number
            self.minimum_sequence_number = msg.minimum_sequence_number
            if (
                msg.client_id is not None
                and msg.client_id != self.client_id
                and msg.type is not MessageType.NOOP
            ):
                # only CONTENT traffic triggers heartbeats: counting other
                # clients' noops would make the heartbeats self-sustaining
                # once the client count passes noop_frequency (a storm)
                self._remote_since_submit += 1
            if self.process_handler:
                self.process_handler(msg)
            if self.inbound_yield is not None:
                self._drained_since_yield += 1
                if self._drained_since_yield >= self.inbound_slice:
                    self._drained_since_yield = 0
                    self.inbound_yield(self.last_processed_seq)
            if (
                self._pending_connection is not None
                and msg.type == MessageType.CLIENT_JOIN
                and (msg.contents or {}).get("clientId")
                == self._pending_connection.client_id
            ):
                # our join round-tripped: the connection goes active AFTER
                # the quorum learned about us and every earlier op (incl.
                # a previous incarnation's in-flight ops) was processed
                self._activate_connection()

    def advance_to(self, seq: int) -> int:
        """Pull and process every sequenced message up to ``seq`` from
        delta storage WITHOUT a live connection — the replay-driver pump
        (ref: replay-driver ReplayController stepping the inbound queue).
        Returns the new last_processed_seq."""
        with self.dispatch_guard():
            self._fetch_missing(upto=seq)
            return self.last_processed_seq

    def _fetch_missing(self, upto: int) -> None:
        """Backfill (last_processed, upto] from delta storage.

        A ``log_truncated`` refusal (our head is below the server's
        retention base — duck-typed on ``.base`` so both the local and
        network drivers' exception classes match) runs the reanchor hook
        once: the container re-boots from the latest summary, advancing
        ``last_processed_seq`` past the hole, and the (now bounded) tail
        fetch retries. No hook, or a hook that cannot reanchor, and the
        error propagates — it is not silently a partial catch-up."""
        if upto <= self.last_processed_seq:
            return
        try:
            msgs = self._delta_storage.get_deltas(
                self.last_processed_seq, upto + 1)
        except RuntimeError as e:
            if getattr(e, "base", None) is None \
                    or self.on_log_truncated is None \
                    or not self.on_log_truncated(e):
                raise
            if upto <= self.last_processed_seq:
                return
            msgs = self._delta_storage.get_deltas(
                self.last_processed_seq, upto + 1)
        for msg in msgs:
            self._reorder.setdefault(msg.sequence_number, msg)
        self._drain_reorder()

    def _on_nack(self, nack: Nack) -> None:
        if self.nack_handler:
            self.nack_handler(nack)

    def _on_signal(self, signal: Signal) -> None:
        if self.signal_handler:
            self.signal_handler(signal)
