"""LocalServer: the complete service in one process.

JAX counterpart: ``fluidframework_tpu/service/local_server.py``; the
port's copy of the in-process constructor path (``LocalServer(...)`` →
``connect`` → ``submit``/``submit_array``), imports rebased to this
package. Options that the port does not carry yet raise
``NotImplementedError`` naming ROADMAP A4: ``storage_dir`` and
``storage_server`` (native chunk store, storage process; ``storage``
serves the in-process ``driver/local.LocalStorage`` only), ``tenants``
(token validation), ``external_scribe``, the history plane, lazy boot
with its rehydrator, and the placement epoch fence. The placement plane's
seal, revoke and lease hooks come with the sharded core.

Ref: local-server/src/localDeltaConnectionServer.ts:59-118 (the test
backbone) and server/tinylicious (the single-process deployment). The
connection handshake mirrors alfred's ``connect_document``
(lambdas/src/alfred/index.ts:112-310): assign a client id, sequence a join
op, hand back the current sequence state; ``submit_op`` orders client
messages; disconnect sequences a leave. Signals are relayed un-sequenced
(:405).

``auto_drain=True`` delivers everything synchronously (the easy mode);
``auto_drain=False`` + explicit ``drain()``/``step()`` gives tests
deterministic control over interleaving — the OpProcessingController role.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Any, Callable, Optional

from ..config import DEFAULT
from ..obs import get_recorder
from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedDocumentMessage,
    Signal,
)
from ..utils import TelemetryLogger
from .blob_store import DbBlobStore
from .broadcaster import BroadcasterLambda, PubSub
from .core import InMemoryDb
from .deli import RawBoxcar, RawMessage
from .local_log import LocalLog
from .local_orderer import LocalOrderer
from .scriptorium import LogTruncatedError


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"LocalServer {what} is not ported to fluidframework_tpu_torch yet "
        "(ROADMAP A4)")


class ServerConnection:
    """One client's live connection (the socket analog).

    Callbacks: ``on_op(SequencedDocumentMessage)`` per message, or
    ``on_ops(list[SequencedDocumentMessage])`` per broadcast batch (set
    one; ``on_ops`` wins when both are set — high-rate consumers want the
    batch form), plus ``on_nack(Nack)`` and ``on_signal(Signal)``. Events
    arriving before a callback is attached are buffered and flushed on
    attach, so nothing delivered between the handshake and handler
    registration is lost.
    """

    def __init__(self, server: "LocalServer", tenant_id: str, document_id: str,
                 client_id: str, details: Any):
        self.server = server
        self.tenant_id = tenant_id
        self.document_id = document_id
        self.client_id = client_id
        self.details = details
        self._handlers: dict[str, Optional[Callable]] = {
            "op": None, "ops": None, "abatch": None, "nack": None,
            "signal": None}
        # op events buffer as batches; nack/signal as single events
        self._buffers: dict[str, list] = {"op": [], "nack": [], "signal": []}
        self.connected = True
        # sequence state at connect time (ref: IConnected payload)
        self.initial_sequence_number = 0

    def _deliver(self, kind: str, event) -> None:
        cb = self._handlers[kind]
        if cb is None:
            self._buffers[kind].append(event)
        else:
            cb(event)

    def _deliver_ops(self, batch) -> None:
        if type(batch) is not list:  # array lane: SequencedArrayBatch
            cb = self._handlers["abatch"]
            if cb is not None:  # array-aware consumer: no materialization
                cb(batch)
                return
            batch = batch.messages()  # legacy consumer: cold materialize
        cb = self._handlers["ops"]
        if cb is not None:
            cb(batch)
            return
        cb = self._handlers["op"]
        if cb is None:
            self._buffers["op"].append(batch)
        else:
            for msg in batch:
                cb(msg)

    def _set_handler(self, kind: str, cb: Optional[Callable]) -> None:
        self._handlers[kind] = cb
        if cb is None:
            return
        if kind in ("op", "ops", "abatch"):
            # op events (message lists AND array batches) share one
            # buffer; re-dispatch through _deliver_ops so each entry
            # reaches the best now-attached handler
            pending, self._buffers["op"] = self._buffers["op"], []
            for batch in pending:
                self._deliver_ops(batch)
        else:
            pending, self._buffers[kind] = self._buffers[kind], []
            for event in pending:
                cb(event)

    on_op = property(
        lambda self: self._handlers["op"],
        lambda self, cb: self._set_handler("op", cb))
    on_ops = property(
        lambda self: self._handlers["ops"],
        lambda self, cb: self._set_handler("ops", cb))
    # array-aware consumers get the SequencedArrayBatch raw (the array
    # lane); others transparently receive materialized messages
    on_abatch = property(
        lambda self: self._handlers["abatch"],
        lambda self, cb: self._set_handler("abatch", cb))
    on_nack = property(
        lambda self: self._handlers["nack"],
        lambda self, cb: self._set_handler("nack", cb))
    on_signal = property(
        lambda self: self._handlers["signal"],
        lambda self, cb: self._set_handler("signal", cb))

    def submit(self, messages: list[DocumentMessage]) -> None:
        if not self.connected:
            raise RuntimeError("connection closed")
        self.server._submit(self, messages)

    def submit_array(self, boxcar) -> None:
        """Submit an ArrayBoxcar (service/array_batch.py) — the SoA
        boxcar deli tickets without building per-op objects."""
        if not self.connected:
            raise RuntimeError("connection closed")
        self.server._submit_array(self, boxcar)

    def submit_signal(self, content: Any, type: str = "signal") -> None:
        if not self.connected:
            raise RuntimeError("connection closed")
        self.server._signal(self, Signal(client_id=self.client_id, type=type,
                                         content=content))

    def disconnect(self) -> None:
        if self.connected:
            self.connected = False
            self.server._disconnect(self)


class LocalServer:
    def __init__(
        self,
        auto_drain: bool = True,
        clock: Callable[[], float] = time.time,
        client_timeout: Optional[float] = None,
        log=None,
        storage_dir: Optional[str] = None,
        logger=None,
        config=None,
        tenants=None,
        external_scribe: bool = False,
        storage_server=None,
    ):
        for name, value in (("storage_dir", storage_dir),
                            ("tenants", tenants),
                            ("external_scribe", external_scribe),
                            ("storage_server", storage_server)):
            if value:
                raise _not_ported(f"option {name}")
        # unified config registry (SURVEY §5.6): explicit args still win
        self.config = config if config is not None else DEFAULT
        if client_timeout is None:
            client_timeout = self.config.client_timeout_s
        # sink-less by default: zero cost until a host injects a sink
        self.logger = logger if logger is not None else TelemetryLogger("service")
        # always-on flight-recorder rings (obs/flight.py): per-boxcar
        # admission events land here so a crash dump carries the traffic
        # that preceded it
        self._flight = get_recorder()
        # any object with the LocalLog surface works
        self.log = log if log is not None else LocalLog()
        self.db = InMemoryDb()
        self.pubsub = PubSub()
        # content-addressed blob store, db-backed
        self.blob_store = DbBlobStore(self.db)
        # summary-upload accounting (handle reuse), per server
        self.storage_stats = {"handles_reused": 0, "trees_written": 0,
                              "blobs_written": 0}
        self._orderers: dict[str, LocalOrderer] = {}
        self._auto_drain = auto_drain
        self._clock = clock
        self._client_timeout = client_timeout
        # ids must be unique across SERVER restarts too (a durable log
        # carries the old incarnation's ops, and clients classify local
        # vs remote by id), hence the random epoch component
        self._client_epoch = uuid.uuid4().hex[:6]
        self._client_counter = itertools.count(1)

    # ------------------------------------------- options not ported yet

    @property
    def history(self):
        raise _not_ported("history plane")

    @property
    def epoch_fence(self):
        return None

    @epoch_fence.setter
    def epoch_fence(self, fence) -> None:
        if fence is not None:
            raise _not_ported("placement epoch fence")

    @property
    def lazy_boot(self) -> bool:
        return False

    @lazy_boot.setter
    def lazy_boot(self, on: bool) -> None:
        if on:
            raise _not_ported("lazy boot")

    @property
    def rehydrator(self):
        return None

    @rehydrator.setter
    def rehydrator(self, rehydrator) -> None:
        if rehydrator is not None:
            raise _not_ported("lazy-boot rehydrator")

    # ------------------------------------------------------------------ api

    def connect(
        self,
        tenant_id: str,
        document_id: str,
        details: Any = None,
        can_evict: bool = True,
        token: Optional[str] = None,
        readonly: bool = False,
    ) -> ServerConnection:
        """The connect_document handshake: join the quorum, get a live
        connection primed at the current sequence number.

        ``readonly=True`` requests the fast reader session: no join op
        is ordered, the clientId never enters the quorum, and the
        session costs the op path nothing. ``token`` is accepted and
        ignored: the port runs in open dev mode (no tenant registry)."""
        can_write = not readonly
        orderer = self._get_orderer(tenant_id, document_id)
        client_id = f"client-{self._client_epoch}-{next(self._client_counter)}"
        conn = ServerConnection(self, tenant_id, document_id, client_id, details)
        conn.can_write = can_write
        conn.mode = "readonly" if readonly else "write"

        topic = BroadcasterLambda.topic(tenant_id, document_id)
        conn._op_cb = conn._deliver_ops  # op topics carry batches
        conn._nack_cb = lambda nack: conn._deliver("nack", nack)
        conn._sig_cb = lambda sig: conn._deliver("signal", sig)
        self.pubsub.subscribe(topic, conn._op_cb)
        self.pubsub.subscribe(
            f"nack/{tenant_id}/{document_id}/{client_id}", conn._nack_cb)
        self.pubsub.subscribe(f"signal/{tenant_id}/{document_id}", conn._sig_cb)

        conn.initial_sequence_number = orderer.deli.sequence_number
        if can_write:
            orderer.order(
                RawMessage(
                    tenant_id=tenant_id,
                    document_id=document_id,
                    client_id=None,
                    operation=DocumentMessage(
                        client_sequence_number=-1,
                        reference_sequence_number=-1,
                        type=MessageType.CLIENT_JOIN,
                        contents={
                            "clientId": client_id,
                            "detail": details,
                            "canEvict": can_evict,
                        },
                    ),
                    timestamp=self._clock(),
                )
            )
        # read connections NEVER join: they are not quorum members and
        # must not contribute to the msn
        self._maybe_drain()
        return conn

    def storage(self, tenant_id: str, document_id: str):
        """The doc's storage binding, the in-process store. Every storage
        consumer (summarizer, drivers) goes through here."""
        from ..driver.local import LocalStorage

        return LocalStorage(self, tenant_id, document_id)

    def get_deltas(
        self, tenant_id: str, document_id: str, from_seq: int, to_seq: int
    ) -> list[SequencedDocumentMessage]:
        """REST backfill (alfred /deltas): ops with from_seq < seq < to_seq."""
        orderer = self._get_orderer(tenant_id, document_id)
        try:
            return orderer.scriptorium.get_deltas(
                tenant_id, document_id, from_seq, to_seq)
        except LogTruncatedError as e:
            # report the snapshot-backed base so the joiner knows a
            # bootable summary covers the hole
            e.snapshot_seq = orderer.acked_boot_seq()
            raise

    def drain(self) -> int:
        """Deliver all queued messages through the pipeline to quiescence."""
        return self.log.drain()

    def expire_idle_clients(self) -> None:
        for orderer in self._orderers.values():
            orderer.deli.check_idle_clients()
        self._maybe_drain()

    def checkpoint_all(self) -> None:
        for orderer in self._orderers.values():
            orderer.checkpoint()

    def restart_orderer(self, tenant_id: str, document_id: str) -> None:
        """Simulate a partition restart: tear down the document's pipeline
        and rebuild it from the db checkpoint (ref: KafkaRunner partition
        restart, kafka-service/partition.ts)."""
        key = f"{tenant_id}/{document_id}"
        orderer = self._orderers.pop(key, None)
        if orderer is not None:
            orderer.checkpoint()
            orderer.close()
        self._get_orderer(tenant_id, document_id)

    # ------------------------------------------------------------- internal

    def _get_orderer(self, tenant_id: str, document_id: str) -> LocalOrderer:
        key = f"{tenant_id}/{document_id}"
        if key not in self._orderers:
            kw = {}
            if self._client_timeout is not None:
                kw["client_timeout"] = self._client_timeout
            retention = self.config.log_retention_ops
            self._orderers[key] = LocalOrderer(
                tenant_id, document_id, self.log, self.db, self.pubsub,
                clock=self._clock, logger=self.logger,
                log_retention_ops=retention if retention >= 0 else None,
                **kw)
        return self._orderers[key]

    def _submit(self, conn: ServerConnection, messages: list[DocumentMessage]) -> None:
        if not conn.can_write:
            for op in messages:
                self.pubsub.publish(
                    f"nack/{conn.tenant_id}/{conn.document_id}/"
                    f"{conn.client_id}",
                    Nack(operation=op, sequence_number=-1, code=403,
                         type=NackErrorType.INVALID_SCOPE,
                         message="read-only session cannot submit"))
            return
        orderer = self._get_orderer(conn.tenant_id, conn.document_id)
        now = self._clock()
        self._flight.event("deli", "boxcar", doc=conn.document_id,
                           client=conn.client_id, n=len(messages))
        # the whole submitted batch rides the raw log as ONE boxcar record
        # (ref: IBoxcarMessage); deli's fast lane tickets it in one pass
        orderer.order(
            RawBoxcar(
                tenant_id=conn.tenant_id,
                document_id=conn.document_id,
                client_id=conn.client_id,
                ops=messages,
                timestamp=now,
            )
        )
        self._maybe_drain()

    def _submit_array(self, conn: ServerConnection, boxcar) -> None:
        if not conn.can_write:
            self.pubsub.publish(
                f"nack/{conn.tenant_id}/{conn.document_id}/"
                f"{conn.client_id}",
                Nack(operation=None, sequence_number=-1, code=403,
                     type=NackErrorType.INVALID_SCOPE,
                     message="read-only session cannot submit"))
            return
        boxcar.tenant_id = conn.tenant_id
        boxcar.document_id = conn.document_id
        boxcar.client_id = conn.client_id
        boxcar.timestamp = self._clock()
        self._flight.event("deli", "aboxcar", doc=conn.document_id,
                           client=conn.client_id, n=boxcar.n)
        orderer = self._get_orderer(conn.tenant_id, conn.document_id)
        orderer.order(boxcar)
        self._maybe_drain()

    def _signal(self, conn: ServerConnection, signal: Signal) -> None:
        self.pubsub.publish(
            f"signal/{conn.tenant_id}/{conn.document_id}", signal)

    def _disconnect(self, conn: ServerConnection) -> None:
        if not conn.can_write:
            # read connections never joined: nothing to leave
            self._unsubscribe_conn(conn)
            return
        orderer = self._get_orderer(conn.tenant_id, conn.document_id)
        orderer.order(
            RawMessage(
                tenant_id=conn.tenant_id,
                document_id=conn.document_id,
                client_id=None,
                operation=DocumentMessage(
                    client_sequence_number=-1,
                    reference_sequence_number=-1,
                    type=MessageType.CLIENT_LEAVE,
                    contents={"clientId": conn.client_id},
                ),
                timestamp=self._clock(),
            )
        )
        self._unsubscribe_conn(conn)
        self._maybe_drain()

    def _unsubscribe_conn(self, conn: ServerConnection) -> None:
        topic = BroadcasterLambda.topic(conn.tenant_id, conn.document_id)
        self.pubsub.unsubscribe(topic, conn._op_cb)
        self.pubsub.unsubscribe(
            f"nack/{conn.tenant_id}/{conn.document_id}/{conn.client_id}",
            conn._nack_cb)
        self.pubsub.unsubscribe(
            f"signal/{conn.tenant_id}/{conn.document_id}", conn._sig_cb)

    def _maybe_drain(self) -> None:
        if self._auto_drain:
            self.log.drain()
