"""LocalServer: the complete service in one process.

JAX counterpart: ``fluidframework_tpu/service/local_server.py``; the
port's copy of the in-process constructor path (``LocalServer(...)`` →
``connect`` → ``submit``/``submit_array``), imports rebased to this
package. ``storage_dir`` puts blobs in the native chunk store
(``NativeBlobStore``) and the history plane's records in ``RefLog`` files
under it; ``storage_server`` routes all storage to a storage process
(``storage_server.py``) and advances the doc's named ref there on every
scribe ack; ``external_scribe`` leaves validation and acking to a scribe
stage process (``stage_runner.ScribeStage``). ``tenants`` validates
tokens riddler-style at connect; the sharded core's hooks (``seal``,
``revoke``, ``lease_fresh``, ``epoch_fence``, ``part_k``, lazy boot with
its rehydrator and ``scan_boot_pending``) are the JAX package's. So is
the history plane (``history``).

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
from ..utils.telemetry import SPANS, tracing
from .blob_store import DbBlobStore, NativeBlobStore
from .broadcaster import BroadcasterLambda, PubSub
from .core import InMemoryDb, summary_versions_collection
from .deli import RawBoxcar, RawMessage
from .local_log import LocalLog
from .local_orderer import LocalOrderer
from .scriptorium import LogTruncatedError

#: a submit's whole call: ordering, and the synchronous drain through
#: deli, the store, the broadcast and its subscribers; each boxcar takes
#: a request id here
SUBMIT_SPAN = SPANS.name_id("server.submit")


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

    #: the span its broadcast deliveries run under (PubSub)
    SPAN = "session"

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
        # unified config registry (SURVEY §5.6): explicit args still win
        self.config = config if config is not None else DEFAULT
        # tenant registry (riddler role); empty/None = open dev mode
        self.tenants = tenants
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
        # content-addressed blob store: native C++ chunk store when given
        # a directory (the gitrest/libgit2 role), else db-backed
        self.storage_dir = storage_dir
        if storage_dir is not None:
            self.blob_store = NativeBlobStore(storage_dir)
        else:
            self.blob_store = DbBlobStore(self.db)
        # storage as its own PROCESS (storage_server.py — the
        # gitrest+historian role): all storage reads/writes and the
        # scribe's ref updates route to it instead of this process's
        # blob store
        self._storage_conn = None
        if storage_server is not None:
            from .storage_client import StorageConnection

            self._storage_conn = StorageConnection(*storage_server)
        # doc history plane (commit/ref graph over snapshot generations):
        # constructed on first use — the summarizer's commit hook, the
        # history doors, and chunk GC all go through it
        self._history = None
        # summary-upload accounting (handle reuse), per server
        self.storage_stats = {"handles_reused": 0, "trees_written": 0,
                              "blobs_written": 0}
        # per-stage process composition (stage_runner.py): scribe runs in
        # its own OS process; uploads are announced to it via the hook
        self.external_scribe = external_scribe
        # fired as (tenant, doc, version_id, record) after a summary
        # upload lands in the versions collection
        self.on_version_uploaded = None
        self._orderers: dict[str, LocalOrderer] = {}
        self._auto_drain = auto_drain
        self._clock = clock
        self._client_timeout = client_timeout
        # ids must be unique across SERVER restarts too (a durable log
        # carries the old incarnation's ops, and clients classify local
        # vs remote by id), hence the random epoch component
        self._client_epoch = uuid.uuid4().hex[:6]
        self._client_counter = itertools.count(1)
        # sharded core: set when this partition's lease was lost — every
        # order path refuses, so a dispossessed server can never write
        # its (now someone else's) durable log again
        self._revoked = False
        # lease fencing (sharded core): a callable returning True while
        # this partition's lease was confirmed RECENTLY. Checked on
        # every order path: a process that stalled past the TTL (GC
        # pause, SIGSTOP) and wakes with buffered submits must refuse
        # them BEFORE its heartbeat loop discovers the takeover —
        # otherwise it interleaves appends into a log the new owner is
        # already writing (the classic two-writer corruption).
        self.lease_fresh = None
        # migration seal (placement_plane.MigrationEngine): submits are
        # refused while the partition's state ships to the new owner —
        # softer than revoke (reads/broadcasts still flow; the front end
        # bounces submits on the retryable shed lane instead of erroring)
        self._sealed = False
        # epoch fence (deli admission): a callable returning the CURRENT
        # table epoch when this server's claim epoch is stale, else None
        self.epoch_fence = None
        # which doc partition this server sequences (sharded cores only;
        # ShardHost._make_server stamps it) — the front end labels the
        # rebalancer's windowed heat series with it, and None means
        # single-pipeline: no heat accounting, nowhere to rebalance
        self.part_k = None
        # fleet cold start (service/rehydrate.py): lazy_boot makes every
        # first-route pipeline build O(snapshot+tail); the rehydrator —
        # when ShardHost arms one — parks excess first-routes during a
        # boot storm instead of letting them monopolize the loop
        self.lazy_boot = False
        self.rehydrator = None
        self._rehydrated_noted = False
        self._boot_inventory: set[str] = set()

    @property
    def history(self):
        """The doc history plane (service/history_plane.py): commit/ref
        graph, fork, point-in-time replay, integrate, chunk GC."""
        if self._history is None:
            from .history_plane import HistoryPlane

            self._history = HistoryPlane(self)
        return self._history

    def seal(self) -> None:
        """Migration fence point: refuse new submits (they bounce with a
        retryable redirect) while the checkpoint ships to the target."""
        self._sealed = True

    def unseal(self) -> None:
        self._sealed = False

    @property
    def sealed(self) -> bool:
        return self._sealed

    def doc_sequence_numbers(self) -> dict[str, int]:
        """Fence seqs per live doc (``tenant/doc`` → deli seq) — exact
        once sealed, since the ordering loop is single-threaded."""
        return {key: o.deli.sequence_number
                for key, o in self._orderers.items()}

    def revoke(self) -> None:
        """Partition lease lost (ShardHost.poll): stop sequencing NOW.
        The front end also tears down the partition's live sessions so
        clients reconnect to the takeover owner."""
        self._revoked = True

    def _check_revoked(self) -> None:
        if self._revoked or (self.lease_fresh is not None
                             and not self.lease_fresh()):
            raise RuntimeError("partition lease lost: reconnect")
        if self._sealed:
            raise RuntimeError("partition sealed for migration: reconnect")

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
        connection primed at the current sequence number. With a tenant
        registry configured, the token is validated riddler-style BEFORE
        any document state is touched (ref: alfred connect_document →
        tenantManager.verifyToken). A doc:read-only token gets a READ
        connection: it may watch the stream, but submits are nacked with
        InvalidScopeError (ref: readonly connections, tokens.ts scopes).

        ``readonly=True`` requests the fast reader session regardless of
        token scope: no join op is ordered, the clientId never enters
        the quorum, and the session costs the op path nothing — the
        audience tier for read-scale fan-out."""
        self._check_revoked()
        can_write = not readonly
        if self.tenants is not None:
            from .tenants import SCOPE_READ, SCOPE_WRITE

            claims = self.tenants.validate(token, tenant_id, document_id,
                                           required_scope=SCOPE_READ)
            can_write = can_write and SCOPE_WRITE in claims.get(
                "scopes", [])
        if (self.rehydrator is not None
                and f"{tenant_id}/{document_id}" not in self._orderers):
            # boot-storm admission: a first-route to a cold doc takes a
            # boot slot or parks (BootPending → retryable nack); routes
            # to already-warm docs never touch the bucket
            self.rehydrator.admit(tenant_id, document_id)
        orderer = self._get_orderer(tenant_id, document_id)
        client_id = f"client-{self._client_epoch}-{next(self._client_counter)}"
        conn = ServerConnection(self, tenant_id, document_id, client_id, details)
        conn.can_write = can_write
        conn.mode = "readonly" if readonly else (
            "write" if can_write else "read")

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
        # must not contribute to the msn — a reader cannot submit (its
        # ops scope-nack), so a joined reader would pin the collaboration
        # window forever (ref: read connections stay out of the quorum;
        # they exist only in the audience)
        self._maybe_drain()
        return conn

    def storage(self, tenant_id: str, document_id: str):
        """The doc's storage binding: the in-proc store, or the storage
        PROCESS when one is deployed. Every storage consumer (front-end
        RPCs, summarizer, drivers) goes through here."""
        if self._storage_conn is not None:
            from .storage_client import RemoteStorage

            def on_uploaded(vid, record, tenant=tenant_id,
                            doc=document_id):
                # mirror the version record into this process's db —
                # scribe validation reads it there — and announce it
                # (external scribe stages learn of uploads this way)
                self.db.upsert(summary_versions_collection(tenant, doc),
                               vid, dict(record))
                hook = self.on_version_uploaded
                if hook is not None:
                    hook(tenant, doc, vid, dict(record))
            return RemoteStorage(self._storage_conn, tenant_id,
                                 document_id, on_uploaded=on_uploaded)
        from ..driver.local import LocalStorage

        return LocalStorage(self, tenant_id, document_id)

    def commit_storage_ref(self, tenant_id: str, document_id: str,
                           handle: str) -> None:
        """Advance the doc's named head in the storage process after a
        scribe ack (no-op for in-proc storage, whose acked flag plays
        the ref role)."""
        if self._storage_conn is not None:
            self.storage(tenant_id, document_id).commit_ref(handle)

    def get_deltas(
        self, tenant_id: str, document_id: str, from_seq: int, to_seq: int
    ) -> list[SequencedDocumentMessage]:
        """REST backfill (alfred /deltas): ops with from_seq < seq < to_seq."""
        booted = f"{tenant_id}/{document_id}" not in self._orderers
        orderer = self._get_orderer(tenant_id, document_id)
        if booted:
            # a pipeline built by this read (a restarted core's first
            # touch of the doc) replays its log at the next drain: drain
            # now, or the range reads empty
            self._maybe_drain()
        try:
            return orderer.scriptorium.get_deltas(
                tenant_id, document_id, from_seq, to_seq)
        except LogTruncatedError as e:
            # report the snapshot-backed base so the joiner knows a
            # bootable summary covers the hole
            e.snapshot_seq = orderer.acked_boot_seq()
            raise

    def get_delta_blocks(
        self, tenant_id: str, document_id: str, from_seq: int, to_seq: int
    ):
        """Columnar backfill door: ``(payloads, msgs, head)`` covering
        from_seq < seq < to_seq, or None when the durable log has no
        segment stream for this doc (caller falls back to
        :meth:`get_deltas`). ``payloads`` are raw segment-block byte
        ranges (a boundary block may span past the range — the CLIENT
        trims by seq); ``msgs`` are legacy-record ops materialized
        through the compat shim. Enforces the same retention contract as
        the scalar door: reaching below the trim base raises
        :class:`~.scriptorium.LogTruncatedError` rather than silently
        serving a partial range."""
        blocks = getattr(self.log, "delta_blocks", None)
        if blocks is None:
            return None
        orderer = self._get_orderer(tenant_id, document_id)
        base = orderer.scriptorium.retained_base(tenant_id, document_id)
        if from_seq < base:
            raise LogTruncatedError(base,
                                    snapshot_seq=orderer.acked_boot_seq())
        res = blocks(f"deltas/{tenant_id}/{document_id}", from_seq, to_seq)
        if res is None:
            return None
        payloads, legacy = res
        head = orderer.scriptorium.head_seq(tenant_id, document_id)
        return payloads, legacy, head

    def drain(self) -> int:
        """Deliver all queued messages through the pipeline to quiescence."""
        return self.log.drain()

    def expire_idle_clients(self) -> None:
        for orderer in self._orderers.values():
            orderer.deli.check_idle_clients()
        self._maybe_drain()

    def checkpoint_all(self, part: Optional[tuple] = None) -> None:
        """Checkpoint every dirty pipeline; with ``part`` = ``(k, n)``
        only those whose doc key hashes to ``k`` of ``n`` (a core's
        ticker walks the ``n`` parts in turn, so no tick stalls its loop
        for every doc at once)."""
        for key, orderer in self._orderers.items():
            if part is None or hash(key) % part[1] == part[0]:
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

    def crash_orderer(self, tenant_id: str, document_id: str) -> None:
        """Simulate a kill -9 of the document's pipeline: tear down
        WITHOUT checkpointing and rebuild from the last durable
        checkpoint. Deli replays the raw log from its checkpointed
        offset and re-tickets the window with identical sequence
        numbers; downstream consumers dedupe by seq (the chaos soak's
        stage-crash fault). An injected crash is a flight-recorder
        trigger: the rings dump so the run carries the traffic that
        preceded the kill."""
        key = f"{tenant_id}/{document_id}"
        orderer = self._orderers.pop(key, None)
        if orderer is not None:
            orderer.close()
        recorder = get_recorder()
        recorder.event("deli", "orderer_crash", tenant=tenant_id,
                       doc=document_id)
        try:
            recorder.dump("orderer_crash", tenant=tenant_id,
                          doc=document_id)
        except OSError:
            pass  # a failed dump must not break the crash simulation
        self._get_orderer(tenant_id, document_id)

    # ------------------------------------------------------------- internal

    def _get_orderer(self, tenant_id: str, document_id: str) -> LocalOrderer:
        key = f"{tenant_id}/{document_id}"
        if key not in self._orderers:
            kw = {}
            if self._client_timeout is not None:
                kw["client_timeout"] = self._client_timeout
            retention = self.config.log_retention_ops
            on_persisted = None
            if self._storage_conn is not None:
                def on_persisted(handle, version, t=tenant_id,
                                 d=document_id):
                    self.commit_storage_ref(t, d, handle)
            self._orderers[key] = LocalOrderer(
                tenant_id, document_id, self.log, self.db, self.pubsub,
                clock=self._clock, logger=self.logger,
                log_retention_ops=retention if retention >= 0 else None,
                external_scribe=self.external_scribe,
                on_version_persisted=on_persisted,
                lazy_boot=self.lazy_boot,
                **kw)
            # epoch fence: deli consults the server's CURRENT fence on
            # every record (closure, so arming after boot still applies)
            self._orderers[key].deli.epoch_fence = (
                lambda: self.epoch_fence() if self.epoch_fence is not None
                else None)
            if (self._orderers[key].boot_mode == "lazy"
                    and not self._rehydrated_noted):
                self._rehydrated_noted = True
                from ..obs.journal import get_journal

                get_journal().emit("part.rehydrated", part=self.part_k,
                                   doc=key)
        return self._orderers[key]

    # ------------------------------------------------------- cold start

    def scan_boot_pending(self) -> int:
        """Cold-start inventory: docs present on this partition's log
        with no live pipeline yet. Listing is one directory scan (no
        record reads) — the lazy contract. Feeds ``admin placement
        boot`` progress."""
        topics = getattr(self.log, "list_topics", None)
        if topics is None:
            return 0
        self._boot_inventory = {
            t[len("rawops/"):] for t in topics("rawops/")}
        return len(self._boot_inventory)

    def boot_status(self) -> dict:
        """Rehydration progress for the operator door."""
        pending = sum(1 for k in self._boot_inventory
                      if k not in self._orderers)
        return {"part": self.part_k,
                "docs_booted": len(self._orderers),
                "docs_pending": pending}

    def _submit(self, conn: ServerConnection, messages: list[DocumentMessage]) -> None:
        span = SPANS.begin(SUBMIT_SPAN, request=True) if tracing() else None
        try:
            self._check_revoked()
            if not getattr(conn, "can_write", True):
                from ..protocol.messages import Nack, NackErrorType

                for op in messages:
                    self.pubsub.publish(
                        f"nack/{conn.tenant_id}/{conn.document_id}/"
                        f"{conn.client_id}",
                        Nack(operation=op, sequence_number=-1, code=403,
                             type=NackErrorType.INVALID_SCOPE,
                             message="token lacks doc:write scope"))
                return
            orderer = self._get_orderer(conn.tenant_id, conn.document_id)
            now = self._clock()
            self._flight.admission("boxcar", conn.document_id,
                                   conn.client_id, len(messages))
            # the whole submitted batch rides the raw log as ONE boxcar
            # record (ref: IBoxcarMessage); deli's fast lane tickets it in
            # one pass
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
        finally:
            if span is not None:
                SPANS.end(span)

    def _submit_array(self, conn: ServerConnection, boxcar) -> None:
        span = SPANS.begin(SUBMIT_SPAN, request=True) if tracing() else None
        try:
            self._check_revoked()
            if not getattr(conn, "can_write", True):
                from ..protocol.messages import Nack, NackErrorType

                self.pubsub.publish(
                    f"nack/{conn.tenant_id}/{conn.document_id}/"
                    f"{conn.client_id}",
                    Nack(operation=None, sequence_number=-1, code=403,
                         type=NackErrorType.INVALID_SCOPE,
                         message="token lacks doc:write scope"))
                return
            boxcar.tenant_id = conn.tenant_id
            boxcar.document_id = conn.document_id
            boxcar.client_id = conn.client_id
            boxcar.timestamp = self._clock()
            self._flight.admission("aboxcar", conn.document_id,
                                   conn.client_id, boxcar.n)
            orderer = self._get_orderer(conn.tenant_id, conn.document_id)
            orderer.order(boxcar)
            self._maybe_drain()
        finally:
            if span is not None:
                SPANS.end(span)

    def _signal(self, conn: ServerConnection, signal: Signal) -> None:
        self.pubsub.publish(
            f"signal/{conn.tenant_id}/{conn.document_id}", signal)

    def _disconnect(self, conn: ServerConnection) -> None:
        if self._revoked or not getattr(conn, "can_write", True):
            # revoked: the takeover owner expires the client instead
            # (idle timeout) — this process may not write the log.
            # read connections never joined: nothing to leave.
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
