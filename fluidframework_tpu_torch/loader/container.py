"""Container: one client's live replica of one document.

JAX counterpart: ``fluidframework_tpu/loader/container.py``; the port's
copy, imports rebased to this package.

Ref: loader/container-loader/src/container.ts — boot (:931): fetch latest
summary version → load protocol state (:1116, the client-side quorum
replica via ProtocolOpHandler) → instantiate runtime (:1547) → attach the
delta stream and catch up. Afterwards every sequenced message flows
protocol-first, then into the runtime (§3.3).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..driver.definitions import DocumentService, DocumentServiceFactory
from ..protocol.consensus import SequencedClient
from ..protocol.messages import (
    MessageType,
    Nack,
    SequencedDocumentMessage,
    Signal,
)
from ..protocol.quorum import ProtocolOpHandler
from ..runtime.container_runtime import ContainerRuntime
from .delta_manager import DeltaManager


class Container:
    def __init__(
        self,
        service: DocumentService,
        runtime_factory: Optional[Callable[["Container"], ContainerRuntime]] = None,
        code_loader=None,
        auto_reconnect: bool = False,
    ):
        # auto_reconnect: re-dial after a SERVER-initiated drop with
        # backoff (ref: the deltaManager.ts:294,444 reconnect state
        # machine, where it is the default). Opt-in here; the sharded
        # core's failover path relies on it (a doc's partition moving to
        # a takeover core drops the session mid-stream).
        self.auto_reconnect = auto_reconnect
        self._service = service
        self._code_loader = code_loader
        self.storage = service.connect_to_storage()
        self.delta_manager = DeltaManager(service)
        self.delta_manager.process_handler = self._process
        self.delta_manager.connection_handler = self._on_connection_change
        self.delta_manager.nack_handler = self._on_nack
        self.delta_manager.signal_handler = self._on_signal
        self.delta_manager.on_log_truncated = self._reanchor
        self.protocol: Optional[ProtocolOpHandler] = None
        self.runtime: Optional[ContainerRuntime] = None
        self._runtime_factory = runtime_factory or (lambda c: ContainerRuntime(c))
        self.existing = False
        self.closed = False
        self.detached = False
        # client-side readonly policy (ref: readonly modes,
        # deltaManager.ts:274): when set, local submission is refused
        self._force_readonly = False
        self.on_signal: Optional[Callable[[Signal], None]] = None
        self.on_nack: Optional[Callable[[Nack], None]] = None
        self._base_snapshot: Optional[dict] = None
        # every client id this container has ever held: ops from a PREVIOUS
        # connection sequenced before our leave must still count as local
        # (acks), or pending state double-applies after reconnect
        self._my_client_ids: set[str] = set()
        # subsystems observing the sequenced stream (summarizer, telemetry)
        self._message_observers: list = []

    # ------------------------------------------------------------- lifecycle

    def load(self, connect: bool = True) -> "Container":
        """Boot from the latest summary (if any) and connect live."""
        self._boot_from(self.storage.get_snapshot_tree())
        if connect:
            self.connect()
        return self

    def _boot_from(self, snapshot: Optional[dict]) -> None:
        """(Re)build protocol + runtime from a summary snapshot — the
        boot core of :meth:`load`, reused by the log-truncation reanchor."""
        self._base_snapshot = snapshot
        if snapshot is not None:
            self.existing = True
            self.protocol = ProtocolOpHandler.load(snapshot["protocol"])
            self.delta_manager.last_processed_seq = snapshot["sequence_number"]
        else:
            self.protocol = ProtocolOpHandler()
        # the quorum-agreed code proposal picks the runtime factory when
        # a code loader is wired (ref: loadRuntimeFactory container.ts:1241)
        factory = self._runtime_factory
        if self._code_loader is not None:
            agreed = self._code_loader.factory_for(self)
            if agreed is not None:
                factory = agreed
        self.runtime = factory(self)
        if snapshot is not None:
            self.runtime.load_snapshot(snapshot["runtime"],
                                       base_seq=snapshot["sequence_number"])

    def _reanchor(self, err: Exception) -> bool:
        """Backfill hit the retention base (too far behind): drop the
        stale cached snapshot, re-boot from the LATEST summary — whose
        capture seq the trim is gated on, so it always lands at or past
        the hole — and let the delta manager retry the now-bounded tail.
        Returns False (error propagates) when no newer summary exists."""
        cache = getattr(self.storage, "_cache", None)
        if cache is not None:
            cache.invalidate(self.storage._tenant, self.storage._doc)
        snapshot = self.storage.get_snapshot_tree()
        if snapshot is None or snapshot["sequence_number"] \
                <= self.delta_manager.last_processed_seq:
            return False
        self._boot_from(snapshot)
        if self.delta_manager.counters is not None:
            self.delta_manager.counters.inc("boot.snapshot.reanchor")
        return True

    def connect(self) -> str:
        client_id = self.delta_manager.connect()
        # anything sequenced before our join means the document pre-existed
        if self.delta_manager.last_processed_seq > 1:
            self.existing = True
        return client_id

    def disconnect(self) -> None:
        self.delta_manager.disconnect()

    def reconnect(self) -> str:
        """Manual reconnect: new connection + pending-op replay
        (ref: auto-reconnect state machine deltaManager.ts:294,444)."""
        return self.delta_manager.reconnect()

    def attach(self) -> str:
        """Attach a detached container: connect and let the pending-op
        replay submit the offline-built initial state as the document's
        first ops (ref: container.ts:510 + runtime attach flow)."""
        if not self.detached:
            raise RuntimeError("container is not detached")
        self.detached = False
        return self.connect()

    # ------------------------------------------------------------ readonly

    @property
    def readonly(self) -> bool:
        return self._force_readonly

    def force_readonly(self, readonly: bool = True) -> None:
        """Client-side readonly switch: local edits raise while set
        (ref: forceReadonly / readonly modes deltaManager.ts:274)."""
        self._force_readonly = readonly

    def close(self) -> None:
        self.closed = True
        self.delta_manager.disconnect()

    # -------------------------------------------------------------- access

    @property
    def client_id(self) -> Optional[str]:
        return self.delta_manager.client_id

    @property
    def connected(self) -> bool:
        return self.delta_manager.connected

    @property
    def quorum(self):
        return self.protocol.quorum

    @property
    def blob_manager(self):
        """Attachment blobs (ref: blobManager.ts): payloads live in the
        content-addressed store, only handles ride the op stream."""
        if not hasattr(self, "_blob_manager"):
            from .blob_manager import BlobManager

            self._blob_manager = BlobManager(self.storage)
        return self._blob_manager

    @property
    def audience(self) -> dict[str, SequencedClient]:
        """Connected clients as known through the total order (join/leave)."""
        return dict(self.protocol.quorum.members)

    def propose(self, key: str, value: Any) -> None:
        """Submit a quorum proposal (commits when msn passes it with no
        rejection — protocol-base quorum.ts:67 semantics)."""
        self.delta_manager.submit(
            MessageType.PROPOSE, {"key": key, "value": value}
        )

    def propose_code(self, details: Any) -> None:
        """Propose the container code through the quorum — every replica
        boots the agreed package after commit (ref: "code" proposals)."""
        from .code_loader import CODE_KEY

        self.propose(CODE_KEY, details)

    def submit_signal(self, content: Any, type: str = "signal") -> None:
        self.delta_manager.submit_signal(content, type)

    # ------------------------------------------------------------ internal

    def add_message_observer(self, fn: Callable[[SequencedDocumentMessage], None]) -> None:
        self._message_observers.append(fn)

    def _process(self, msg: SequencedDocumentMessage) -> None:
        local = msg.client_id in self._my_client_ids
        self.protocol.process_message(msg, local)
        if self.runtime is not None:
            if msg.type == MessageType.OPERATION:
                self.runtime.process(msg, local)
            elif msg.type == MessageType.CLIENT_LEAVE:
                # consensus collections release a leaver's holdings
                # deterministically off the sequenced leave (SURVEY §2.2)
                left = (msg.contents or {}).get("clientId")
                if left:
                    self.runtime.on_member_removed(
                        left, seq=msg.sequence_number)
        for fn in self._message_observers:
            fn(msg)

    def _on_connection_change(self, connected: bool, client_id: Optional[str]) -> None:
        if connected and client_id is not None:
            self._my_client_ids.add(client_id)
        if self.runtime is not None:
            self.runtime.set_connection_state(connected, client_id)
        if (not connected and self.auto_reconnect and not self.closed
                and not self.delta_manager.user_disconnected):
            import threading

            threading.Thread(target=self._reconnect_loop,
                             daemon=True).start()

    def _reconnect_loop(self) -> None:
        """Server-initiated drop: re-dial with backoff until the doc is
        served again (e.g. its partition's takeover core claimed the
        lease) or the container closes."""
        import time

        delay = 0.1
        while not self.closed and not self.connected:
            time.sleep(delay)
            delay = min(delay * 2, 2.0)
            if self.closed or self.connected \
                    or self.delta_manager.user_disconnected:
                return
            try:
                self.delta_manager.connect()
            except Exception:  # noqa: BLE001 — core still down: retry
                continue
            # connect() returning is NOT success: the connection only
            # activates when our join round-trips, and a pending
            # connection that dies fires no handler (was_active=False)
            # — so wait bounded here and retry instead of returning
            t0 = time.time()
            while (not self.closed and not self.connected
                   and self.delta_manager.pending_connection is not None
                   and time.time() - t0 < 10.0):
                time.sleep(0.05)
            if self.connected:
                return
            self.delta_manager.abort_pending()

    def _on_nack(self, nack: Nack) -> None:
        # a nack means our op stream is broken at the server: the recovery
        # is reconnect + rebase/resubmit (ref: deltaManager nack handling)
        if self.on_nack:
            self.on_nack(nack)

    def _on_signal(self, signal: Signal) -> None:
        if self.on_signal:
            self.on_signal(signal)


class Loader:
    """Resolves (tenant, document) → loaded Container
    (ref: loader.ts:142,202 resolve/loadContainer)."""

    def __init__(
        self,
        factory: DocumentServiceFactory,
        runtime_factory: Optional[Callable[[Container], ContainerRuntime]] = None,
        code_loader=None,
        auto_reconnect: bool = False,
    ):
        self._factory = factory
        self._runtime_factory = runtime_factory
        self._code_loader = code_loader
        self._auto_reconnect = auto_reconnect

    def resolve(
        self, tenant_id: str, document_id: str, connect: bool = True
    ) -> Container:
        service = self._factory.create_document_service(tenant_id, document_id)
        return Container(service, self._runtime_factory,
                         code_loader=self._code_loader,
                         auto_reconnect=self._auto_reconnect).load(connect)

    def resolve_at(self, tenant_id: str, document_id: str,
                   seq: int) -> Container:
        """Resolve a POINT-IN-TIME read: a read-only offline container
        of the doc as of ``seq``, booted from the nearest committed
        summary at or below it plus a bounded history-backed tail
        backfill (see loader/history_boot.py)."""
        from .history_boot import open_at

        service = self._factory.create_document_service(tenant_id,
                                                        document_id)
        return open_at(service.history(), seq,
                       runtime_factory=self._runtime_factory)

    def create_detached(self, tenant_id: str, document_id: str) -> Container:
        """A container that lives entirely client-side until ``attach()``
        (ref: container.ts:510 detached create → attach). Build the
        initial data stores/channels offline; every edit records as
        pending state, and attach() replays it through the normal
        pending-op machinery as the document's first ops."""
        service = self._factory.create_document_service(tenant_id, document_id)
        container = Container(service, self._runtime_factory,
                              code_loader=self._code_loader).load(
            connect=False)
        container.detached = True
        return container
