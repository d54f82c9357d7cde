"""Driver contracts (ref: packages/loader/driver-definitions/src).

JAX counterpart: ``fluidframework_tpu/driver/definitions.py``; the port's copy,
imports rebased to this package.

``IDocumentServiceFactory`` → ``IDocumentService`` → the three
sub-services: ``IDocumentDeltaConnection`` (live stream),
``IDocumentDeltaStorageService`` (backfill), ``IDocumentStorageService``
(snapshots/blobs).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional

from ..protocol.messages import (
    DocumentMessage,
    Nack,
    SequencedDocumentMessage,
    Signal,
)


class DocumentDeltaConnection(ABC):
    """Live bidirectional op stream for one client connection.

    Ref: driver-definitions IDocumentDeltaConnection; socket wrapper in
    driver-base/src/documentDeltaConnection.ts:53.
    """

    client_id: str
    initial_sequence_number: int
    # event callbacks (buffered until assigned, matching socket semantics)
    on_op: Optional[Callable[[SequencedDocumentMessage], None]]
    on_nack: Optional[Callable[[Nack], None]]
    on_signal: Optional[Callable[[Signal], None]]
    on_disconnect: Optional[Callable[[str], None]]

    @abstractmethod
    def submit(self, messages: list[DocumentMessage]) -> None: ...

    @abstractmethod
    def submit_signal(self, content: Any, type: str = "signal") -> None: ...

    @abstractmethod
    def close(self) -> None: ...


class DocumentDeltaStorage(ABC):
    """Sequenced-op backfill (ref: IDocumentDeltaStorageService; alfred
    /deltas REST → routerlicious-driver deltaStorageService.ts:17)."""

    @abstractmethod
    def get_deltas(self, from_seq: int, to_seq: int) -> list[SequencedDocumentMessage]:
        """Ops with from_seq < seq < to_seq (exclusive bounds)."""


class DocumentStorage(ABC):
    """Snapshot/blob storage (ref: IDocumentStorageService; historian REST
    via services-client GitManager)."""

    @abstractmethod
    def get_versions(self, count: int = 1) -> list[dict]:
        """Latest summary versions, newest first ({'id', 'tree_id'})."""

    @abstractmethod
    def get_snapshot_tree(self, version: Optional[dict] = None) -> Optional[dict]:
        """The summary tree for a version (None ⇒ no summary yet)."""

    @abstractmethod
    def read_blob(self, blob_id: str) -> bytes: ...

    @abstractmethod
    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        """Write a summary tree; returns its handle (commit id)."""


class DocumentService(ABC):
    """One document's service bindings (ref: IDocumentService)."""

    @abstractmethod
    def connect_to_delta_stream(self, details: Any = None) -> DocumentDeltaConnection: ...

    @abstractmethod
    def connect_to_delta_storage(self) -> DocumentDeltaStorage: ...

    @abstractmethod
    def connect_to_storage(self) -> DocumentStorage: ...

    def history(self):
        """History-plane client for this document (commit log, fork,
        point-in-time replay, integrate) — see driver/history.py. Not
        abstract: drivers without a history surface (file, replay) keep
        working and refuse here."""
        raise NotImplementedError(
            f"{type(self).__name__} has no history surface")


class DocumentServiceFactory(ABC):
    """Resolves a document URL/id to a DocumentService
    (ref: IDocumentServiceFactory.createDocumentService)."""

    @abstractmethod
    def create_document_service(
        self, tenant_id: str, document_id: str
    ) -> DocumentService: ...
