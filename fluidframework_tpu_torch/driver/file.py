"""File driver: a document persisted as plain files, for replay/offline.

JAX counterpart: ``fluidframework_tpu/driver/file.py``; the port's copy,
imports rebased to this package.

Ref: packages/drivers/file-driver (fileDocumentService.ts — reads a
document's ops + snapshots from local files and feeds the replay-tool)
and replay-driver (replayController.ts — a read-only document service
that pumps recorded ops through the real loader/runtime).

On-disk layout, one directory per document:

    <root>/<tenant>/<doc>/messages.json   [wire-encoded sequenced msgs]
    <root>/<tenant>/<doc>/snapshot.json   optional boot summary dict

A document opened through this driver is READ-ONLY: there is no ordering
service behind it, so the delta stream cannot accept submissions. Load
containers with ``connect=False`` and pump with
``delta_manager.advance_to(seq)``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from ..protocol.serialization import message_from_dict, message_to_dict
from .definitions import (
    DocumentDeltaStorage,
    DocumentService,
    DocumentServiceFactory,
    DocumentStorage,
)


def write_doc_dir(doc_dir: str, msgs: list, snap: Optional[dict]) -> str:
    """THE on-disk writer for the file-driver layout — record_document
    (in-proc) and replay/fetch.py (network) both serialize through here
    so the format can never fork between them."""
    os.makedirs(doc_dir, exist_ok=True)
    with open(os.path.join(doc_dir, "messages.json"), "w") as f:
        json.dump([message_to_dict(m) for m in msgs], f)
    if snap is not None:
        with open(os.path.join(doc_dir, "snapshot.json"), "w") as f:
            json.dump(snap, f)
    return doc_dir


def record_document(server, tenant_id: str, document_id: str,
                    root_dir: str) -> str:
    """Dump a live server's document to the file-driver layout (the
    fetch-tool role): full sequenced log + latest acked summary."""
    msgs = server.get_deltas(tenant_id, document_id, 0, 10**9)
    snap = server.storage(tenant_id, document_id).get_snapshot_tree()
    return write_doc_dir(os.path.join(root_dir, tenant_id, document_id),
                         msgs, snap)


class FileDeltaStorage(DocumentDeltaStorage):
    def __init__(self, messages: list):
        self._messages = messages
        # a fetched doc may hold only the TAIL of a retention-truncated
        # log: index by the first message's actual seq, never assume
        # messages[i] is seq i+1
        self._first = (messages[0].sequence_number if messages else 1)

    def get_deltas(self, from_seq: int, to_seq: int):
        lo = max(from_seq - (self._first - 1), 0)
        hi = min(to_seq - self._first, len(self._messages))
        return self._messages[lo:hi] if hi > lo else []

    @property
    def last_seq(self) -> int:
        return self._messages[-1].sequence_number if self._messages else 0


class FileStorage(DocumentStorage):
    def __init__(self, snapshot: Optional[dict]):
        self._snapshot = snapshot

    def get_versions(self, count: int = 1) -> list[dict]:
        return [{"id": "file", "tree_id": "file"}] if self._snapshot else []

    def get_snapshot_tree(self, version: Optional[dict] = None):
        return self._snapshot

    def read_blob(self, blob_id: str) -> bytes:
        raise NotImplementedError("file driver stores one materialized tree")

    def write_blob(self, content: bytes) -> str:
        raise ReadOnlyDocumentError("file documents are read-only")

    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        raise ReadOnlyDocumentError("file documents are read-only")


class ReadOnlyDocumentError(RuntimeError):
    pass


class FileDocumentService(DocumentService):
    def __init__(self, messages: list, snapshot: Optional[dict]):
        self._delta_storage = FileDeltaStorage(messages)
        self._storage = FileStorage(snapshot)

    @classmethod
    def from_dir(cls, doc_dir: str) -> "FileDocumentService":
        with open(os.path.join(doc_dir, "messages.json")) as f:
            messages = [message_from_dict(d) for d in json.load(f)]
        snap_path = os.path.join(doc_dir, "snapshot.json")
        snapshot = None
        if os.path.exists(snap_path):
            with open(snap_path) as f:
                snapshot = json.load(f)
        return cls(messages, snapshot)

    def connect_to_delta_stream(self, details: Any = None):
        raise ReadOnlyDocumentError(
            "file documents have no ordering service: load with "
            "connect=False and pump with delta_manager.advance_to()")

    def connect_to_delta_storage(self) -> FileDeltaStorage:
        return self._delta_storage

    def connect_to_storage(self) -> FileStorage:
        return self._storage

    @property
    def last_seq(self) -> int:
        return self._delta_storage.last_seq


class FileDocumentServiceFactory(DocumentServiceFactory):
    def __init__(self, root_dir: str):
        self._root = root_dir

    def create_document_service(
        self, tenant_id: str, document_id: str
    ) -> FileDocumentService:
        return FileDocumentService.from_dir(
            os.path.join(self._root, tenant_id, document_id))
