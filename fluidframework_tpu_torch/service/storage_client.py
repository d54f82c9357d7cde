"""RemoteStorage: the DocumentStorage surface over the storage process.

JAX counterpart: ``fluidframework_tpu/service/storage_client.py``; the
port's copy, imports rebased to this package.

Ref: services-client/src/historian.ts:29 — every storage consumer (the
ordering service's summarizer, the drivers' snapshot boot) reaches
summaries through the storage service's REST surface, never its disk.
This client binds one (tenant, doc) to a storage_server.py process over
the shared framed-JSON transport; the ordering core hands these out via
``LocalServer.storage()`` when deployed with ``--storage-server``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from ..driver.network import _Transport
from ..protocol.summary import (
    SummaryAttachment,
    SummaryBlob,
    SummaryHandle,
    SummaryTree,
    summary_to_wire,
)


class StorageConnection:
    """One shared transport to the storage process (many docs ride it)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._host, self._port, self._timeout = host, port, timeout
        self._t: Optional[_Transport] = None
        # front-end session threads and the orderer's ref-commit path
        # race the lazy connect; without the lock the loser's socket +
        # reader thread would leak
        self._lock = threading.Lock()

    def transport(self) -> _Transport:
        with self._lock:
            if self._t is None or self._t._closed:
                self._t = _Transport(self._host, self._port, self._timeout)
            return self._t

    def request(self, frame: dict) -> dict:
        return self.transport().request(frame)

    def close(self) -> None:
        """Close the transport (a later request opens a new one)."""
        with self._lock:
            if self._t is not None:
                self._t.close()
                self._t = None


class RemoteStorage:
    """DocumentStorage over the storage process, for one (tenant, doc).

    ``on_uploaded(version_id, record)`` fires after a summary upload —
    the ordering core uses it to mirror the version record into its db
    (scribe validation reads it there) and to announce the upload to an
    external scribe stage."""

    def __init__(self, conn: StorageConnection, tenant_id: str,
                 document_id: str,
                 on_uploaded: Optional[Callable] = None):
        self._conn = conn
        self._tenant = tenant_id
        self._doc = document_id
        self._on_uploaded = on_uploaded

    def _req(self, t: str, **kw) -> dict:
        return self._conn.request(
            {"t": t, "tenant": self._tenant, "doc": self._doc, **kw})

    # ------------------------------------------------- DocumentStorage api

    def get_versions(self, count: int = 1) -> list[dict]:
        return self._req("get_versions", count=count)["versions"]

    def get_snapshot_tree(self, version: Optional[dict] = None):
        return self._req("get_tree", version=version)["tree"]

    def read_blob(self, blob_id: str) -> bytes:
        return bytes.fromhex(self._req("read_blob", id=blob_id)["hex"])

    def write_blob(self, content: bytes) -> str:
        return self._req("write_blob", hex=content.hex())["id"]

    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        if isinstance(summary, (SummaryTree, SummaryBlob, SummaryHandle,
                                SummaryAttachment)):
            summary = summary_to_wire(summary)
        out = self._req("upload_summary", summary=summary, parent=parent)
        if self._on_uploaded is not None:
            self._on_uploaded(out["id"], dict(out["record"]))
        return out["id"]

    # -------------------------------------------------- commit-graph extras

    def commit_ref(self, version_id: str) -> None:
        self._req("commit_ref", id=version_id)

    def get_ref(self) -> Optional[str]:
        return self._req("get_ref")["id"]

    def history(self, count: int = 50) -> list[dict]:
        return self._req("history", count=count)["commits"]

    def stats(self) -> dict:
        return self._conn.request({"t": "stats"})["stats"]
