"""Local driver: client stack ⇄ in-proc LocalServer, no network.

JAX counterpart: ``fluidframework_tpu/driver/local.py``; the port's copy,
imports rebased to this package. ``LocalDocumentService.history()``
raises ``NotImplementedError``: the history plane is not ported yet, so
the replay tool takes its whole-log path for local documents too.

Ref: packages/drivers/local-driver (localDocumentService.ts,
localDocumentDeltaConnection.ts) — the test backbone binding the REAL
client stack to the REAL service lambdas in one process (SURVEY §4).
"""

from __future__ import annotations

import json
from typing import Any, Optional

from ..service.core import summary_versions_collection
from ..service.local_server import LocalServer, ServerConnection
from .definitions import (
    DocumentDeltaConnection,
    DocumentDeltaStorage,
    DocumentService,
    DocumentServiceFactory,
    DocumentStorage,
)


class LocalDeltaConnection(DocumentDeltaConnection):
    def __init__(self, conn: ServerConnection):
        self._conn = conn
        self.client_id = conn.client_id
        self.initial_sequence_number = conn.initial_sequence_number
        self.mode = getattr(conn, "mode", "write")
        self.on_disconnect = None

    # event callbacks proxy straight to the server connection's buffered
    # handler slots
    on_op = property(
        lambda self: self._conn.on_op,
        lambda self, cb: setattr(self._conn, "on_op", cb))
    on_nack = property(
        lambda self: self._conn.on_nack,
        lambda self, cb: setattr(self._conn, "on_nack", cb))
    on_signal = property(
        lambda self: self._conn.on_signal,
        lambda self, cb: setattr(self._conn, "on_signal", cb))

    def submit(self, messages) -> None:
        self._conn.submit(messages)

    def submit_signal(self, content: Any, type: str = "signal") -> None:
        self._conn.submit_signal(content, type)

    def close(self) -> None:
        self._conn.disconnect()
        if self.on_disconnect:
            self.on_disconnect("client closed connection")


class LocalDeltaStorage(DocumentDeltaStorage):
    def __init__(self, server: LocalServer, tenant_id: str, document_id: str):
        self._server = server
        self._tenant = tenant_id
        self._doc = document_id

    def get_deltas(self, from_seq: int, to_seq: int):
        return self._server.get_deltas(self._tenant, self._doc, from_seq, to_seq)


class LocalStorage(DocumentStorage):
    """Versioned summary storage over the server's content-addressed blob
    store (the gitrest/historian analog — the C++ chunk store when the
    server has a storage dir; trees/blobs keyed by sha, versions = the
    ref chain, scribe ack = the ref update).

    Summary trees upload recursively (ref: summaryWriter.ts:69-192
    writeClientSummary → createGitTree): each blob is content-addressed;
    each tree node is a JSON blob of named child refs; a
    ``SummaryHandle`` resolves to the PARENT version's subtree ref at
    that path and re-uploads nothing (protocol-definitions summary.ts
    incremental contract).

    Stored tree-node format: {"t": "tree", "e": {name: {"k", "id"}}}.
    """

    def __init__(self, server: LocalServer, tenant_id: str, document_id: str):
        from ..service.local_orderer import restore_version_records

        # durable-log deployments: acked version records may only exist
        # on the versions topic after a process restart (boot reads
        # storage BEFORE any orderer exists to restore them). Once per
        # (tenant, doc) per process: LocalStorage is constructed per
        # storage RPC, and an unmemoized scan would tax every request
        # with O(#summaries) log reads.
        restored = getattr(server, "_versions_restored", None)
        if restored is None:
            restored = server._versions_restored = set()
        if (tenant_id, document_id) not in restored:
            restore_version_records(server.log, server.db, tenant_id,
                                    document_id)
            restored.add((tenant_id, document_id))
        self._server = server
        self._tenant = tenant_id
        self._doc = document_id
        self._db = server.db
        self._blobs = server.blob_store
        self._stats = server.storage_stats
        self._versions_col = summary_versions_collection(tenant_id, document_id)

    # ------------------------------------------------------------ versions

    def get_versions(self, count: int = 1) -> list[dict]:
        """Only scribe-ACKED versions are boot sources (the git-ref analog:
        scribe committing a summary is what makes it a version); uploads
        that were never validated, or were nacked, are invisible here."""
        versions = sorted(
            (v for v in self._db.collection(self._versions_col).values()
             if v.get("acked")),
            key=lambda v: v["n"],
            reverse=True,
        )
        return [{"id": v["_id"], "tree_id": v["tree_id"]} for v in versions[:count]]

    # -------------------------------------------------------------- reads

    def get_snapshot_tree(self, version: Optional[dict] = None) -> Optional[dict]:
        """Materialize a version into the plain nested summary dict the
        container boots from (reads back through the chunk store)."""
        if version is None:
            versions = self.get_versions(1)
            if not versions:
                return None
            version = versions[0]
        ref = json.loads(self.read_blob(version["tree_id"]).decode())
        if ref.get("t") == "snapcols":
            from ..service.summary_trees import materialize_snapcols

            return materialize_snapcols(self.read_blob, ref)
        if ref.get("t") != "tree":
            return ref  # legacy single-blob summary
        from ..service.summary_trees import materialize_tree

        return materialize_tree(self.read_blob,
                                {"k": "tree", "id": version["tree_id"]})

    def read_blob(self, blob_id: str) -> bytes:
        return self._blobs.get(blob_id)

    def write_blob(self, content: bytes) -> str:
        return self._blobs.put(content)

    # ------------------------------------------------------------- uploads

    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        from ..protocol.summary import (
            SummaryObject,
            SummaryTree,
            is_summary_wire,
            summary_from_wire,
        )

        if is_summary_wire(summary):
            summary = summary_from_wire(summary)
        if isinstance(summary, SummaryTree):
            parent_root = self._version_root_ref(parent)
            root_ref = self._upload_obj(summary, parent_root)
            tree_id = root_ref["id"]
        else:
            # legacy monolithic dict
            tree_id = self.write_blob(json.dumps(summary).encode())
        n = len(self._db.collection(self._versions_col))
        version_id = f"v{n}"
        record = {"n": n, "tree_id": tree_id, "parent": parent}
        self._db.upsert(self._versions_col, version_id, record)
        hook = getattr(self._server, "on_version_uploaded", None)
        if hook is not None:
            # split-service composition: the external scribe process
            # learns of uploads through this announcement (it has no
            # view of this process's db)
            hook(self._tenant, self._doc, version_id, record)
        return version_id

    def _version_root_ref(self, version_id: Optional[str]) -> Optional[dict]:
        if version_id is None:
            return None
        v = self._db.find_one(self._versions_col, version_id)
        if v is None:
            return None
        return {"k": "tree", "id": v["tree_id"]}

    def _upload_obj(self, obj, parent_root: Optional[dict]) -> dict:
        from ..service.summary_trees import upload_summary_obj

        return upload_summary_obj(self._blobs, obj, parent_root, self._stats)


class LocalDocumentService(DocumentService):
    def __init__(self, server: LocalServer, tenant_id: str, document_id: str):
        self._server = server
        self._tenant = tenant_id
        self._doc = document_id

    def connect_to_delta_stream(self, details: Any = None) -> LocalDeltaConnection:
        return LocalDeltaConnection(self._server.connect(self._tenant, self._doc, details))

    def connect_to_delta_storage(self) -> LocalDeltaStorage:
        return LocalDeltaStorage(self._server, self._tenant, self._doc)

    def connect_to_storage(self):
        return self._server.storage(self._tenant, self._doc)

    def history(self):
        raise NotImplementedError(
            "LocalDocumentService has no history surface: the history plane "
            "is not ported to fluidframework_tpu_torch yet (ROADMAP A4)")


class LocalDocumentServiceFactory(DocumentServiceFactory):
    def __init__(self, server: LocalServer):
        self._server = server

    def create_document_service(
        self, tenant_id: str, document_id: str
    ) -> LocalDocumentService:
        return LocalDocumentService(self._server, tenant_id, document_id)
