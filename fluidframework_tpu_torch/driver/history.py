"""History driver: the client surface onto the doc history plane.

JAX counterpart: ``fluidframework_tpu/driver/history.py``; the port's copy,
imports rebased to this package.

One :class:`HistoryClient` per (tenant, document) — obtained from
``DocumentService.history()`` — exposes the commit/ref graph (``log`` /
``refs``), near-free fork (``fork``), point-in-time replay
(``open_at``), and CRDT-mediated integrate (``integrate``) in both
deployments: :class:`LocalHistoryClient` calls the in-proc plane
directly, :class:`NetworkHistoryClient` rides the ``history_*`` doors
over the RPC transport (commits arrive as binary FT_HISTORY frames —
the same refgraph codec the durable ref files use, so the wire
exercises the torn-tail framing end to end).

``replay_service`` is the replay driver half of point-in-time reads
(ref: packages/drivers/replay-driver ReplayController): it resolves the
nearest committed version at or below the requested seq and binds a
:class:`DocumentService` that pins it — storage serves THAT version
through the ordinary storage doors (an explicit-version ``get_tree``,
deliberately bypassing the latest-head snapshot cache), delta storage
serves the bounded tail ``(base, seq]`` through the history delta
fetch (which tolerates retention-trimmed ranges the live backfill door
refuses), and the delta stream refuses to connect: a historical read
has no seat in the quorum. The container-boot half lives one layer up
in ``loader.history_boot.open_at`` (drivers may not import the
loader), which ``Loader.resolve_at`` wraps for the common case.
"""

from __future__ import annotations

from typing import Any, Optional

from ..protocol.serialization import message_from_dict
from .definitions import (
    DocumentDeltaStorage,
    DocumentService,
    DocumentStorage,
)


class _PinnedStorage(DocumentStorage):
    """Pin ``version`` as the one and only head: the container boots the
    commit's snapshot even when newer summaries exist, and can never
    write (a historical session has nothing to summarize)."""

    def __init__(self, inner: DocumentStorage, version: dict):
        self._inner = inner
        self._version = dict(version)

    def get_versions(self, count: int = 1) -> list[dict]:
        return [dict(self._version)]

    def get_snapshot_tree(self, version: Optional[dict] = None):
        return self._inner.get_snapshot_tree(dict(self._version))

    def read_blob(self, blob_id: str) -> bytes:
        return self._inner.read_blob(blob_id)

    def write_blob(self, content: bytes) -> str:
        raise RuntimeError("historical session is read-only")

    def upload_summary(self, summary: Any, parent: Optional[str]) -> str:
        raise RuntimeError("historical session is read-only")


class _HistoryDeltaStorage(DocumentDeltaStorage):
    """Bounded tail backfill through the history delta fetch: clamps to
    the replay target so ``advance_to`` can never run past it, and the
    fetch survives retention trims (the plane falls back to a durable
    log scan where the live door would refuse with log_truncated)."""

    def __init__(self, fetch, max_seq: int):
        self._fetch = fetch
        self._max = max_seq

    def get_deltas(self, from_seq: int, to_seq: int):
        to_seq = min(to_seq, self._max + 1)
        if to_seq <= from_seq + 1:
            return []
        return self._fetch(from_seq, to_seq)


class _ReplayService(DocumentService):
    """The service a historical container binds: pinned storage, clamped
    history-backed delta storage, and NO delta stream."""

    def __init__(self, storage: DocumentStorage, deltas: DocumentDeltaStorage):
        self._storage = storage
        self._deltas = deltas

    def connect_to_delta_stream(self, details: Any = None):
        raise RuntimeError(
            "historical sessions are offline: open the live doc for a "
            "connected container")

    def connect_to_delta_storage(self):
        return self._deltas

    def connect_to_storage(self):
        return self._storage


class HistoryClient:
    """Per-(tenant, doc) history surface; subclasses supply the five
    primitive calls, ``open_at`` composes them into the replay boot."""

    tenant_id: str
    document_id: str

    # ------------------------------------------------------- primitives

    def log(self, count: Optional[int] = None) -> list[dict]:
        """Commits newest-first (JSON-safe dicts)."""
        raise NotImplementedError

    def refs(self) -> dict:
        """Named refs → commit id."""
        raise NotImplementedError

    def at(self, seq: int) -> dict:
        """Resolve a time-travel read: ``{"commit", "version",
        "base_seq"}`` for the nearest commit at or below ``seq``."""
        raise NotImplementedError

    def deltas(self, from_seq: int, to_seq: int) -> list:
        """Historical ops ``from_seq < seq < to_seq`` (retention-trim
        tolerant, unlike the live backfill door)."""
        raise NotImplementedError

    def fork(self, at_seq: Optional[int] = None,
             new_doc: Optional[str] = None) -> dict:
        """Fork this doc at ``at_seq`` (default: head) into ``new_doc``."""
        raise NotImplementedError

    def integrate(self, batch: int = 64) -> dict:
        """Replay THIS doc's post-base tail into its fork parent through
        the ordinary total order (the CRDT does the merging)."""
        raise NotImplementedError

    # ------------------------------------------------------------ replay

    def _storage(self) -> DocumentStorage:
        raise NotImplementedError

    def replay_service(self, seq: int) -> DocumentService:
        """A :class:`DocumentService` pinned to this doc as of ``seq``:
        snapshot-nearest-below storage plus bounded history-backed tail
        backfill, no live stream. ``loader.history_boot.open_at`` boots
        a read-only container from it."""
        at = self.at(seq)
        storage = _PinnedStorage(self._storage(), at["version"])
        deltas = _HistoryDeltaStorage(self.deltas, seq)
        return _ReplayService(storage, deltas)


class LocalHistoryClient(HistoryClient):
    """In-proc: straight onto ``server.history`` (the plane itself)."""

    def __init__(self, server, tenant_id: str, document_id: str):
        self._server = server
        self.tenant_id = tenant_id
        self.document_id = document_id

    @property
    def _plane(self):
        return self._server.history

    def log(self, count: Optional[int] = None) -> list[dict]:
        from ..protocol.refgraph import commit_to_json

        return [commit_to_json(c)
                for c in self._plane.log(self.tenant_id, self.document_id,
                                         count)]

    def refs(self) -> dict:
        return self._plane.refs(self.tenant_id, self.document_id)

    def at(self, seq: int) -> dict:
        return self._plane.replay_read(self.tenant_id, self.document_id,
                                       seq)

    def deltas(self, from_seq: int, to_seq: int) -> list:
        return self._plane.read_deltas(self.tenant_id, self.document_id,
                                       from_seq, to_seq)

    def fork(self, at_seq: Optional[int] = None,
             new_doc: Optional[str] = None) -> dict:
        return self._plane.fork(self.tenant_id, self.document_id,
                                at_seq=at_seq, new_doc=new_doc)

    def integrate(self, batch: int = 64) -> dict:
        return self._plane.integrate(self.tenant_id, self.document_id,
                                     batch=batch)

    def _storage(self) -> DocumentStorage:
        return self._server.storage(self.tenant_id, self.document_id)


class NetworkHistoryClient(HistoryClient):
    """Over the wire: the front end's ``history_*`` doors on the shared
    request transport. ``log`` collects the rid-tagged FT_HISTORY binary
    pushes the terminal JSON reply confirms (same wire, same reader
    thread: by reply time every commit frame has landed)."""

    def __init__(self, service):
        self._svc = service
        self.tenant_id = service._tenant
        self.document_id = service._doc

    def _frame(self, t: str, **kw) -> dict:
        svc = self._svc
        token = (svc._token_provider(self.tenant_id, self.document_id)
                 if svc._token_provider else None)
        return {"t": t, "tenant": self.tenant_id, "doc": self.document_id,
                "token": token, **kw}

    def _req(self, t: str, **kw) -> dict:
        return self._svc._rpc_transport().request(self._frame(t, **kw))

    def log(self, count: Optional[int] = None) -> list[dict]:
        transport = self._svc._rpc_transport()
        rid, reply = transport.request_rid(self._frame(
            "history_log", count=count))
        commits = transport.take_history(rid)
        if len(commits) != reply.get("commits", 0):
            raise RuntimeError(
                f"history log frame loss: {len(commits)} of "
                f"{reply.get('commits')} commits arrived")
        return commits

    def refs(self) -> dict:
        return self._req("history_log", count=0)["refs"]

    def at(self, seq: int) -> dict:
        return self._req("history_at", seq=seq)["at"]

    def deltas(self, from_seq: int, to_seq: int) -> list:
        reply = self._req("history_deltas",
                          **{"from": from_seq, "to": to_seq})
        return [message_from_dict(d) for d in reply["msgs"]]

    def fork(self, at_seq: Optional[int] = None,
             new_doc: Optional[str] = None) -> dict:
        return self._req("history_fork", seq=at_seq,
                         new_doc=new_doc)["fork"]

    def integrate(self, batch: int = 64) -> dict:
        return self._req("history_integrate", batch=batch)["integrate"]

    def _storage(self) -> DocumentStorage:
        return self._svc.connect_to_storage()
