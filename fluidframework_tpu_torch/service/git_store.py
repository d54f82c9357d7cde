"""GitStore: parent-linked commit DAG + named refs over a blob store.

JAX counterpart: ``fluidframework_tpu/service/git_store.py``; the port's
copy (standard library only).

Ref: the reference's storage is literally git — scribe's summary commit
creates a git commit whose ref the service advances
(services-client/src/gitManager.ts:13 getCommits/createCommit,
server/gitrest/src/routes/git, historian.ts:29 caching proxy). Version
records that merely flip an ``acked`` flag (round-3 shape) cannot walk
history or boot from a named head; this module adds the DAG:

- a COMMIT is a content-addressed blob
  ``{"t": "commit", "tree": id, "parents": [ids], "meta": {...}}`` —
  immutable, deduped, sharing the chunk store with trees/blobs;
- a REF is a named pointer (``heads/<tenant>/<doc>``) whose updates
  append to a durable oplog topic (the reflog), so refs survive process
  death and replay on open;
- ``history`` walks parent links from a ref or commit id.

The standalone storage process (storage_server.py) serves this over
RPCs; scribe's ack path advances the ref.
"""

from __future__ import annotations

import json
from typing import Optional

REFS_TOPIC = "refs"


def head_ref(tenant_id: str, document_id: str) -> str:
    return f"heads/{tenant_id}/{document_id}"


class GitStore:
    def __init__(self, blobs, refs_log=None):
        """``blobs``: put/get/has content store. ``refs_log``: a
        NativeOpLog (or None for ephemeral refs); the reflog topic is
        replayed on open — last write per name wins."""
        self._blobs = blobs
        self._refs_log = refs_log
        self._refs: dict[str, str] = {}
        if refs_log is not None:
            try:
                n = refs_log.length(REFS_TOPIC)
            except OSError:
                n = 0
            for i in range(n):
                rec = json.loads(refs_log.read(REFS_TOPIC, i))
                self._refs[rec["name"]] = rec["commit"]

    # ------------------------------------------------------------- commits

    def write_commit(self, tree_id: str, parents: list[str],
                     meta: Optional[dict] = None) -> str:
        blob = json.dumps(
            {"t": "commit", "tree": tree_id, "parents": sorted(parents),
             "meta": meta or {}},
            sort_keys=True, separators=(",", ":")).encode()
        return self._blobs.put(blob)

    def read_commit(self, commit_id: str) -> dict:
        obj = json.loads(self._blobs.get(commit_id).decode())
        if obj.get("t") != "commit":
            raise KeyError(f"{commit_id} is not a commit")
        return obj

    def history(self, start: str, limit: int = 50) -> list[dict]:
        """Commits from ``start`` (a ref name or commit id) following
        first parents, newest first — the git-log walk boot/debug
        tooling uses."""
        commit_id = self._refs.get(start, start)
        out = []
        while commit_id and len(out) < limit:
            c = self.read_commit(commit_id)
            out.append(dict(c, id=commit_id))
            commit_id = c["parents"][0] if c["parents"] else None
        return out

    # ---------------------------------------------------------------- refs

    def set_ref(self, name: str, commit_id: str) -> None:
        self._refs[name] = commit_id
        if self._refs_log is not None:
            self._refs_log.append(REFS_TOPIC, json.dumps(
                {"name": name, "commit": commit_id},
                separators=(",", ":")).encode())
            self._refs_log.flush()

    def get_ref(self, name: str) -> Optional[str]:
        return self._refs.get(name)

    def refs(self) -> dict:
        return dict(self._refs)
