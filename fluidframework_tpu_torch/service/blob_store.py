"""Server-side content-addressed blob stores (the gitrest/libgit2 role).

JAX counterpart: ``fluidframework_tpu/service/blob_store.py``; the port's copy,
imports rebased to this package.

Two implementations of one surface — ``put(bytes) -> id``,
``get(id) -> bytes``, ``has(id)`` — plus shared usage counters so tests
and ops can assert dedup/handle-reuse behavior:

- :class:`DbBlobStore`: blobs in the in-memory db (test default).
- :class:`NativeBlobStore`: the C++ chunk store (native/chunkstore.cpp,
  sha256 fan-out, tmp+rename crash safety) — the production path, used
  whenever the server is given a storage directory.
"""

from __future__ import annotations

import hashlib

from .core import InMemoryDb


class BlobStoreStats:
    def __init__(self):
        self.puts = 0  # put() calls
        self.new_blobs = 0  # puts that stored new content
        self.deduped = 0  # puts that hit existing content

    def as_dict(self) -> dict:
        return {"puts": self.puts, "new_blobs": self.new_blobs,
                "deduped": self.deduped}


class DbBlobStore:
    def __init__(self, db: InMemoryDb, collection: str = "blobs"):
        self._db = db
        self._col = collection
        self.stats = BlobStoreStats()

    def put(self, content: bytes) -> str:
        blob_id = hashlib.sha256(content).hexdigest()
        self.stats.puts += 1
        if self._db.find_one(self._col, blob_id) is None:
            self.stats.new_blobs += 1
            self._db.upsert(self._col, blob_id, {"hex": content.hex()})
        else:
            self.stats.deduped += 1
        return blob_id

    def get(self, blob_id: str) -> bytes:
        doc = self._db.find_one(self._col, blob_id)
        if doc is None:
            raise KeyError(f"unknown blob {blob_id}")
        return bytes.fromhex(doc["hex"])

    def has(self, blob_id: str) -> bool:
        return self._db.find_one(self._col, blob_id) is not None

    def delete(self, blob_id: str) -> bool:
        """Unlink one blob (history-plane chunk GC). Returns whether it
        existed. ONLY the GC may call this — deletion is safe exactly
        when no ref-reachable commit names the chunk."""
        col = self._db.collection(self._col)
        return col.pop(blob_id, None) is not None
