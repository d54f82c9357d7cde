"""Server-side content-addressed blob stores (the gitrest/libgit2 role).

JAX counterpart: ``fluidframework_tpu/service/blob_store.py``; the port's copy,
imports rebased to this package.

Two implementations of one surface — ``put(bytes) -> id``,
``get(id) -> bytes``, ``has(id)`` — plus shared usage counters so tests
and ops can assert dedup/handle-reuse behavior:

- :class:`DbBlobStore`: blobs in the in-memory db (test default).
- :class:`NativeBlobStore`: the C++ chunk store (csrc/chunkstore.cpp,
  sha256 fan-out, tmp+rename crash safety) — the production path, used
  whenever the server is given a storage directory.
"""

from __future__ import annotations

import hashlib
import os

from ..native import NativeChunkStore
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


class NativeBlobStore:
    def __init__(self, directory: str):
        self._cas = NativeChunkStore(directory)
        self._dir = directory
        self.stats = BlobStoreStats()

    def put(self, content: bytes) -> str:
        self.stats.puts += 1
        blob_id = hashlib.sha256(content).hexdigest()
        if self._cas.has(blob_id):
            self.stats.deduped += 1
        else:
            self.stats.new_blobs += 1
        stored = self._cas.put(content)
        if stored != blob_id:
            raise OSError(f"host/native hash disagreement: {blob_id} "
                          f"!= {stored}")
        return stored

    def get(self, blob_id: str) -> bytes:
        return self._cas.get(blob_id)

    def has(self, blob_id: str) -> bool:
        return self._cas.has(blob_id)

    def delete(self, blob_id: str) -> bool:
        """Unlink one blob from the sha-fan-out object layout
        (``dir/aa/rest``) — the native store exposes no remove, and GC
        runs host-side anyway. Returns whether the blob existed."""
        path = os.path.join(self._dir, blob_id[:2], blob_id[2:])
        try:
            os.unlink(path)
            return True
        except FileNotFoundError:
            return False

    def close(self) -> None:
        self._cas.close()
