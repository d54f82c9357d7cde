"""Driver-side snapshot cache — the odsp-driver lesson.

JAX counterpart: ``fluidframework_tpu/driver/snapshot_cache.py``; the
port's copy.

Ref: packages/drivers/odsp-driver/src/odspCache.ts — the reference's
production driver caches version→tree→blob results per document so a
re-boot (page reload, new container for the same doc) issues no storage
round trips; correctness comes from delta catch-up (booting from an
older summary is always safe — the op stream brings the container
current), and the cache entry is invalidated when a newer summary is
committed (a summaryAck on the live stream).

Shared across a factory's documents; stats make the contract testable:
a second boot of an unchanged doc must serve entirely from here.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

DEFAULT_TTL_S = 120.0

#: cap on cached snapshot chunks (content-addressed, so eviction only
#: costs a refetch; insertion-order eviction approximates LRU well
#: enough because chunk reuse clusters on the most recent generations)
MAX_CHUNKS = 4096


class SnapshotCache:
    """``ttl_s`` bounds how stale an entry can get when no live
    connection of this factory observes the invalidating summaryAck
    (doc open in another process only): past the TTL the entry is a
    miss. Within the TTL a boot from a superseded summary is still
    correct as long as the service retains the covering ops
    (config.log_retention_ops margin)."""

    def __init__(self, ttl_s: float = DEFAULT_TTL_S,
                 max_chunks: int = MAX_CHUNKS):
        self._entries: dict[tuple, dict] = {}
        self._epochs: dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._ttl = ttl_s
        self.stats = {"hits": 0, "misses": 0, "invalidations": 0}
        # content-addressed snapcols chunks, shared across docs AND
        # versions (identical chunk → identical hash): summary
        # invalidation does NOT clear these — unchanged chunks of the
        # NEW version are exactly the reuse this cache exists for
        self._chunks: dict[str, bytes] = {}
        self._max_chunks = max_chunks
        self.chunk_stats = {"hits": 0, "misses": 0}

    def epoch(self, tenant_id: str, document_id: str) -> int:
        """Read BEFORE fetching what you intend to put: a put whose
        epoch is stale (an invalidation raced the fetch) is dropped
        instead of resurrecting the superseded snapshot."""
        with self._lock:
            return self._epochs.get((tenant_id, document_id), 0)

    def get(self, tenant_id: str, document_id: str) -> Optional[dict]:
        """``{"version": {...}, "tree": Any}`` or None."""
        with self._lock:
            key = (tenant_id, document_id)
            entry = self._entries.get(key)
            if entry is not None and \
                    time.monotonic() - entry["at"] > self._ttl:
                del self._entries[key]
                entry = None
            if entry is None:
                self.stats["misses"] += 1
                return None
            self.stats["hits"] += 1
            return entry

    def put(self, tenant_id: str, document_id: str, version: dict,
            tree: Any, epoch: Optional[int] = None) -> None:
        with self._lock:
            key = (tenant_id, document_id)
            if epoch is not None and self._epochs.get(key, 0) != epoch:
                return  # an invalidation raced the fetch: data is stale
            self._entries[key] = {"version": version, "tree": tree,
                                  "at": time.monotonic()}

    def get_chunk(self, chunk_hash: str) -> Optional[bytes]:
        with self._lock:
            data = self._chunks.get(chunk_hash)
            self.chunk_stats["hits" if data is not None else "misses"] += 1
            return data

    def put_chunk(self, chunk_hash: str, data: bytes) -> None:
        with self._lock:
            while len(self._chunks) >= self._max_chunks:
                del self._chunks[next(iter(self._chunks))]
            self._chunks[chunk_hash] = data

    def chunk_hashes(self) -> list[str]:
        """Hashes on hand — the ``have`` list a booting client sends so
        the server skips pushing chunks it already holds."""
        with self._lock:
            return list(self._chunks)

    def invalidate(self, tenant_id: str, document_id: str) -> None:
        """A newer summary committed: the cached boot source is stale
        (still CORRECT to boot from — ops catch up — but the next boot
        should not replay an ever-growing tail, and with retention on,
        must not outlive the covering ops)."""
        with self._lock:
            key = (tenant_id, document_id)
            self._epochs[key] = self._epochs.get(key, 0) + 1
            if self._entries.pop(key, None) is not None:
                self.stats["invalidations"] += 1
