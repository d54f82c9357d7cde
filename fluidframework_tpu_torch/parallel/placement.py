"""Doc → shard placement: the partition-routing table.

Ref: the reference routes a document to a Kafka partition by hashing
``(tenantId, documentId)`` (services/src/kafkaFactory.ts producers key on
doc id; lambdas-driver document-router demuxes per doc). Here the same
decision places a doc into a batch slot on a mesh shard; the host front-end
uses it to route incoming ops to the right per-shard staging buffer.

JAX counterpart: ``fluidframework_tpu/parallel/placement.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


def _stable_hash(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "little")


@dataclass
class DocPlacement:
    """Assigns each (tenant, doc) a (shard, slot) and tracks occupancy."""

    n_shards: int
    slots_per_shard: int
    _map: dict[str, tuple[int, int]] = field(default_factory=dict)
    _free: list[list[int]] = field(default_factory=list)

    def __post_init__(self):
        if not self._free:
            self._free = [
                list(range(self.slots_per_shard - 1, -1, -1))
                for _ in range(self.n_shards)
            ]

    @staticmethod
    def key(tenant_id: str, document_id: str) -> str:
        return f"{tenant_id}/{document_id}"

    def place(self, tenant_id: str, document_id: str) -> tuple[int, int]:
        """Idempotently place a doc; sticky once assigned (ref: Mongo lease
        reservations, memory-orderer/src/reservationManager.ts:21)."""
        k = self.key(tenant_id, document_id)
        if k in self._map:
            return self._map[k]
        preferred = _stable_hash(k) % self.n_shards
        for delta in range(self.n_shards):
            shard = (preferred + delta) % self.n_shards
            if self._free[shard]:
                slot = self._free[shard].pop()
                self._map[k] = (shard, slot)
                return shard, slot
        raise RuntimeError("all shards full; grow slots_per_shard or n_shards")

    def lookup(self, tenant_id: str, document_id: str) -> tuple[int, int] | None:
        return self._map.get(self.key(tenant_id, document_id))

    def split_rows(self, rows):
        """Vectorized global state row → (shard, local_row). The state's
        doc axis is shard-major (row = shard * slots_per_shard + slot,
        matching NamedSharding's contiguous blocks), so this is THE map
        from placement rows to mesh devices; works on ints and numpy
        arrays alike."""
        shard = rows // self.slots_per_shard
        return shard, rows - shard * self.slots_per_shard

    def evict(self, tenant_id: str, document_id: str) -> None:
        """Release a doc's slot (idle expiry / doc close)."""
        k = self.key(tenant_id, document_id)
        if k in self._map:
            shard, slot = self._map.pop(k)
            self._free[shard].append(slot)

    def snapshot(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "slots_per_shard": self.slots_per_shard,
            "map": {k: list(v) for k, v in self._map.items()},
        }

    @classmethod
    def load(cls, snap: dict) -> "DocPlacement":
        p = cls(snap["n_shards"], snap["slots_per_shard"])
        for k, (shard, slot) in snap["map"].items():
            p._map[k] = (shard, slot)
            p._free[shard].remove(slot)
        return p
