"""Copier: raw-op archival, pre-deli.

JAX counterpart: ``fluidframework_tpu/service/copier.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/copier — consumes the RAW ops topic (before any
ticketing) and archives records to the database, giving an audit/debug
trail that survives independent of deli's processing: a nacked or
misrouted submission is still findable here, which is the whole point —
the sequenced log only shows what deli ACCEPTED.
"""

from __future__ import annotations

from .core import InMemoryDb, QueuedMessage
from .deli import RawBoxcar, RawMessage


class CopierLambda:
    """Archives every raw record (message or boxcar) with its log offset."""

    def __init__(self, db: InMemoryDb, collection: str = "rawops-archive"):
        self._db = db
        self._collection = collection
        self.copied = 0

    def handler(self, message: QueuedMessage) -> None:
        raw = message.value
        if isinstance(raw, RawBoxcar):
            doc = {
                "kind": "boxcar",
                "tenant_id": raw.tenant_id,
                "document_id": raw.document_id,
                "client_id": raw.client_id,
                "count": len(raw.ops),
                "ops": [
                    {"type": op.type.value,
                     "clientSeq": op.client_sequence_number}
                    for op in raw.ops
                ],
            }
        elif isinstance(raw, RawMessage):
            doc = {
                "kind": "raw",
                "tenant_id": raw.tenant_id,
                "document_id": raw.document_id,
                "client_id": raw.client_id,
                "type": raw.operation.type.value,
                "clientSeq": raw.operation.client_sequence_number,
            }
        else:  # checkpoint records etc. on shared logs: not raw traffic
            return
        self._db.upsert(self._collection, f"{message.offset}",
                        dict(doc, offset=message.offset))
        self.copied += 1

    def archive(self, tenant_id: str, document_id: str) -> list[dict]:
        """Audit query: a doc's raw records in arrival (offset) order."""
        rows = [
            r for r in self._db.collection(self._collection).values()
            if r["tenant_id"] == tenant_id
            and r["document_id"] == document_id
        ]
        return sorted(rows, key=lambda r: r["offset"])

    def close(self) -> None:
        pass
