"""Service plugin surface: every concrete stage implements these.

JAX counterpart: ``fluidframework_tpu/service/core.py``; the port's copy,
imports rebased to this package.

Ref: server/routerlicious/packages/services-core — IPartitionLambda /
IPartitionLambdaFactory (lambdas.ts:36,52), IProducer/IConsumer with boxcar
batching (messages.ts), ICollection (db.ts), ICheckpointManager. Stages are
pure functions of (checkpoint state, ordered message stream); the host owns
offsets and restart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Protocol


@dataclass
class QueuedMessage:
    """A message with its position in an ordered log partition."""

    offset: int
    topic: str
    partition: int
    value: Any


class LambdaContext:
    """Host services handed to a lambda: checkpointing + error escalation.

    Ref: IContext (services-core/src/lambdas.ts): ``checkpoint(offset)``
    records progress; ``error(err, restart)`` asks the host to restart the
    partition from the last checkpoint.
    """

    def __init__(
        self,
        checkpoint_fn: Callable[[int], None],
        error_fn: Optional[Callable[[Exception, bool], None]] = None,
    ):
        self._checkpoint = checkpoint_fn
        self._error = error_fn
        self.checkpointed_offset: int = -1

    def checkpoint(self, offset: int) -> None:
        self.checkpointed_offset = offset
        self._checkpoint(offset)

    def error(self, err: Exception, restart: bool = True) -> None:
        if self._error:
            self._error(err, restart)
        else:
            raise err


class Lambda(Protocol):
    """One pipeline stage (ref: IPartitionLambda.handler)."""

    def handler(self, message: QueuedMessage) -> None: ...

    def close(self) -> None: ...


class CheckpointManager:
    """Tracks the lowest contiguous processed offset per partition.

    Ref: kafka-service/checkpointManager.ts — offsets
    commit monotonically; on restart the partition replays from the last
    committed offset and lambdas skip already-applied messages by offset.
    """

    def __init__(self):
        self._offsets: dict[tuple[str, int], int] = {}

    def checkpoint(self, topic: str, partition: int, offset: int) -> None:
        key = (topic, partition)
        if offset > self._offsets.get(key, -1):
            self._offsets[key] = offset

    def get(self, topic: str, partition: int) -> int:
        return self._offsets.get((topic, partition), -1)


def summary_versions_collection(tenant_id: str, document_id: str) -> str:
    """Db collection holding a document's summary version chain — shared
    by the storage client (upload) and scribe (validation/commit)."""
    return f"summary-versions/{tenant_id}/{document_id}"


@dataclass
class InMemoryDb:
    """Dict-of-collections store (the Mongo stand-in for tests).

    Ref: server/routerlicious/packages/test-utils testDbFactory /
    tinylicious inMemorycollection.ts. Collections hold dict documents keyed
    by ``_id``; upsert semantics match what deli/scribe checkpointing needs.
    """

    collections: dict[str, dict[str, dict]] = field(default_factory=dict)

    def collection(self, name: str) -> dict[str, dict]:
        return self.collections.setdefault(name, {})

    def upsert(self, name: str, _id: str, value: dict) -> None:
        self.collection(name)[_id] = dict(value, _id=_id)

    def find_one(self, name: str, _id: str) -> Optional[dict]:
        return self.collection(name).get(_id)

    def insert(self, name: str, _id: str, value: dict) -> None:
        col = self.collection(name)
        if _id in col:
            raise KeyError(f"duplicate _id {_id} in {name}")
        col[_id] = dict(value, _id=_id)

    def find_range(
        self, name: str, key_fn: Callable[[dict], int], lo: int, hi: int
    ) -> list[dict]:
        """All docs with lo <= key < hi, sorted by key (delta backfill)."""
        docs = [d for d in self.collection(name).values() if lo <= key_fn(d) < hi]
        return sorted(docs, key=key_fn)
