"""Ordered log: topics + subscriber fan-out, with pluggable storage.

JAX counterpart: ``fluidframework_tpu/service/local_log.py``; the port's copy,
imports rebased to this package.

Ref: memory-orderer/src/localKafka.ts — an append-only per-partition
message list with monotonically increasing offsets, drained synchronously
into subscribed lambdas. Deterministic drain order (topic registration
order, then offset order) is what makes multi-client interleaving tests
reproducible (the OpProcessingController property, SURVEY §4).

``OrderedLogBase`` owns the subtle parts once — subscriber positions,
fixed-point drain, single-step delivery — over three storage primitives:
``_store`` / ``_load`` / ``_stored_length``. ``LocalLog`` keeps records
in memory; ``service.durable_log.DurableLog`` persists them through the
native C++ op log.
"""

from __future__ import annotations

from typing import Any, Callable

from .core import QueuedMessage

Handler = Callable[[QueuedMessage], None]


class OrderedLogBase:
    #: chaos seam (duck-typed fault plane): when armed,
    #: append() consults it for torn-write / duplicate-delivery /
    #: replay-from-older-offset faults. None = disarmed, one branch.
    fault_plane = None

    def __init__(self):
        self._subs: dict[str, list[tuple[Handler, list[int]]]] = {}
        self._order: list[str] = []
        # topics that MAY have undelivered records (ordered set): drain is
        # O(pending work), not O(topics) — at thousands of docs the
        # scan-everything loop was the service hot spot
        self._dirty: dict[str, None] = {}

    # ------------------------------------------------- storage primitives

    def _store(self, topic: str, value: Any) -> int:
        """Append; returns the record's offset."""
        raise NotImplementedError

    def _load(self, topic: str, offset: int) -> Any:
        raise NotImplementedError

    def _stored_length(self, topic: str) -> int:
        raise NotImplementedError

    def _torn_append(self, topic: str, value: Any) -> int:
        """Chaos-plane torn-write semantics: the write never reached the
        medium (power cut mid append) — the producer believes it wrote,
        consumers never see it; recovery is the client resubmit path.
        Storage backends with a physical torn-tail representation
        (DurableLog's segment streams) override this to actually leave
        ragged bytes on disk and exercise the recovery scan."""
        return self._stored_length(topic)

    # ----------------------------------------------------------- topic api

    def create_topic(self, topic: str) -> None:
        if topic not in self._subs:
            self._subs[topic] = []
            self._order.append(topic)

    def append(self, topic: str, value: Any, partition: int = 0) -> int:
        self.create_topic(topic)
        if self.fault_plane is not None:
            directive = self.fault_plane("log.append", topic=topic,
                                         record=value)
            if directive == "torn":
                self._dirty[topic] = None
                return self._torn_append(topic, value)
            if directive == "dup":
                # the record lands twice (producer retry after a lost
                # ack) — consumers must dedupe (deli by clientSeq,
                # scriptorium by idempotent upsert, clients by seq)
                self._store(topic, value)
            elif directive == "rewind":
                # replay-from-older-offset: store normally, then drag
                # every subscriber back one record — redelivery of an
                # already-consumed window
                offset = self._store(topic, value)
                self._dirty[topic] = None
                self.rewind_subscribers(topic, 1)
                return offset
        offset = self._store(topic, value)
        self._dirty[topic] = None
        return offset

    def rewind_subscribers(self, topic: str, n: int = 1) -> None:
        """Move every subscriber position on ``topic`` back ``n``
        records: the next drain redelivers them (the at-least-once
        delivery mode every consumer must already tolerate)."""
        for _, pos in self._subs.get(topic, ()):
            pos[0] = max(0, pos[0] - n)
        if self._subs.get(topic):
            self._dirty[topic] = None

    def subscribe(self, topic: str, handler: Handler, from_offset: int = 0) -> None:
        self.create_topic(topic)
        self._subs[topic].append((handler, [from_offset]))
        self._dirty[topic] = None  # may need catch-up delivery

    def unsubscribe(self, topic: str, handler: Handler) -> None:
        subs = self._subs.get(topic, [])
        self._subs[topic] = [(h, p) for h, p in subs if h is not handler]

    def length(self, topic: str) -> int:
        return self._stored_length(topic)

    def first_offset_covering(self, topic: str, seq: int) -> int:
        """Lowest record offset that may hold sequence numbers ≥ ``seq``
        — where a lazy cold boot tails in. Storage without a seq index
        returns 0: the subscribers' own idempotent skip absorbs the
        prefix (correct, just not lazy)."""
        return 0

    def read(self, topic: str, offset: int) -> Any:
        return self._load(topic, offset)

    # ------------------------------------------------------------ delivery

    def drain(self) -> int:
        """Deliver pending messages to all subscribers until quiescent.

        Handlers may append more messages (deli → deltas topic); the loop
        runs to a fixed point. Returns the number of deliveries made.
        """
        delivered = 0
        while self._dirty:
            topic = next(iter(self._dirty))
            del self._dirty[topic]
            # handlers may subscribe/unsubscribe and append (re-dirtying
            # this or other topics); the outer loop reaches the fixed point
            try:
                for handler, pos in list(self._subs.get(topic, [])):
                    # snapshot the length once per handler pass: for the
                    # durable log it is a ctypes call, and re-querying
                    # per record made it ~4 calls/record on the hot
                    # path. Records a handler appends to THIS topic
                    # re-dirty it, so the fixed-point loop still
                    # delivers them.
                    n = self._stored_length(topic)
                    while pos[0] < n:
                        msg = QueuedMessage(
                            offset=pos[0], topic=topic, partition=0,
                            value=self._load(topic, pos[0]))
                        pos[0] += 1
                        handler(msg)
                        delivered += 1
            except Exception:
                # a raising handler must not strand the topic's remaining
                # records: re-dirty so the next drain() retries
                self._dirty[topic] = None
                raise
        return delivered

    def step(self, topic: str) -> bool:
        """Deliver exactly ONE pending message on ``topic`` to each lagging
        subscriber — the deterministic single-step used by interleaving
        tests. Returns False when the topic is fully drained."""
        n = self._stored_length(topic)
        any_delivered = False
        for handler, pos in self._subs.get(topic, []):
            if pos[0] < n:
                msg = QueuedMessage(offset=pos[0], topic=topic, partition=0,
                                    value=self._load(topic, pos[0]))
                pos[0] += 1
                handler(msg)
                any_delivered = True
        return any_delivered


class LocalLog(OrderedLogBase):
    """In-memory ordered log (the LocalKafka analog)."""

    def __init__(self):
        super().__init__()
        self._topics: dict[str, list[Any]] = {}

    def _store(self, topic: str, value: Any) -> int:
        records = self._topics.setdefault(topic, [])
        records.append(value)
        return len(records) - 1

    def _load(self, topic: str, offset: int) -> Any:
        return self._topics[topic][offset]

    def _stored_length(self, topic: str) -> int:
        return len(self._topics.get(topic, []))
