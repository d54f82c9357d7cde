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

from typing import Any, Callable, Optional

from ..utils.telemetry import SPANS, span_of, tracing
from .core import QueuedMessage

Handler = Callable[[QueuedMessage], None]


def handler_span(handler: Handler) -> Optional[int]:
    """The span id a subscriber's deliveries run under: its object's
    ``SPAN`` (deli, scriptorium, scribe, broadcaster), else None: the
    subscriber runs without a span."""
    name = span_of(handler)
    return None if name is None else SPANS.name_id(name)


class OrderedLogBase:
    #: chaos seam (duck-typed fault plane): when armed,
    #: append() consults it for torn-write / duplicate-delivery /
    #: replay-from-older-offset faults. None = disarmed, one branch.
    fault_plane = None

    def __init__(self):
        # topic → [(handler, [position], span id or None)]; a topic's
        # list is replaced, never changed in place, so a drain walks the
        # list it found without copying it
        self._subs: dict[str, list[tuple[Handler, list[int],
                                         Optional[int]]]] = {}
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
        for _, pos, _ in self._subs.get(topic, ()):
            pos[0] = max(0, pos[0] - n)
        if self._subs.get(topic):
            self._dirty[topic] = None

    def subscribe(self, topic: str, handler: Handler, from_offset: int = 0) -> None:
        self.create_topic(topic)
        self._subs[topic] = self._subs[topic] + [
            (handler, [from_offset], handler_span(handler))]
        self._dirty[topic] = None  # may need catch-up delivery

    def unsubscribe(self, topic: str, handler: Handler) -> None:
        subs = self._subs.get(topic, [])
        self._subs[topic] = [sub for sub in subs if sub[0] is not handler]

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
        While ``tracing()``, each delivery to a subscriber that names a
        span runs in it.

        A topic's visit delivers to the handlers subscribed when it
        began, in subscription order, each up to the stored length when
        its turn comes: the length is read once a visit and again only
        after something re-dirtied the topic (an append, a subscribe, a
        rewind). Handlers at the same record share one message.
        """
        traced = tracing()
        dirty = self._dirty
        subs_of = self._subs.get
        length = self._stored_length
        load = self._load
        delivered = 0
        while dirty:
            topic = next(iter(dirty))
            del dirty[topic]
            subs = subs_of(topic)
            if not subs:
                continue
            msg = None
            # handlers may subscribe/unsubscribe and append (re-dirtying
            # this or other topics); the outer loop reaches the fixed point
            try:
                n = length(topic)
                for handler, pos, span in subs:
                    if not traced:
                        span = None
                    while pos[0] < n:
                        offset = pos[0]
                        value = load(topic, offset)
                        if (msg is None or msg.offset != offset
                                or msg.value is not value):
                            msg = QueuedMessage(offset, topic, 0, value)
                        pos[0] = offset + 1
                        if span is None:
                            handler(msg)
                        else:
                            frame = SPANS.begin(span)
                            try:
                                handler(msg)
                            finally:
                                if frame is not None:
                                    SPANS.end(frame)
                        delivered += 1
                    if topic in dirty:
                        n = length(topic)
            except Exception:
                # a raising handler must not strand the topic's remaining
                # records: re-dirty so the next drain() retries
                dirty[topic] = None
                raise
        return delivered

    def step(self, topic: str) -> bool:
        """Deliver exactly ONE pending message on ``topic`` to each lagging
        subscriber — the deterministic single-step used by interleaving
        tests. Returns False when the topic is fully drained."""
        n = self._stored_length(topic)
        any_delivered = False
        traced = tracing()
        for handler, pos, span in self._subs.get(topic, []):
            if pos[0] < n:
                msg = QueuedMessage(offset=pos[0], topic=topic, partition=0,
                                    value=self._load(topic, pos[0]))
                pos[0] += 1
                frame = SPANS.begin(span) if traced and span is not None \
                    else None
                try:
                    handler(msg)
                finally:
                    if frame is not None:
                        SPANS.end(frame)
                any_delivered = True
        return any_delivered


class LocalLog(OrderedLogBase):
    """In-memory ordered log (the LocalKafka analog)."""

    def __init__(self):
        super().__init__()
        self._topics: dict[str, list[Any]] = {}

    def _store(self, topic: str, value: Any) -> int:
        records = self._topics.get(topic)
        if records is None:
            records = self._topics[topic] = []
        records.append(value)
        return len(records) - 1

    def _load(self, topic: str, offset: int) -> Any:
        return self._topics[topic][offset]

    def _stored_length(self, topic: str) -> int:
        records = self._topics.get(topic)
        return 0 if records is None else len(records)
