"""Presence lane: the ephemeral signal tier.

JAX counterpart: ``fluidframework_tpu/service/presence.py``; the port's
copy, imports rebased to this package.

Ref: the reference relays every signal through the same socket.io
broadcast machinery as ops (alfred io.ts submitSignal); at read scale
that makes 100k cursor moves 100k broadcast fan-outs. Here signals are
promoted to a first-class ephemeral tier: per-(doc, client, type)
last-writer-wins coalescing server-side, a flush tick, and batched
FT-framed delivery — presence never touches deli, never hits the
durable log, and a burst of cursor moves from one client collapses to
ONE entry per flush window.

The lane is owned by a NetworkFrontEnd (and by a relay Gateway for its
local fan-out): ``publish`` is called on signal ingress, ``flush`` on
the front's presence tick. Delivery is subscriber-shaped: the front
registers one callback per watching session (or per downstream gateway
link), and each callback picks its wire form off a shared
:class:`PresenceBatch` whose encodings are computed AT MOST ONCE per
flush per topic — binary clients share one FT_PRESENCE frame, backbone
links share one FT_FPRESENCE frame, legacy JSON sessions share one
dict list.

Ordering contract: the flush tick runs on the same loop that pushes
sequenced op batches, strictly after any op delivery already queued —
a signal submitted after an op can never overtake that op's broadcast.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..protocol import binwire
from ..protocol.messages import Signal
from ..protocol.serialization import message_to_dict
from ..utils.telemetry import Counters
from ..utils.affinity import loop_only

#: default flush tick — one frame per watcher per window, however many
#: cursor moves arrived inside it
FLUSH_INTERVAL_S = 0.02


class PresenceBatch:
    """One topic's coalesced signals for one flush, with every wire
    form lazily encoded exactly once no matter how many subscribers
    pull it."""

    __slots__ = ("topic", "signals", "_pframe", "_fframe", "_dicts")

    def __init__(self, topic: str, signals: list[Signal]):
        self.topic = topic
        self.signals = signals
        self._pframe: Optional[bytes] = None
        self._fframe: Optional[bytes] = None
        self._dicts: Optional[list] = None

    def presence_frame(self) -> bytes:
        """Framed FT_PRESENCE (client form) — shared by every binary
        direct subscriber."""
        if self._pframe is None:
            self._pframe = binwire.frame(
                binwire.encode_presence(self.signals))
        return self._pframe

    def fpresence_frame(self) -> bytes:
        """Framed FT_FPRESENCE (backbone form, topic prefix) — shared
        by every downstream gateway link; a relay strips the topic with
        a byte splice, never re-encoding."""
        if self._fframe is None:
            self._fframe = binwire.frame(
                binwire.encode_presence(self.signals, topic=self.topic))
        return self._fframe

    def signal_dicts(self) -> list:
        """Legacy JSON form for non-binary sessions."""
        if self._dicts is None:
            self._dicts = [message_to_dict(s) for s in self.signals]
        return self._dicts


class PresenceLane:
    """LWW-coalescing store + subscriber registry for one serving tier.

    Single-threaded by construction: publish and flush both run on the
    owning tier's event loop, so no locking is needed (or wanted — this
    is the hot path of a 100k-viewer doc)."""

    def __init__(self, counters: Counters,
                 flush_interval: float = FLUSH_INTERVAL_S):
        self.counters = counters
        self.flush_interval = flush_interval
        # topic -> {(client_id, type): Signal} — insertion order is
        # arrival order of the winning writes, preserved into the batch
        self._store: dict[str, dict] = {}
        self._subs: dict[str, list] = {}

    # --------------------------------------------------------- ingress

    @loop_only("core")
    def publish(self, topic: str, signal: Signal) -> None:
        self.counters.inc("presence.lane.signals")
        bucket = self._store.setdefault(topic, {})
        key = (signal.client_id, signal.type)
        if key in bucket:
            # the whole point: a later cursor move REPLACES the
            # unflushed one — loss of an intermediate is invisible
            self.counters.inc("presence.lane.coalesced")
        bucket[key] = signal

    # ----------------------------------------------------- subscribers

    def subscribe(self, topic: str,
                  fn: Callable[[PresenceBatch], None]) -> None:
        self._subs.setdefault(topic, []).append(fn)

    def unsubscribe(self, topic: str, fn) -> None:
        subs = self._subs.get(topic)
        if subs is None:
            return
        try:
            subs.remove(fn)
        except ValueError:
            return
        if not subs:
            del self._subs[topic]

    def watching(self, topic: str) -> bool:
        return bool(self._subs.get(topic))

    # ----------------------------------------------------------- flush

    @loop_only("core")
    def flush(self) -> int:
        """Drain every dirty topic to its subscribers; returns the
        number of subscriber deliveries."""
        if not self._store:
            return 0
        store, self._store = self._store, {}
        # counted before any byte leaves: a subscriber that sees this
        # flush's batch finds it counted
        self.counters.inc("presence.lane.flushes")
        delivered = 0
        for topic, bucket in store.items():
            subs = self._subs.get(topic)
            if not subs:
                continue  # nobody watches this doc: presence evaporates
            batch = PresenceBatch(topic, list(bucket.values()))
            for fn in list(subs):
                try:
                    fn(batch)
                    delivered += 1
                except Exception:
                    pass  # a dying session must not poison the tick
        if delivered:
            self.counters.inc("presence.lane.delivered", delivered)
        return delivered
