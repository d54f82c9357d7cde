"""Broadcaster: fan sequenced ops out to every connected front end.

JAX counterpart: ``fluidframework_tpu/service/broadcaster.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/broadcaster/lambda.ts:29-80 — batches sequenced ops per
"tenant/doc" topic and publishes to all front-end instances (Redis pub/sub
in production; in-proc PubSub here, memory-orderer/src/pubsub.ts:39).
"""

from __future__ import annotations

import time
from typing import Callable

from ..protocol.messages import TraceHop
from ..utils.telemetry import (
    HOP_FANOUT,
    HOP_SERVICE_ACTION,
    SPANS,
    span_of,
    tracing,
)
from .core import QueuedMessage


#: the span a session's broadcast deliveries run under: callbacks bound
#: to an object whose class names it as its ``SPAN``
#: (``ServerConnection._deliver_ops``)
SESSION = "session"
SESSION_SPAN = SPANS.name_id(SESSION)


class PubSub:
    """Topic → subscriber callbacks (ref: memory-orderer pubsub.ts).

    While ``tracing()``, the sessions' callbacks of one publish run in
    one ``session`` span row: its time sums theirs, its calls count
    them."""

    def __init__(self):
        # topic → its callbacks, and whether each is a session's. Both
        # lists are replaced, never changed in place, so a publish walks
        # the lists it found without copying them: a callback that
        # subscribes or unsubscribes takes effect from the next publish
        self._subs: dict[str, list[Callable]] = {}
        self._sessions: dict[str, list[bool]] = {}

    def subscribe(self, topic: str, cb: Callable) -> None:
        self._subs[topic] = self._subs.get(topic, []) + [cb]
        self._sessions[topic] = (self._sessions.get(topic, [])
                                 + [span_of(cb) == SESSION])

    def unsubscribe(self, topic: str, cb: Callable) -> None:
        subs = self._subs.get(topic, [])
        if cb in subs:
            i = subs.index(cb)
            self._subs[topic] = subs[:i] + subs[i + 1:]
            sessions = self._sessions[topic]
            self._sessions[topic] = sessions[:i] + sessions[i + 1:]

    def publish(self, topic: str, *args) -> None:
        if tracing():
            self._publish_traced(topic, args)
            return
        for cb in self._subs.get(topic, ()):
            cb(*args)

    def _publish_traced(self, topic: str, args: tuple) -> None:
        """``publish`` with the session span running around each
        session's callback and paused around the others."""
        frame = None  # this publish's session span
        running = False  # whether it runs now
        calls = 0
        try:
            for cb, session in zip(self._subs.get(topic, ()),
                                   self._sessions.get(topic, ())):
                if session and not running:
                    if frame is None:
                        # None: folded into a running session span
                        frame = SPANS.begin(SESSION_SPAN)
                    else:
                        SPANS.resume(frame)
                    running = frame is not None
                elif running and not session:
                    SPANS.pause(frame)
                    running = False
                if running:
                    calls += 1
                cb(*args)
        finally:
            if running:
                SPANS.pause(frame)
            if frame is not None:
                SPANS.close(frame, calls)


class BroadcasterLambda:
    """Relays sequenced messages to the doc's pub/sub topic in batches.

    The op-topic contract is ``callback(list[SequencedDocumentMessage])``
    — the reference broadcaster likewise accumulates per-doc batches
    before publishing (lambda.ts:29-80), which is what keeps fan-out cost
    per-batch instead of per-op at high throughput.
    """

    #: chaos seam (duck-typed fault plane): dropped / repeated
    #: broadcast faults. Class-level because orderers construct their
    #: broadcaster lazily; None = disarmed, one branch per batch.
    fault_plane = None
    #: the span its log deliveries run under (local_log.handler_span)
    SPAN = "broadcaster"

    def __init__(self, pubsub: PubSub):
        self._pubsub = pubsub
        # (tenant, doc, topic) of the last envelope: a pipeline's
        # broadcaster serves one doc, so its topic is built once
        self._last = (None, None, None)

    @staticmethod
    def topic(tenant_id: str, document_id: str) -> str:
        return f"{tenant_id}/{document_id}"

    def handler(self, message: QueuedMessage) -> None:
        envelope = message.value  # {..., "message"|"boxcar"|"abatch"}
        batch = envelope.get("abatch")  # array lane: published AS-IS —
        # array-aware subscribers consume it raw, legacy ones receive
        # its lazily-materialized messages (local_server._deliver_ops)
        if batch is None:
            batch = envelope.get("boxcar")
        if batch is None:
            batch = [envelope["message"]]
        self._stamp_fanout(batch)
        tenant_id = envelope["tenant_id"]
        document_id = envelope["document_id"]
        last_tenant, last_doc, topic = self._last
        if tenant_id != last_tenant or document_id != last_doc:
            topic = self.topic(tenant_id, document_id)
            self._last = (tenant_id, document_id, topic)
        if self.fault_plane is not None:
            directive = self.fault_plane("broadcast.publish", topic=topic)
            if directive == "drop":
                # a lost pub/sub delivery: clients recover through the
                # delta-storage gap repair when the next op arrives (or
                # the settle-phase catch-up)
                return
            if directive == "dup":
                # a repeated delivery (pub/sub redelivers after a
                # timeout): clients dedupe by sequence number
                self._pubsub.publish(topic, batch)
        self._pubsub.publish(topic, batch)

    @staticmethod
    def _stamp_fanout(batch) -> None:
        """Stamp broadcast/fanout on SAMPLED traffic only.

        Array batches carry the accumulated hoptail on the boxcar
        (appended in place — the egress encode packs it); rec batches
        carry per-message TraceHop lists, stamped only where a hop
        list already exists (the client's sampling decision rides the
        presence of traces). Unsampled traffic takes one branch here.
        """
        if type(batch) is not list:  # a SequencedArrayBatch
            hops = batch.boxcar.hops
            if hops is not None:
                hops.append((HOP_FANOUT, time.time()))
            return
        svc, act = HOP_SERVICE_ACTION[HOP_FANOUT]
        for msg in batch:
            traces = getattr(msg, "traces", None)
            if traces:
                traces.append(
                    TraceHop(service=svc, action=act,
                             timestamp=time.time()))
