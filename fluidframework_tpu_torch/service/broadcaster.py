"""Broadcaster: fan sequenced ops out to every connected front end.

JAX counterpart: ``fluidframework_tpu/service/broadcaster.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/broadcaster/lambda.ts:29-80 — batches sequenced ops per
"tenant/doc" topic and publishes to all front-end instances (Redis pub/sub
in production; in-proc PubSub here, memory-orderer/src/pubsub.ts:39).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable

from ..protocol.messages import TraceHop
from ..utils.telemetry import HOP_FANOUT, HOP_SERVICE_ACTION
from .core import QueuedMessage


class PubSub:
    """Topic → subscriber callbacks (ref: memory-orderer pubsub.ts)."""

    def __init__(self):
        self._subs: dict[str, list[Callable]] = defaultdict(list)

    def subscribe(self, topic: str, cb: Callable) -> None:
        self._subs[topic].append(cb)

    def unsubscribe(self, topic: str, cb: Callable) -> None:
        if cb in self._subs.get(topic, []):
            self._subs[topic].remove(cb)

    def publish(self, topic: str, *args) -> None:
        for cb in list(self._subs.get(topic, [])):
            cb(*args)


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

    def __init__(self, pubsub: PubSub):
        self._pubsub = pubsub

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
        topic = self.topic(envelope["tenant_id"], envelope["document_id"])
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
        hops = getattr(getattr(batch, "boxcar", None), "hops", None)
        if hops is not None:
            hops.append((HOP_FANOUT, time.time()))
            return
        if isinstance(batch, list):
            svc, act = HOP_SERVICE_ACTION[HOP_FANOUT]
            for msg in batch:
                traces = getattr(msg, "traces", None)
                if traces:
                    traces.append(
                        TraceHop(service=svc, action=act,
                                 timestamp=time.time()))
