"""LocalOrderer: the REAL pipeline lambdas over the in-memory log.

JAX counterpart: ``fluidframework_tpu/service/local_orderer.py``; the
port's copy, imports rebased to this package. Lazy cold boot (and with it
the canary tenant's boot counters), the external scribe and the storage
process's ref hook are not ported yet (lazy boot ROADMAP A10, the scribe
stage and the storage process A9): the orderer always replays its topics
from the start, with scribe in-process.

Ref: memory-orderer/src/localOrderer.ts:88,228-270 — wires actual
Deli/Broadcaster/Scriptorium/Scribe instances over LocalKafka queues, so
every test exercises the same stage code the production sharded-log
deployment runs. One LocalOrderer per document (the document-router demux
is the topic-per-doc layout here).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..protocol.messages import Nack, SequencedDocumentMessage
from .broadcaster import BroadcasterLambda, PubSub
from .core import InMemoryDb, summary_versions_collection
from .deli import DeliCheckpoint, DeliLambda
from .local_log import LocalLog
from .scribe import SCRIBE_CHECKPOINT_COLLECTION, ScribeLambda
from .scriptorium import ScriptoriumLambda

CHECKPOINT_COLLECTION = "deli-checkpoints"


def _versions_topic(tenant_id: str, document_id: str) -> str:
    return f"versions/{tenant_id}/{document_id}"


def restore_version_records(log, db, tenant_id: str,
                            document_id: str) -> None:
    """Rebuild acked summary-version records from the durable versions
    topic. After full process death the db is gone, and without these the
    summary chain (and, with retention, the doc) is unreachable. An
    unreadable topic boots the doc without those records."""
    topic = _versions_topic(tenant_id, document_id)
    try:
        n = log.length(topic)
    except Exception:
        return
    if n <= 0:
        return
    col = summary_versions_collection(tenant_id, document_id)
    for i in range(n):
        rec = log.read(topic, i)
        if db.find_one(col, rec["handle"]) is None:
            db.upsert(col, rec["handle"], dict(rec["version"]))


def _checkpoint_topic(tenant_id: str, document_id: str) -> str:
    # per-doc topic: the newest checkpoint is simply the last record, and
    # old records compact trivially
    return f"checkpoints/{tenant_id}/{document_id}"


def _latest_log_checkpoint(log, tenant_id: str, document_id: str):
    """Newest checkpoint record for a doc from its checkpoint topic — the
    recovery source when the db died with the process. None when the
    topic is empty or unreadable."""
    topic = _checkpoint_topic(tenant_id, document_id)
    try:
        n = log.length(topic)
        return log.read(topic, n - 1) if n > 0 else None
    except Exception:
        return None


class LocalOrderer:
    def __init__(
        self,
        tenant_id: str,
        document_id: str,
        log: LocalLog,
        db: InMemoryDb,
        pubsub: PubSub,
        clock: Callable[[], float] = time.time,
        client_timeout: Optional[float] = None,
        logger=None,
        log_retention_ops: Optional[int] = None,
    ):
        self.tenant_id = tenant_id
        self.document_id = document_id
        self._log = log
        self._db = db
        self._pubsub = pubsub
        self.raw_topic = f"rawops/{tenant_id}/{document_id}"
        self.deltas_topic = f"deltas/{tenant_id}/{document_id}"
        # set before the lambdas exist: boot replay routes through the
        # same funnels (order/_on_sequenced) that mark the state dirty
        self._dirty = False

        # restore deli from its checkpoint if present (restart path, ref:
        # deli/lambdaFactory.ts:54). Two sources: the db (in-proc restart)
        # and the log's checkpoint topic (process restart with a durable
        # log, where the db died too) — prefer whichever is newer.
        cp_doc = db.find_one(CHECKPOINT_COLLECTION, f"{tenant_id}/{document_id}")
        checkpoint = DeliCheckpoint.from_dict(cp_doc["state"]) if cp_doc else None
        log_cp = _latest_log_checkpoint(log, tenant_id, document_id)
        scribe_log_cp = None
        if log_cp is not None:
            log_deli = DeliCheckpoint.from_dict(log_cp["deli"])
            if checkpoint is None or log_deli.log_offset > checkpoint.log_offset:
                checkpoint = log_deli
                scribe_log_cp = log_cp["scribe"]

        kw = {"clock": clock}
        if client_timeout is not None:
            kw["client_timeout"] = client_timeout
        if logger is not None:
            kw["logger"] = logger.child("deli")
        self.deli = DeliLambda(
            tenant_id,
            document_id,
            send_sequenced=self._on_sequenced,
            send_nack=self._on_nack,
            checkpoint=checkpoint,
            send_raw=self.order,
            send_sequenced_batch=self._on_sequenced_batch,
            **kw,
        )
        self.scriptorium = ScriptoriumLambda(db)
        self.broadcaster = BroadcasterLambda(pubsub)
        scribe_cp = db.find_one(
            SCRIBE_CHECKPOINT_COLLECTION, f"{tenant_id}/{document_id}")
        scribe_state = scribe_log_cp or (scribe_cp["state"] if scribe_cp else None)
        self._retention_margin = (
            log_retention_ops
            if log_retention_ops is not None and log_retention_ops >= 0
            else None)
        on_committed = (self.apply_retention
                        if self._retention_margin is not None else None)
        self.scribe = ScribeLambda(
            tenant_id,
            document_id,
            db,
            send_to_deli=self.order,
            checkpoint=scribe_state,
            on_summary_committed=on_committed,
            persist_version=self.persist_version_record,
        )
        restore_version_records(log, db, tenant_id, document_id)

        # deli replays the raw topic from 0 and self-skips via its
        # checkpointed log_offset (crash between append and ticket must
        # replay); scriptorium re-upserts idempotently; the broadcaster must
        # NOT replay history at live clients, so it joins at the tail.
        # Handler objects are kept for close(): bound-method attribute
        # access creates a fresh object each time, so unsubscribe needs the
        # exact references that were registered.
        self._subscriptions = [
            (self.raw_topic, self.deli.handler, 0),
            (self.deltas_topic, self.scriptorium.handler, 0),
            (self.deltas_topic, self.scribe.handler, 0),
            (self.deltas_topic, self.broadcaster.handler,
             log.length(self.deltas_topic)),
        ]
        for topic, handler, from_offset in self._subscriptions:
            self._log.subscribe(topic, handler, from_offset=from_offset)
        # re-apply the persisted retention AFTER the deltas-topic replay
        # rebuilt the full store (the replay itself is what un-truncated)
        if log_cp is not None and log_cp.get("scriptorium_base", 0) > 0:
            self.scriptorium.truncate_below(
                tenant_id, document_id, log_cp["scriptorium_base"])

    # the front end calls this (alfred's connection.order()); accepts a
    # single RawMessage or a RawBoxcar (one log record either way)
    def order(self, raw) -> None:
        self._dirty = True
        self._log.append(self.raw_topic, raw)

    def persist_version_record(self, handle: str, version: dict) -> None:
        """Append an acked version record to the durable versions topic —
        the scribe-ref commit path."""
        self._dirty = True
        self._log.append(_versions_topic(self.tenant_id, self.document_id),
                         {"handle": handle, "version": dict(version)})

    def acked_boot_seq(self) -> Optional[int]:
        """Capture seq of the version a joiner would boot from (latest
        acked by n) — None when no acked summary exists, or when the
        record predates capture-seq stamping."""
        col = summary_versions_collection(self.tenant_id, self.document_id)
        acked = [v for v in self._db.collection(col).values()
                 if v.get("acked")]
        if not acked:
            return None
        return max(acked, key=lambda v: v["n"]).get("seq")

    def apply_retention(self, capture_seq: int) -> None:
        """Truncate ops an acked summary covers, minus the in-flight
        backfill margin (config.log_retention_ops).

        The trim is CLAMPED to the boot version's capture seq: the ack
        chain orders by parent handle, not by seq, so a later-acked
        summary can capture an earlier seq than its predecessor — trimming
        to the raw commit head would then open a log_truncated hole below
        the only snapshot that heals it. No acked summary ⇒ no trim at
        all (a joiner would have nothing but full replay)."""
        if self._retention_margin is None:
            return
        boot_seq = self.acked_boot_seq()
        if boot_seq is None:
            return
        self._dirty = True  # the retained base rides the next checkpoint
        self.scriptorium.truncate_below(
            self.tenant_id, self.document_id,
            min(capture_seq, boot_seq) - self._retention_margin)

    def close(self) -> None:
        """Detach from the log (partition shutdown); a successor orderer
        resumes from the db checkpoint."""
        for topic, handler, _ in self._subscriptions:
            self._log.unsubscribe(topic, handler)

    def checkpoint(self) -> None:
        """Persist deli + scribe state (ref: deli checkpointContext.ts,
        scribe checkpointManager.ts → Mongo) — to the db and, so a durable
        log can recover it after full process death, to the log too. The
        scriptorium retention base rides along: without it a restart
        would rebuild the full delta store from the durable deltas topic
        and silently undo the truncation. Clean pipelines skip the write
        (re-writing state identical to the last checkpoint is a no-op)."""
        if not self._dirty:
            return
        deli_state = self.deli.checkpoint().to_dict()
        scribe_state = self.scribe.checkpoint_state()
        key = f"{self.tenant_id}/{self.document_id}"
        self._db.upsert(CHECKPOINT_COLLECTION, key, {"state": deli_state})
        self._db.upsert(SCRIBE_CHECKPOINT_COLLECTION, key, {"state": scribe_state})
        self._log.append(
            _checkpoint_topic(self.tenant_id, self.document_id),
            {"deli": deli_state, "scribe": scribe_state,
             "scriptorium_base": self.scriptorium.retained_base(
                 self.tenant_id, self.document_id)},
        )
        self._dirty = False

    def _on_sequenced(self, msg: SequencedDocumentMessage) -> None:
        self._dirty = True
        self._log.append(
            self.deltas_topic,
            {
                "tenant_id": self.tenant_id,
                "document_id": self.document_id,
                "message": msg,
            },
        )

    def _on_sequenced_batch(self, msgs) -> None:
        """A ticketed boxcar rides the deltas topic as one record, so the
        downstream stages (scriptorium/scribe/broadcaster) batch too.
        The array lane hands a SequencedArrayBatch (no per-op objects);
        the dict lane a list of SequencedDocumentMessage."""
        self._dirty = True
        key = "boxcar" if type(msgs) is list else "abatch"
        self._log.append(self.deltas_topic, {
            "tenant_id": self.tenant_id,
            "document_id": self.document_id,
            key: msgs,
        })

    def _on_nack(self, client_id: str, nack: Nack) -> None:
        self._pubsub.publish(f"nack/{self.tenant_id}/{self.document_id}/{client_id}", nack)
