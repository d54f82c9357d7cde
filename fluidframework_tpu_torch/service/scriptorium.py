"""Scriptorium: durable sequenced-op store for backfill.

JAX counterpart: ``fluidframework_tpu/service/scriptorium.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/scriptorium/lambda.ts:16-48 — inserts each sequenced op
into the per-document ``deltas`` collection, the source for the REST
delta-backfill path new/reconnecting clients use to catch up
(alfred /deltas → DeltaManager.getDeltas, deltaManager.ts:647).
"""

from __future__ import annotations

from dataclasses import replace

from ..protocol.messages import MessageType, SequencedDocumentMessage
from .core import InMemoryDb, QueuedMessage


class LogTruncatedError(RuntimeError):
    """The requested range starts below the retention base: the caller's
    head predates the truncated prefix and it must reload from the
    latest acked summary instead of backfilling op-by-op."""

    def __init__(self, base: int, snapshot_seq=None):
        super().__init__(
            f"op log truncated below seq {base}: reload from the latest "
            "acked summary")
        self.base = base
        # capture seq of the acked summary that heals this hole: retention
        # clamps its trim to this, so it is always ≥ base when set
        self.snapshot_seq = snapshot_seq


class ScriptoriumLambda:
    """Stores each doc's sequenced stream as ONE db document holding the
    seq-ordered list (``log[i]`` is seq ``i+1+base`` — the sequencer
    assigns dense seqs from 1, so list position IS the index, offset by
    the truncation ``base``). Appends are O(batch) and range reads are
    slices; the round-2 per-op keyed upserts were a measurable slice of
    the service hot path.

    Retention: once a summary is ACKED at seq N, ops ≤ N are only needed
    by replicas that already hold them — new boots use the summary + the
    tail. ``truncate_below`` drops the covered prefix (keeping a safety
    margin for in-flight backfills); a client disconnected past the
    retained window must reload from the summary, the same contract as
    the reference's deli ClearCache + summary-based catch-up."""

    def __init__(self, db: InMemoryDb):
        self._db = db

    @staticmethod
    def collection(tenant_id: str, document_id: str) -> str:
        return f"deltas/{tenant_id}/{document_id}"

    def _doc(self, name: str) -> dict:
        col = self._db.collection(name)
        doc = col.get("log")
        if doc is None:
            doc = col["log"] = {"_id": "log", "messages": [], "base": 0}
        return doc

    def _log(self, name: str) -> list:
        return self._doc(name)["messages"]

    def handler(self, message: QueuedMessage) -> None:
        envelope = message.value
        name = self.collection(envelope["tenant_id"], envelope["document_id"])
        doc = self._doc(name)
        log = doc["messages"]
        # dense invariant: log[i] holds seq base+i+1, so the last stored
        # seq is positional (entries may be per-op messages OR a shared
        # SequencedArrayBatch object occupying its n positions)
        last = doc.get("base", 0) + len(log)
        abatch = envelope.get("abatch")
        if abatch is not None:
            first, n = abatch.base_seq, abatch.n
            if not log and last == 0 and first > 1:
                # fork adoption: a forked doc's deltas topic begins at its
                # fork base + 1, not 1 — the topic's first record defines
                # the base (normal docs always open at seq 1), otherwise a
                # durable-log replay would rebuild the tail at positions
                # that violate the dense invariant
                last = doc["base"] = first - 1
            if first == last + 1:  # hot path: ONE list-repeat, no per-op
                log.extend([abatch] * n)
            elif first + n - 1 > last:
                log.extend([abatch] * (first + n - 1 - last))
            return
        batch = envelope.get("boxcar")
        if batch is None:
            batch = [envelope["message"]]
        first = batch[0].sequence_number
        if not log and last == 0 and first > 1:
            # fork adoption (see the abatch branch above)
            last = doc["base"] = first - 1
        if first == last + 1:  # the hot path: append in arrival order
            log.extend(batch)
            return
        # replay overlap (deli crash-replay re-emits ticketed seqs at new
        # offsets): keep only the unseen tail — idempotent by seq
        for msg in batch:
            if msg.sequence_number > last:
                log.append(msg)
                last = msg.sequence_number

    def close(self) -> None:
        pass

    def truncate_below(self, tenant_id: str, document_id: str,
                       seq: int) -> int:
        """Drop retained ops with sequence_number ≤ seq; returns how many
        were dropped. Callers pass (acked summary seq − retention).

        The base RAISES even past the held range (or on an empty store):
        a checkpoint restore declares the prefix gone BEFORE the durable
        deltas-topic replay re-delivers it, and the append path then
        drops everything at or below the declared base."""
        doc = self._doc(self.collection(tenant_id, document_id))
        base = doc.get("base", 0)
        if seq <= base:
            return 0
        drop = min(seq - base, len(doc["messages"]))
        del doc["messages"][:drop]
        doc["base"] = seq
        return drop

    def retained_base(self, tenant_id: str, document_id: str) -> int:
        """Seqs ≤ base are no longer served (summary-covered)."""
        return self._doc(self.collection(tenant_id, document_id)) \
            .get("base", 0)

    def head_seq(self, tenant_id: str, document_id: str) -> int:
        """Highest stored seq (== base on an empty/trimmed store)."""
        doc = self._doc(self.collection(tenant_id, document_id))
        return doc.get("base", 0) + len(doc["messages"])

    def get_deltas(
        self, tenant_id: str, document_id: str, from_seq: int, to_seq: int
    ) -> list[SequencedDocumentMessage]:
        """Ops with from_seq < seq < to_seq (exclusive bounds, matching the
        reference's /deltas REST contract). A request reaching below the
        retention base raises :class:`LogTruncatedError` — silently
        omitting the dropped prefix would stall the caller forever on a
        gap that can never fill."""
        doc = self._doc(self.collection(tenant_id, document_id))
        base = doc.get("base", 0)
        if from_seq < base:
            raise LogTruncatedError(base)
        log = doc["messages"]
        lo = max(from_seq - base, 0)
        hi = min(to_seq - 1 - base, len(log))
        if hi <= lo:
            return []
        out = []
        i = lo
        while i < hi:
            entry = log[i]
            if isinstance(entry, SequencedDocumentMessage):
                out.append(entry)
                i += 1
                continue
            # a SequencedArrayBatch occupies its n seq positions: slice
            # ONE cached messages() list across the whole in-range run
            # instead of materializing position by position
            start = base + i + 1 - entry.base_seq
            stop = min(entry.n, start + (hi - i))
            out.extend(entry.messages()[start:stop])
            i += stop - start
        return out


def channel_stream(server, tenant_id: str, document_id: str,
                   ds_id: str, channel_id: str, from_seq: int = 0):
    """Extract one channel's merge-tree messages from the document's
    sequenced op log (scriptorium) — the applier's replay source and the
    scribe-replay entry point.

    Truncated logs raise (scriptorium.LogTruncatedError): with log
    retention active, a from-zero replay would silently rebuild WRONG
    state once ops behind an acked summary have been dropped. Reads go
    straight through a stateless ScriptoriumLambda over the db so
    inspecting a doc never lazily constructs its whole pipeline.

    The JAX package keeps it in ``service/tpu_applier.py``; the port
    keeps it here, in a module that imports no torch, so that a core's
    summary path (``HostReplicaSource``) does not import torch on its
    event loop (``gpu_applier`` re-exports it).
    """
    for m in ScriptoriumLambda(server.db).get_deltas(
            tenant_id, document_id, from_seq, 10**9):
        if m.type != MessageType.OPERATION:
            continue
        env = m.contents
        if not isinstance(env, dict) or env.get("kind") != "chanop":
            continue
        if env["address"] != ds_id:
            continue
        inner = env["contents"]
        if inner.get("address") != channel_id or "attach" in inner:
            continue
        yield replace(m, contents=inner["contents"])
