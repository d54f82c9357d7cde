"""Deli: the per-document sequencer — THE hot loop of the service.

JAX counterpart: ``fluidframework_tpu/service/deli.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/deli/lambda.ts (handler :171 → ticket :253). For each raw
client message: validate (dup/gap on clientSeq, stale refSeq vs msn),
assign ``sequenceNumber++``, recompute the document-wide
``minimumSequenceNumber`` as the min reference seq over connected clients
(clientSeqManager.ts), stamp a trace hop, and emit the sequenced op.
Idle clients are expired (5 min default, lambdaFactory.ts:29) so the msn
can advance past dead clients; state checkpoints as
``(log_offset, sequence_number, clients)`` (checkpointContext.ts:49) and
restart replays the log from the checkpoint, skipping already-ticketed
offsets (lambda.ts:173).

Two lanes share the same per-document state:

- ``_ticket`` — the scalar semantic reference, one raw message at a time.
- ``_ticket_boxcar`` — the batched fast lane (the "deli-tpu" marshal of
  the north star): a client's submitted batch rides the raw log as ONE
  :class:`RawBoxcar` record (ref: IBoxcarMessage,
  services-core/src/messages.ts) and is ticketed in one pass with the
  clientSeq/refSeq/msn rules vectorized over the boxcar (numpy). The fast
  lane emits byte-identical sequenced messages to the scalar lane
  (tests/test_deli_boxcar.py fuzzes the equivalence) and falls back to
  the scalar lane per-op whenever a precondition fails (dup/gap, stale
  ref, non-op message types, unjoined client).
"""

from __future__ import annotations

import time
from bisect import bisect_left
from dataclasses import dataclass, field
from operator import attrgetter
from typing import Any, Callable, Optional

import numpy as np

from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    Nack,
    NackErrorType,
    SequencedDocumentMessage,
    TraceHop,
)
from ..utils.telemetry import HOP_DELI, SPANS, tracing
from .array_batch import ArrayBoxcar, SequencedArrayBatch
from .core import QueuedMessage

DEFAULT_CLIENT_TIMEOUT = 5 * 60.0  # ref: ClientSequenceTimeout, 5 minutes

#: array boxcars ticketed on the fast lane / sent to the scalar lane,
#: counted into ``SPANS`` while tracing (``boxcars_fast`` and
#: ``boxcars_fallback`` count every lane, always)
COUNT_ARRAY_FAST = "deli.array.fast"
COUNT_ARRAY_FALLBACK = "deli.array.fallback"

_REF_SEQ = attrgetter("reference_sequence_number")


@dataclass
class RawMessage:
    """Alfred → deli envelope (ref: core RawOperationMessage)."""

    tenant_id: str
    document_id: str
    client_id: Optional[str]  # None for server/system-generated messages
    operation: DocumentMessage
    timestamp: float = 0.0


def _raw_to_dict(raw: RawMessage) -> dict:
    from ..protocol.serialization import message_to_dict

    return {
        "tenant_id": raw.tenant_id,
        "document_id": raw.document_id,
        "client_id": raw.client_id,
        "operation": message_to_dict(raw.operation),
        "timestamp": raw.timestamp,
    }


def _raw_from_dict(d: dict) -> RawMessage:
    from ..protocol.serialization import message_from_dict

    return RawMessage(
        tenant_id=d["tenant_id"],
        document_id=d["document_id"],
        client_id=d["client_id"],
        operation=message_from_dict(d["operation"]),
        timestamp=d["timestamp"],
    )


@dataclass
class RawBoxcar:
    """One client's submitted batch as a single raw-log record.

    Ref: IBoxcarMessage (services-core/src/messages.ts) — the Kafka
    producer coalesces a connection's messages into one partition record;
    deli unwraps and tickets them in order. Durability/replay semantics are
    identical to per-op records: the boxcar occupies one log offset, and
    deli's ``log_offset`` checkpoint skips already-ticketed boxcars whole.
    """

    tenant_id: str
    document_id: str
    client_id: str
    ops: list[DocumentMessage]
    timestamp: float = 0.0


def _boxcar_to_dict(box: RawBoxcar) -> dict:
    from ..protocol.serialization import message_to_dict

    return {
        "tenant_id": box.tenant_id,
        "document_id": box.document_id,
        "client_id": box.client_id,
        "ops": [message_to_dict(op) for op in box.ops],
        "timestamp": box.timestamp,
    }


def _boxcar_from_dict(d: dict) -> RawBoxcar:
    from ..protocol.serialization import message_from_dict

    return RawBoxcar(
        tenant_id=d["tenant_id"],
        document_id=d["document_id"],
        client_id=d["client_id"],
        ops=[message_from_dict(op) for op in d["ops"]],
        timestamp=d["timestamp"],
    )


def _register_raw_codec() -> None:
    from ..protocol.serialization import register_message_type

    register_message_type("raw", RawMessage, _raw_to_dict, _raw_from_dict)
    register_message_type("rawbox", RawBoxcar, _boxcar_to_dict, _boxcar_from_dict)


_register_raw_codec()


@dataclass
class ClientState:
    """Per-client sequencing state (ref: deli/clientSeqManager.ts)."""

    client_id: str
    client_sequence_number: int = 0
    reference_sequence_number: int = 0
    last_update: float = 0.0
    can_evict: bool = True  # summarizer/system clients are not evicted
    detail: Any = None


@dataclass
class DeliCheckpoint:
    """Restartable state (ref: deli/checkpointContext.ts:49-92)."""

    log_offset: int = -1
    sequence_number: int = 0
    clients: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "log_offset": self.log_offset,
            "sequence_number": self.sequence_number,
            "clients": self.clients,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DeliCheckpoint":
        return cls(d["log_offset"], d["sequence_number"], list(d["clients"]))


class DeliLambda:
    """Sequencer for ONE document (the document-router demuxes per doc)."""

    #: the span its log deliveries run under (local_log.handler_span)
    SPAN = "deli"

    def __init__(
        self,
        tenant_id: str,
        document_id: str,
        send_sequenced: Callable[[SequencedDocumentMessage], None],
        send_nack: Callable[[str, Nack], None],
        checkpoint: Optional[DeliCheckpoint] = None,
        client_timeout: float = DEFAULT_CLIENT_TIMEOUT,
        clock: Callable[[], float] = time.time,
        send_raw: Optional[Callable[["RawMessage"], None]] = None,
        send_sequenced_batch: Optional[
            Callable[[list[SequencedDocumentMessage]], None]
        ] = None,
        logger=None,
    ):
        self.tenant_id = tenant_id
        self.document_id = document_id
        # telemetry on exceptional paths only (nacks, evictions) — the
        # ticket hot loop stays logging-free
        self._log = logger
        self._send = send_sequenced
        self._send_batch = send_sequenced_batch
        self._nack = self._nack_logged(send_nack)
        # deli → raw-topic backchannel (ref: deli sendToAlfred :631) for
        # control messages that must be ticketed deterministically on
        # crash replay (idle-eviction leaves)
        self._send_raw = send_raw
        self._clock = clock
        self._client_timeout = client_timeout
        cp = checkpoint or DeliCheckpoint()
        self.sequence_number = cp.sequence_number
        self.log_offset = cp.log_offset
        # fast-lane accounting (bench asserts the hot path stayed hot)
        self.boxcars_fast = 0
        self.boxcars_fallback = 0
        self.noops_consolidated = 0
        # clients whose idle-eviction leave is already riding the raw log
        # (re-emitting every check would bloat the log with duplicates
        # that replay forever after restarts)
        self._pending_leaves: set[str] = set()
        self.clients: dict[str, ClientState] = {
            c["client_id"]: ClientState(**c) for c in cp.clients
        }

    # ------------------------------------------------------------------ api

    #: placement fence (placement_plane): a callable returning the CURRENT
    #: routing-table epoch when this partition's claim is stale (another
    #: core claimed a newer epoch), else None. Checked on EVERY record —
    #: a fenced deli must never sequence, even with buffered raw records.
    epoch_fence = None

    def handler(self, message: QueuedMessage) -> None:
        # idempotent replay after restart (ref: deli/lambda.ts:173)
        if message.offset <= self.log_offset:
            return
        fence = self.epoch_fence
        if fence is not None:
            current = fence()
            if current is not None:
                # stale-epoch admission refusal: consume the offset (the
                # record must not replay into a double-sequence later)
                # and nack with the current epoch so the client rebases
                # against the new owner. Counted under placement.*.
                self.log_offset = message.offset
                self._refuse_stale_epoch(message.value, current)
                return
        self.log_offset = message.offset
        raw = message.value
        if type(raw) is ArrayBoxcar:
            self._ticket_array_boxcar(raw)
        elif type(raw) is RawBoxcar:
            self._ticket_boxcar(raw)
        else:
            self._ticket(raw)

    def checkpoint(self) -> DeliCheckpoint:
        return DeliCheckpoint(
            log_offset=self.log_offset,
            sequence_number=self.sequence_number,
            clients=[
                {
                    "client_id": c.client_id,
                    "client_sequence_number": c.client_sequence_number,
                    "reference_sequence_number": c.reference_sequence_number,
                    "last_update": c.last_update,
                    "can_evict": c.can_evict,
                    "detail": c.detail,
                }
                for c in self.clients.values()
            ],
        )

    def check_idle_clients(self) -> None:
        """Expire clients idle past the timeout so the msn can advance
        (ref: deli lambda checkIdleClients / ClientSequenceTimeout).

        Leaves route through the raw-ops log (``send_raw``, the reference's
        sendToAlfred backchannel) rather than being sequenced directly: a
        crash after eviction but before a checkpoint must replay raw ops
        into the SAME sequence numbers already persisted/broadcast, which
        only holds if the eviction itself is a raw-log record. ``_ticket``'s
        duplicate-leave check makes redelivery idempotent."""
        now = self._clock()
        for client_id in [
            c.client_id
            for c in self.clients.values()
            if c.can_evict and now - c.last_update > self._client_timeout
            and c.client_id not in self._pending_leaves
        ]:
            if self._log is not None:
                self._log.info("idle_client_evicted", client_id=client_id,
                               doc=self.document_id)
            if self._send_raw is not None:
                self._pending_leaves.add(client_id)
                self._send_raw(
                    RawMessage(
                        tenant_id=self.tenant_id,
                        document_id=self.document_id,
                        client_id=None,
                        operation=DocumentMessage(
                            client_sequence_number=-1,
                            reference_sequence_number=-1,
                            type=MessageType.CLIENT_LEAVE,
                            contents={"clientId": client_id},
                        ),
                        timestamp=now,
                    )
                )
            else:  # no raw backchannel wired (bare-lambda unit tests)
                self._sequence_system(
                    MessageType.CLIENT_LEAVE, {"clientId": client_id}, now
                )

    def close(self) -> None:
        pass

    def _refuse_stale_epoch(self, raw, current_epoch: int) -> None:
        """Placement fence tripped: this core's claim on the partition is
        older than the routing table's. Refuse WITHOUT sequencing — nack
        client records with the current epoch (the redirect hint), drop
        system records (the new owner re-derives joins/leaves)."""
        from .placement_plane import placement_counters

        placement_counters().inc("placement.epoch.stale_nacks")
        msg = (f"stale placement epoch: partition now at epoch "
               f"{current_epoch}; reconnect")
        if type(raw) is RawBoxcar:
            for op in raw.ops:
                self._nack(raw.client_id, Nack(
                    operation=op, sequence_number=self.sequence_number,
                    code=410, type=NackErrorType.BAD_REQUEST, message=msg))
        elif type(raw) is ArrayBoxcar:
            self._nack(raw.client_id, Nack(
                operation=None, sequence_number=self.sequence_number,
                code=410, type=NackErrorType.BAD_REQUEST, message=msg))
        elif getattr(raw, "client_id", None) is not None:
            self._nack(raw.client_id, Nack(
                operation=raw.operation,
                sequence_number=self.sequence_number,
                code=410, type=NackErrorType.BAD_REQUEST, message=msg))

    def _nack_logged(self, send_nack):
        def nack(client_id, n):
            if self._log is not None:
                self._log.send("error", "nack", client_id=client_id,
                               doc=self.document_id, code=n.code,
                               reason=n.message)
            send_nack(client_id, n)
        return nack

    # ---------------------------------------------------- boxcar fast lane

    def _ticket_boxcar(self, box: RawBoxcar) -> None:
        """Ticket a client's batch in one vectorized pass.

        Fast-lane preconditions (else per-op scalar fallback):
        the client is joined, every op is a plain OPERATION, clientSeqs are
        consecutive from the stored counter, and refSeqs are non-decreasing
        starting at/above the stored refSeq.

        Under those preconditions the scalar rules collapse:

        - no nack can fire: the pre-op msn for op i is
          ``min(others_min, rseq[i-1]) <= rseq[i-1] <= rseq[i]`` (and for
          op 0, ``min(others_min, stored) <= stored <= rseq[0]``), so
          ``rseq[i] < msn`` is impossible;
        - only this client's refSeq moves during the boxcar, so the
          post-op msn for op i is exactly ``min(others_min, rseq[i])``
          with ``others_min`` hoisted out of the loop — the
          clientSeqManager heap reduced to one vectorized ``minimum``;
        - sequence numbers are ``seq+1 .. seq+n``.
        """
        ops = box.ops
        client = self.clients.get(box.client_id)
        if not ops or client is None:
            self._fallback_boxcar(box)
            return
        n = len(ops)
        op_t = MessageType.OPERATION
        if n >= 128:  # numpy wins only on big boxcars: at n=32 the two
            # fromiter+diff round trips cost ~3× the scalar check loop
            # big boxcar: the checks and the msn rule as numpy array ops
            cseq = np.fromiter(
                (op.client_sequence_number for op in ops), np.int64, n)
            rseq = np.fromiter(
                (op.reference_sequence_number for op in ops), np.int64, n)
            if not (
                cseq[0] == client.client_sequence_number + 1
                and rseq[0] >= client.reference_sequence_number
                and (np.diff(cseq) == 1).all()
                and (np.diff(rseq) >= 0).all()
                and all(op.type is op_t for op in ops)
            ):
                self._fallback_boxcar(box)
                return
            last_cseq = int(cseq[-1])
            last_rseq = int(rseq[-1])
        else:
            # small boxcar: array setup costs more than it saves
            prev_c = client.client_sequence_number
            prev_r = client.reference_sequence_number
            for op in ops:
                if (
                    op.type is not op_t
                    or op.client_sequence_number != prev_c + 1
                    or op.reference_sequence_number < prev_r
                ):
                    self._fallback_boxcar(box)
                    return
                prev_c += 1
                prev_r = op.reference_sequence_number
            last_cseq = prev_c
            last_rseq = prev_r
            rseq = None

        now = box.timestamp or self._clock()
        others_min = min(
            (
                c.reference_sequence_number
                for c in self.clients.values()
                if c is not client
            ),
            default=None,
        )
        seq = self.sequence_number
        if rseq is not None:
            msns = (rseq if others_min is None
                    else np.minimum(rseq, others_min)).tolist()
        else:
            msns = None

        self.sequence_number = seq + n
        client.client_sequence_number = last_cseq
        client.reference_sequence_number = last_rseq
        client.last_update = now

        out = []
        cid = box.client_id
        # sampled tracing (ref: deli's sampled message tracing): the hop
        # is stamped only onto ops the CLIENT pre-traced — load workers
        # stamp one op per boxcar — so the per-op trace encode/decode
        # cost scales with the sampling rate, not the op rate. ONE hop
        # object is shared across the batch (hops are never mutated,
        # only copied — consumers that extend traces build their own)
        hop = None
        empty: list = []
        for i, op in enumerate(ops):
            ref = op.reference_sequence_number
            if msns is not None:
                msn = msns[i]
            else:
                msn = ref if (others_min is None or ref < others_min) \
                    else others_min
            seq += 1
            if op.traces:
                if hop is None:
                    hop = TraceHop(service="deli", action="sequence",
                                   timestamp=now)
                traces = list(op.traces)
                traces.append(hop)
            else:
                traces = empty
            out.append(
                SequencedDocumentMessage(
                    client_id=cid,
                    sequence_number=seq,
                    minimum_sequence_number=msn,
                    client_sequence_number=op.client_sequence_number,
                    reference_sequence_number=ref,
                    type=op.type,
                    contents=op.contents,
                    metadata=op.metadata,
                    timestamp=now,
                    traces=traces,
                )
            )
        self.boxcars_fast += 1
        if self._send_batch is not None:
            self._send_batch(out)
        else:
            for msg in out:
                self._send(msg)

    def _ticket_array_boxcar(self, box) -> None:
        """Ticket an ArrayBoxcar (service/array_batch.py) in one pass
        over plain integers — the array lane of the boxcar fast path.

        Same preconditions as _ticket_boxcar (joined client, consecutive
        clientSeqs, non-decreasing refSeqs ≥ stored — under which no
        nack can fire and the msn rule collapses to one minimum), each
        checked on every op; a miss falls back to the scalar lane on the
        EQUIVALENT dict boxcar. Emits a SequencedArrayBatch carrying seq
        range + per-op msns; no per-op message objects are built (cold
        consumers materialize).

        The msn floor is taken AFTER this client's refSeq moves to the
        boxcar's last: ``floor = min(others_min, rs[-1])``, so a floor
        below ``rs[-1]`` is the other clients' minimum and caps the
        msns from the first refSeq that reaches it (refSeqs are sorted),
        and a floor equal to it leaves every msn at its own refSeq."""
        client = self.clients.get(box.client_id)
        n = box.n
        if n == 0 or client is None:
            self._fallback_array_boxcar(box)
            return
        cs = box.cseq.tolist()
        rs = box.rseq.tolist()
        first_c = client.client_sequence_number + 1
        last_r = rs[-1]
        if not (
            rs[0] >= client.reference_sequence_number
            and cs == list(range(first_c, first_c + n))
            and (rs.count(last_r) == n or rs == sorted(rs))
        ):
            self._fallback_array_boxcar(box)
            return
        now = box.timestamp or self._clock()
        client.client_sequence_number = first_c + n - 1
        client.reference_sequence_number = last_r
        client.last_update = now
        floor = min(map(_REF_SEQ, self.clients.values()))
        msns = box.rseq.astype(np.int64)
        if floor < last_r:
            msns[bisect_left(rs, floor):] = floor
        base_seq = self.sequence_number + 1
        self.sequence_number += n
        self.boxcars_fast += 1
        if tracing():
            SPANS.count(COUNT_ARRAY_FAST)
        if box.hops is not None:
            # sampled boxcar: the stamp timestamp IS deli's ticket time
            # (matches what scan_ops reports as deli_ts for cols frames)
            box.hops.append((HOP_DELI, now))
        batch = SequencedArrayBatch(box, base_seq, msns, now)
        if self._send_batch is not None:
            self._send_batch(batch)
        else:
            for msg in batch.messages():
                self._send(msg)

    def _fallback_array_boxcar(self, box) -> None:
        """Scalar lane for an ArrayBoxcar that misses a precondition."""
        if tracing():
            SPANS.count(COUNT_ARRAY_FALLBACK)
        self._fallback_boxcar(box.to_raw_boxcar())

    def _fallback_boxcar(self, box: RawBoxcar) -> None:
        """Scalar lane for boxcars that miss a fast-path precondition."""
        self.boxcars_fallback += 1
        for op in box.ops:
            self._ticket(
                RawMessage(
                    tenant_id=box.tenant_id,
                    document_id=box.document_id,
                    client_id=box.client_id,
                    operation=op,
                    timestamp=box.timestamp,
                )
            )

    # ------------------------------------------------------------- internal

    def _min_ref_seq(self) -> int:
        """msn = min reference seq over connected clients; with no clients
        the msn rides the sequence number (ref: clientSeqManager heap)."""
        if not self.clients:
            return self.sequence_number
        return min(c.reference_sequence_number for c in self.clients.values())

    def _ticket(self, raw: RawMessage) -> None:
        op = raw.operation
        now = raw.timestamp or self._clock()

        if op.type == MessageType.CLIENT_JOIN:
            # system message from the front end; content names the client
            content = op.contents or {}
            client_id = content.get("clientId")
            if client_id in self.clients:
                return  # duplicate join
            self.clients[client_id] = ClientState(
                client_id=client_id,
                reference_sequence_number=self.sequence_number,
                last_update=now,
                can_evict=content.get("canEvict", True),
                detail=content.get("detail"),
            )
            self._sequence_system(MessageType.CLIENT_JOIN, content, now)
            return

        if op.type == MessageType.CLIENT_LEAVE:
            client_id = (op.contents or {}).get("clientId")
            self._pending_leaves.discard(client_id)
            if client_id not in self.clients:
                return  # duplicate leave
            self._sequence_system(MessageType.CLIENT_LEAVE, op.contents, now)
            if not self.clients:
                # the doc went quiet: the NoClient marker tells scribe a
                # service summary can capture final state (ref: deli
                # sending NoClient, protocol.ts MessageType.noClient)
                self._sequence_system(MessageType.NO_CLIENT, None, now)
            return

        if raw.client_id is None:
            # other server-originated messages (scribe's summary ack/nack,
            # control) sequence without client bookkeeping
            self._sequence_system(op.type, op.contents, now)
            return

        # client-originated: must be joined
        client = self.clients.get(raw.client_id)
        if client is None:
            self._nack(
                raw.client_id,
                Nack(
                    operation=op,
                    sequence_number=self.sequence_number,
                    code=400,
                    type=NackErrorType.BAD_REQUEST,
                    message="client not connected (no join on record)",
                ),
            )
            return

        # clientSeq dup/gap detection (ref: deli lambda.ts:264-271)
        expected = client.client_sequence_number + 1
        if op.client_sequence_number < expected:
            return  # duplicate: already sequenced (reconnect replay)
        if op.client_sequence_number > expected:
            self._nack(
                raw.client_id,
                Nack(
                    operation=op,
                    sequence_number=self.sequence_number,
                    code=400,
                    type=NackErrorType.BAD_REQUEST,
                    message=f"clientSeq gap: expected {expected}, "
                    f"got {op.client_sequence_number}",
                ),
            )
            return

        # refSeq below the collaboration window floor is unresolvable
        msn = self._min_ref_seq()
        if op.reference_sequence_number < msn:
            self._nack(
                raw.client_id,
                Nack(
                    operation=op,
                    sequence_number=self.sequence_number,
                    code=400,
                    type=NackErrorType.BAD_REQUEST,
                    message=f"refSeq {op.reference_sequence_number} below msn {msn}",
                ),
            )
            return

        msn_before = msn  # nothing mutated since the nack check above
        client.client_sequence_number = op.client_sequence_number
        client.reference_sequence_number = op.reference_sequence_number
        client.last_update = now

        if op.type == MessageType.NOOP and self._min_ref_seq() == msn_before:
            # noop consolidation (ref: deli's noop timer): a heartbeat
            # that does NOT move the document msn has nothing to tell
            # anyone — the refSeq bookkeeping above is its whole effect,
            # so it takes no sequence number. A floor-moving noop still
            # sequences (ONE message makes the new msn visible, which is
            # what lets quorum proposals commit). Deterministic on
            # replay: a pure function of the record + prior state.
            self.noops_consolidated += 1
            return

        self.sequence_number += 1
        # sampled tracing: stamp only client-traced ops (see fast lane)
        traces = list(op.traces)
        if traces:
            traces.append(TraceHop(service="deli", action="sequence",
                                   timestamp=now))
        self._send(
            SequencedDocumentMessage(
                client_id=raw.client_id,
                sequence_number=self.sequence_number,
                minimum_sequence_number=self._min_ref_seq(),
                client_sequence_number=op.client_sequence_number,
                reference_sequence_number=op.reference_sequence_number,
                type=op.type,
                contents=op.contents,
                metadata=op.metadata,
                timestamp=now,
                traces=traces,
            )
        )

    def _sequence_system(
        self, type: MessageType, contents: Any, timestamp: Optional[float] = None
    ) -> None:
        """Sequence a server-generated message (join/leave/noClient).

        ``timestamp`` is the raw message's timestamp when ticketing from
        the log — replay must reproduce byte-identical sequenced records,
        so the wall clock is only a fallback for direct (non-log) calls."""
        if type == MessageType.CLIENT_LEAVE:
            self.clients.pop((contents or {}).get("clientId"), None)
        self.sequence_number += 1
        now = self._clock() if timestamp is None else timestamp
        self._send(
            SequencedDocumentMessage(
                client_id=None,
                sequence_number=self.sequence_number,
                minimum_sequence_number=self._min_ref_seq(),
                client_sequence_number=-1,
                reference_sequence_number=-1,
                type=type,
                contents=contents,
                timestamp=now,
                # trace stamped at the record timestamp, not the wall
                # clock: crash replay must reproduce byte-identical records
                traces=[TraceHop(service="deli", action="sequence",
                                 timestamp=now)],
            )
        )
