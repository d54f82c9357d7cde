"""InvariantMonitor: ride the sequenced stream, assert the protocol.

JAX counterpart: ``fluidframework_tpu/chaos/monitor.py``; the port's copy,
imports rebased to this package.

Attached directly to a document's deltas topic (the authoritative
sequenced stream — what scriptorium sees, not the lossy fan-out), the
monitor checks, per first delivery:

- ``seq`` strictly increasing with no gaps;
- ``msn`` monotone non-decreasing and ≤ ``seq``;
- clientSeq rules: ops only from joined clients, clientSeq exactly
  previous+1 per client (deli's dedupe/gap contract), joins and leaves
  sequenced at most once per client id;
- every submitted op (registered via :meth:`note_submit`) resolves
  exactly once — sequenced, nacked, or explicitly resubmitted under a
  new incarnation after a reconnect — and never twice.

Redelivery (a rewound subscriber, a crash-replayed raw log re-ticketing
the same window) is *expected* under chaos: the monitor dedupes
deliveries whose seq is not beyond the high-water mark, counting them as
observed recoveries. ``dedupe=False`` deliberately breaks that check —
the soak's self-test mode, proving replay faults are detected when the
dedupe layer is gone.

Violations are recorded, not raised, so the monitor is safe inside
server-side handlers (including other threads); :meth:`check` /
:meth:`check_quiescent` raise :class:`InvariantViolation` at the end.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..obs import get_recorder, tier_counters
from ..protocol.messages import MessageType
from ..utils.telemetry import Counters


class InvariantViolation(AssertionError):
    """A protocol invariant did not hold over the observed stream."""


def doc_fingerprint(text: str, props: list[dict]) -> str:
    """Order-independent-of-representation digest of a replica's visible
    state: the text plus the property map of every visible position.
    Replicas (clients, device applier, log-replayed oracle) must agree
    on this at quiescence."""
    canon = [text, [sorted((str(k), str(v)) for k, v in p.items())
                    for p in props]]
    return hashlib.sha1(
        json.dumps(canon, separators=(",", ":")).encode()).hexdigest()


class InvariantMonitor:
    def __init__(self, counters: Optional[Counters] = None,
                 dedupe: bool = True):
        self.counters = (counters if counters is not None
                         else tier_counters("chaos"))
        self.dedupe = dedupe
        self.violations: list[str] = []
        self.last_seq = 0
        self.last_msn = 0
        self.observed = 0       # first deliveries checked
        self.redelivered = 0    # deduped replays/re-tickets
        self._clients: dict[str, int] = {}       # live id → last clientSeq
        self._joined: set[str] = set()           # every id ever joined
        self._left: set[str] = set()
        # (client_id, clientSeq) → "pending"|"acked"|"nacked"|"resubmitted"
        self._submitted: dict[tuple[str, int], str] = {}

    # ------------------------------------------------------------ wiring

    def attach(self, log, topic: str) -> None:
        """Subscribe to a deltas topic on an OrderedLogBase-shaped log."""
        log.subscribe(topic, self.handler, from_offset=0)

    def handler(self, message) -> None:
        """Log-subscriber entry point: one deltas-topic record."""
        record = message.value
        batch = record.get("abatch")
        if batch is not None:
            msgs = batch.messages()
        else:
            batch = record.get("boxcar")
            msgs = batch if batch is not None else [record["message"]]
        for m in msgs:
            self.observe(m)

    # ------------------------------------------------------- the invariants

    def observe(self, m) -> None:
        seq = m.sequence_number
        if seq <= self.last_seq:
            # redelivery: a rewound subscriber or a crash-replay
            # re-ticketing an already-sequenced window. Consumers dedupe
            # by seq; so does the monitor — unless self-testing with the
            # dedupe check broken, in which case the replay falls through
            # and trips the monotonicity invariant (as it should).
            if self.dedupe:
                self.redelivered += 1
                self.counters.inc("chaos.recovered.monitor_dedup")
                return
            self._violate(f"seq not strictly increasing: "
                          f"{self.last_seq} then {seq}")
        elif seq != self.last_seq + 1:
            self._violate(f"seq gap: {self.last_seq} -> {seq}")
        msn = m.minimum_sequence_number
        if msn < self.last_msn:
            self._violate(f"msn decreased: {self.last_msn} -> {msn} "
                          f"at seq {seq}")
        if msn > seq:
            self._violate(f"msn {msn} > seq {seq}")
        self.last_seq = max(self.last_seq, seq)
        self.last_msn = max(self.last_msn, msn)
        self.observed += 1

        if m.type == MessageType.CLIENT_JOIN:
            cid = (m.contents or {}).get("clientId")
            if cid in self._joined:
                self._violate(f"duplicate join sequenced for {cid}")
            elif cid is not None:
                self._joined.add(cid)
                self._clients[cid] = 0
        elif m.type == MessageType.CLIENT_LEAVE:
            cid = (m.contents or {}).get("clientId")
            if cid is not None:
                if cid in self._left:
                    self._violate(f"duplicate leave sequenced for {cid}")
                self._left.add(cid)
                self._clients.pop(cid, None)
        elif m.type == MessageType.OPERATION and m.client_id is not None:
            self._observe_op(m.client_id, m.client_sequence_number, seq)

    def _observe_op(self, cid: str, cseq: int, seq: int) -> None:
        last = self._clients.get(cid)
        if last is None:
            self._violate(f"op at seq {seq} from non-joined client {cid}")
            return
        if cseq != last + 1:
            kind = "duplicate" if cseq <= last else "gap"
            self._violate(f"clientSeq {kind} for {cid}: expected "
                          f"{last + 1}, sequenced {cseq} at seq {seq}")
        self._clients[cid] = max(last, cseq)
        key = (cid, cseq)
        state = self._submitted.get(key)
        if state == "acked":
            self._violate(f"op {key} sequenced twice (dedupe broken)")
        elif state is not None:
            self._submitted[key] = "acked"

    # ----------------------------------------------- submission accounting

    def note_submit(self, cid: str, cseq: int) -> None:
        self._submitted[(cid, cseq)] = "pending"

    def note_nack(self, cid: str, cseq: Optional[int]) -> None:
        if cseq is None:
            return
        key = (cid, cseq)
        if self._submitted.get(key) == "acked":
            self._violate(f"op {key} nacked after being sequenced")
        elif key in self._submitted:
            self._submitted[key] = "nacked"

    def note_resubmitted(self, cid: str, cseq: int) -> None:
        """The client abandoned this (unacked, possibly lost) submission
        and resubmitted its effect under a new incarnation; the new
        incarnation's note_submit carries the accountability forward."""
        key = (cid, cseq)
        if self._submitted.get(key) == "pending":
            self._submitted[key] = "resubmitted"

    # -------------------------------------------------------------- verdict

    def _violate(self, msg: str) -> None:
        self.violations.append(msg)
        self.counters.inc("chaos.invariants.violated")
        if len(self.violations) == 1:
            # first violation triggers the flight-recorder dump: the
            # event/frame rings still hold what led up to it (later
            # violations are usually the same failure cascading)
            try:
                get_recorder().dump("invariant_violation", detail=msg)
            except Exception:
                pass

    def check(self) -> None:
        if self.violations:
            head = "\n  ".join(self.violations[:20])
            raise InvariantViolation(
                f"{len(self.violations)} invariant violation(s):\n  {head}")

    def check_quiescent(self, fingerprints: dict[str, str]) -> None:
        """Final gate: every submission resolved exactly once, every
        replica fingerprint identical. Raises on any recorded violation."""
        for key, state in sorted(self._submitted.items()):
            if state == "pending":
                self._violate(f"op {key} neither acked, nacked, nor "
                              f"resubmitted at quiescence")
        if len(set(fingerprints.values())) > 1:
            detail = ", ".join(f"{name}={fp[:12]}"
                               for name, fp in sorted(fingerprints.items()))
            self._violate(f"replicas diverged at quiescence: {detail}")
        self.check()
