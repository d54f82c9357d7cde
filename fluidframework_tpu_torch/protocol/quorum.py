"""The shared consensus kernel: Quorum + ProtocolOpHandler.

JAX counterpart: ``fluidframework_tpu/protocol/quorum.py``; the port's copy,
imports rebased to this package.

This exact state machine runs replicated on every client AND inside the
service's scribe lambda — it is pure deterministic logic over the sequenced
message stream, so all replicas converge.

Ref: protocol-base/src/quorum.ts:67 (Quorum), protocol-base/src/protocol.ts:50
(ProtocolOpHandler); used from container.ts:1116 (client) and
scribe/lambda.ts:71 (server).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .consensus import ClientDetails, ProposalState, QuorumProposal, SequencedClient
from .messages import MessageType, SequencedDocumentMessage


class ProtocolError(Exception):
    """Raised when the sequenced stream violates the protocol contract."""


class Quorum:
    """Replicated membership + key/value consensus over the total order.

    Consensus rule: a proposal at seq P commits when the minimum sequence
    number reaches/passes P with no client having sequenced a rejection of it
    (unanimous-silence; ref quorum.ts:67 docstring in SURVEY.md §2.7).
    """

    def __init__(
        self,
        members: Optional[dict[str, SequencedClient]] = None,
        proposals: Optional[dict[int, QuorumProposal]] = None,
        values: Optional[dict[str, Any]] = None,
    ):
        self.members: dict[str, SequencedClient] = dict(members or {})
        # keyed by the propose op's sequence number
        self.proposals: dict[int, QuorumProposal] = dict(proposals or {})
        # committed values
        self.values: dict[str, Any] = dict(values or {})
        # event listeners
        self._listeners: dict[str, list[Callable]] = {}

    # -- events ----------------------------------------------------------
    def on(self, event: str, fn: Callable) -> None:
        self._listeners.setdefault(event, []).append(fn)

    def _emit(self, event: str, *args: Any) -> None:
        for fn in self._listeners.get(event, []):
            fn(*args)

    # -- membership ------------------------------------------------------
    def add_member(self, client_id: str, client: SequencedClient) -> None:
        self.members[client_id] = client
        self._emit("addMember", client_id, client)

    def remove_member(self, client_id: str) -> None:
        if client_id in self.members:
            del self.members[client_id]
            self._emit("removeMember", client_id)

    def get_member(self, client_id: str) -> Optional[SequencedClient]:
        return self.members.get(client_id)

    # -- proposals -------------------------------------------------------
    def add_proposal(self, key: str, value: Any, seq: int, local: bool) -> None:
        self.proposals[seq] = QuorumProposal(
            key=key, value=value, sequence_number=seq, local=local
        )
        self._emit("addProposal", self.proposals[seq])

    def reject_proposal(self, client_id: str, proposal_seq: int) -> None:
        prop = self.proposals.get(proposal_seq)
        if prop is not None and prop.state is ProposalState.PENDING:
            prop.rejections.add(client_id)

    def get(self, key: str) -> Any:
        return self.values.get(key)

    def has(self, key: str) -> bool:
        return key in self.values

    def update_minimum_sequence_number(self, min_seq: int, current_seq: int) -> None:
        """Commit/reject every pending proposal the window has passed."""
        if not self.proposals:
            return
        done = []
        for seq, prop in sorted(self.proposals.items()):
            if seq > min_seq:
                break
            if prop.rejections:
                prop.state = ProposalState.REJECTED
                self._emit("rejectProposal", prop)
            else:
                prop.state = ProposalState.ACCEPTED
                prop.approval_seq = current_seq
                self.values[prop.key] = prop.value
                self._emit("approveProposal", prop)
            done.append(seq)
        for seq in done:
            del self.proposals[seq]

    # -- snapshot --------------------------------------------------------
    def snapshot(self) -> dict:
        """Serializable protocol state (ref: quorum.ts:110 snapshot)."""
        return {
            "members": {
                cid: {
                    "sequenceNumber": sc.sequence_number,
                    "client": {
                        "userId": sc.client.user_id,
                        "mode": sc.client.mode,
                        "interactive": sc.client.interactive,
                        "details": sc.client.details,
                        "scopes": sc.client.scopes,
                    },
                }
                for cid, sc in self.members.items()
            },
            "proposals": {
                str(seq): {
                    "key": p.key,
                    "value": p.value,
                    "sequenceNumber": seq,
                    "local": p.local,
                    "rejections": sorted(p.rejections),
                }
                for seq, p in self.proposals.items()
            },
            "values": dict(self.values),
        }

    @classmethod
    def load(cls, snapshot: dict) -> "Quorum":
        members = {
            cid: SequencedClient(
                client=ClientDetails(
                    user_id=m["client"].get("userId", ""),
                    mode=m["client"].get("mode", "write"),
                    interactive=m["client"].get("interactive", True),
                    details=m["client"].get("details", {}),
                    scopes=m["client"].get("scopes", []),
                ),
                sequence_number=m["sequenceNumber"],
            )
            for cid, m in snapshot.get("members", {}).items()
        }
        proposals = {
            int(seq): QuorumProposal(
                key=p["key"],
                value=p["value"],
                sequence_number=int(seq),
                local=p.get("local", False),
                rejections=set(p.get("rejections", [])),
            )
            for seq, p in snapshot.get("proposals", {}).items()
        }
        return cls(members=members, proposals=proposals, values=dict(snapshot.get("values", {})))


class ProtocolOpHandler:
    """Applies protocol-level messages to the quorum replica and tracks the
    collaboration window.

    Ref: protocol-base/src/protocol.ts:50,77 — identical logic on client
    (container boot) and server (scribe).
    """

    def __init__(
        self,
        minimum_sequence_number: int = 0,
        sequence_number: int = 0,
        quorum: Optional[Quorum] = None,
    ):
        self.minimum_sequence_number = minimum_sequence_number
        self.sequence_number = sequence_number
        self.quorum = quorum or Quorum()

    def process_message(self, message: SequencedDocumentMessage, local: bool = False) -> bool:
        """Apply one sequenced message. Returns False when the message was
        a duplicate below the head (idempotent redelivery), True when it
        was applied — callers with side effects beyond the replica (e.g.
        scribe's summarize handling) must branch on this."""
        if message.sequence_number <= self.sequence_number and message.sequence_number != 0:
            # duplicate delivery — the stream is idempotent below our head
            return False
        if message.sequence_number != self.sequence_number + 1:
            # a gap means the caller's reorder buffer failed; processing past
            # it would silently drop ops and diverge the replica (the
            # reference asserts contiguity in protocol.ts processMessage)
            raise ProtocolError(
                f"sequence gap: have {self.sequence_number}, got {message.sequence_number}"
            )
        self.sequence_number = message.sequence_number

        mtype = message.type
        if mtype == MessageType.CLIENT_JOIN:
            detail = message.contents or {}
            client = ClientDetails(
                user_id=detail.get("userId", ""),
                mode=detail.get("mode", "write"),
                interactive=detail.get("interactive", True),
                details=detail.get("details", {}),
                scopes=detail.get("scopes", []),
            )
            self.quorum.add_member(
                detail.get("clientId", message.client_id or ""),
                SequencedClient(client=client, sequence_number=message.sequence_number),
            )
        elif mtype == MessageType.CLIENT_LEAVE:
            leaving = message.contents if isinstance(message.contents, str) else (
                (message.contents or {}).get("clientId", message.client_id)
            )
            self.quorum.remove_member(leaving)
        elif mtype == MessageType.PROPOSE:
            body = message.contents or {}
            self.quorum.add_proposal(
                body.get("key"), body.get("value"), message.sequence_number, local
            )
        elif mtype == MessageType.REJECT:
            body = message.contents
            if isinstance(body, dict):
                body = body.get("sequenceNumber")
            if isinstance(body, (int, float)) and not isinstance(body, bool):
                self.quorum.reject_proposal(message.client_id or "", int(body))
            # malformed reject bodies are ignored rather than killing the
            # shared client/scribe op loop

        # advance the window and settle proposals it has passed
        if message.minimum_sequence_number > self.minimum_sequence_number:
            self.minimum_sequence_number = message.minimum_sequence_number
        self.quorum.update_minimum_sequence_number(
            self.minimum_sequence_number, self.sequence_number
        )
        return True

    def observe_operation_run(
        self, first_seq: int, last_seq: int, final_msn: int
    ) -> bool:
        """Apply a contiguous run of plain OPERATION messages in one step.

        The batched fast lane (service/deli.py boxcars) delivers runs that
        contain no membership/proposal messages, so the replica's only
        state change is the head/window advance. Settling proposals once
        with the run's final msn commits exactly the set the per-op path
        would (rejections can only arrive via REJECT messages, which never
        ride these runs). Handles replay overlap like process_message:
        a run entirely below the head is a duplicate (returns False); a
        partial overlap advances from the head.
        """
        if last_seq <= self.sequence_number:
            return False
        if first_seq > self.sequence_number + 1:
            raise ProtocolError(
                f"sequence gap: have {self.sequence_number}, run starts at {first_seq}"
            )
        self.sequence_number = last_seq
        if final_msn > self.minimum_sequence_number:
            self.minimum_sequence_number = final_msn
        self.quorum.update_minimum_sequence_number(
            self.minimum_sequence_number, self.sequence_number
        )
        return True

    def snapshot(self) -> dict:
        return {
            "minimumSequenceNumber": self.minimum_sequence_number,
            "sequenceNumber": self.sequence_number,
            "quorum": self.quorum.snapshot(),
        }

    @classmethod
    def load(cls, snapshot: dict) -> "ProtocolOpHandler":
        return cls(
            minimum_sequence_number=snapshot["minimumSequenceNumber"],
            sequence_number=snapshot["sequenceNumber"],
            quorum=Quorum.load(snapshot["quorum"]),
        )
