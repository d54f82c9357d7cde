"""Scribe: the durable protocol replica + summary commit validator.

JAX counterpart: ``fluidframework_tpu/service/scribe.py``; the port's copy,
imports rebased to this package.

Ref: lambdas/src/scribe/lambda.ts:39,71,113 — consumes the sequenced
stream, maintains a server-side ProtocolOpHandler replica (the same class
the client runs — protocol-base is shared code), and on a client
``summarize`` op validates the proposed summary's parentage against the
last acked head (summaryWriter.ts:69-192 writeClientSummary) before
acknowledging it into the total order. Acks/nacks travel BACK through the
sequencer (send-to-deli), so every client sees them at the same stream
position.

Storage model: clients upload summary trees to the content-addressed
store first (client upload_summary → version record with parent link);
scribe checks the chain and flips the version's ``acked`` flag — the
analog of scribe creating the git commit + ref update.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
)
from ..protocol.quorum import ProtocolOpHandler
from .core import InMemoryDb, QueuedMessage, summary_versions_collection
from .deli import RawMessage

SCRIBE_CHECKPOINT_COLLECTION = "scribe-checkpoints"


class ScribeLambda:
    def __init__(
        self,
        tenant_id: str,
        document_id: str,
        db: InMemoryDb,
        send_to_deli: Callable[[RawMessage], None],
        checkpoint: Optional[dict] = None,
        on_summary_committed: Optional[Callable[[int], None]] = None,
        persist_version: Optional[Callable[[str, dict], None]] = None,
    ):
        self.tenant_id = tenant_id
        self.document_id = document_id
        self._db = db
        self._send_to_deli = send_to_deli
        # fires with the committed summary's capture seq — the hook log
        # retention hangs off (ops the summary covers may truncate)
        self._on_committed = on_summary_committed
        # persists the acked version RECORD outside the db (the durable
        # log), so summaries survive full process death — without it a
        # truncated log + dead db leaves the doc unbootable
        self._persist_version = persist_version
        self._versions_col = summary_versions_collection(tenant_id, document_id)
        if checkpoint:
            self.protocol = ProtocolOpHandler.load(checkpoint["protocol"])
            self.last_summary_head: Optional[str] = checkpoint["head"]
            self.last_offset: int = checkpoint["offset"]
        else:
            self.protocol = ProtocolOpHandler()
            self.last_summary_head = None
            self.last_offset = -1

    def handler(self, message: QueuedMessage) -> None:
        if message.offset <= self.last_offset:
            return  # replay after restart
        self.last_offset = message.offset
        abatch = message.value.get("abatch")
        if abatch is not None:
            # array-lane run: plain operations by construction
            self.protocol.observe_operation_run(
                abatch.base_seq, abatch.last_seq, abatch.last_msn)
            return
        batch = message.value.get("boxcar")
        if batch is not None:
            # boxcars are plain-operation runs by construction (the deli
            # fast lane emits them); the replica only needs the window
            # advanced once per run — proposals the window passes settle
            # identically (values are order-independent; approval_seq is
            # not persisted in snapshots)
            self.protocol.observe_operation_run(
                batch[0].sequence_number,
                batch[-1].sequence_number,
                batch[-1].minimum_sequence_number,
            )
            return
        msg: SequencedDocumentMessage = message.value["message"]
        # deli crash-replay re-appends already-sequenced records at NEW
        # topic offsets, so the offset gate above doesn't catch them;
        # process_message dedupes by seq and reports it — an already-acked
        # summarize must not re-run _handle_summarize (it would emit a
        # spurious nack: parent no longer matches head)
        applied = self.protocol.process_message(msg)
        if msg.type == MessageType.SUMMARIZE and applied:
            self._handle_summarize(msg)

    def close(self) -> None:
        pass

    # ------------------------------------------------------------ summaries

    def _handle_summarize(self, msg: SequencedDocumentMessage) -> None:
        contents = msg.contents or {}
        handle = contents.get("handle")
        parent = contents.get("parent")
        head = contents.get("head")
        version = self._db.find_one(self._versions_col, handle) if handle else None

        if version is None:
            self._nack(msg, f"unknown summary handle {handle!r}")
            return
        if parent != self.last_summary_head:
            # parent must be the last acked head (summaryWriter.ts:85)
            self._nack(
                msg,
                f"summary parent {parent!r} does not match head "
                f"{self.last_summary_head!r}",
            )
            return
        if not isinstance(head, int) or head > msg.sequence_number:
            # a summary claiming to cover sequence numbers beyond the
            # stream would poison every future boot (clients would resume
            # at the bogus seq and drop real ops as duplicates)
            self._nack(msg, f"summary head {head!r} is ahead of the stream")
            return

        self.commit_version(handle, head, version=version)
        self._send_to_deli(
            RawMessage(
                tenant_id=self.tenant_id,
                document_id=self.document_id,
                client_id=None,
                operation=DocumentMessage(
                    client_sequence_number=-1,
                    reference_sequence_number=-1,
                    type=MessageType.SUMMARY_ACK,
                    contents={
                        "handle": handle,
                        "summarySequenceNumber": msg.sequence_number,
                    },
                ),
            )
        )

    def commit_version(self, handle: str, head: int,
                       version: Optional[dict] = None) -> None:
        """Commit a version as the acked head — the single ref-update path.

        Used by both client summaries (_handle_summarize) and service
        summaries (service_summarizer.py): flips acked, appends to the
        durable versions topic, updates the head, and fires the retention
        callback. Writing around this (e.g. upserting acked=True directly
        in the db) makes the summary vanish on full process death and
        never advances log retention."""
        if version is None:
            version = self._db.find_one(self._versions_col, handle)
            if version is None:
                raise KeyError(f"unknown summary handle {handle!r}")
        already_acked = bool(version.get("acked"))
        # the capture seq rides the acked record: retention clamps its
        # trim to the latest acked version's seq, so a booting client's
        # backfill base (the snapshot's seq) is always ≥ the retained base
        acked_version = dict(version, acked=True, seq=head)
        self._db.upsert(self._versions_col, handle, acked_version)
        self.last_summary_head = handle
        if self._persist_version is not None and not already_acked:
            # a post-restart replay re-commits an already-restored
            # version; appending again would grow the durable topic
            # with duplicates on every restart
            self._persist_version(handle, acked_version)
        if self._on_committed is not None:
            self._on_committed(head)

    def _nack(self, msg: SequencedDocumentMessage, reason: str) -> None:
        # boot visibility needs no marking here: only versions scribe acks
        # (acked=True) are served by storage get_versions
        handle = (msg.contents or {}).get("handle")
        self._send_to_deli(
            RawMessage(
                tenant_id=self.tenant_id,
                document_id=self.document_id,
                client_id=None,
                operation=DocumentMessage(
                    client_sequence_number=-1,
                    reference_sequence_number=-1,
                    type=MessageType.SUMMARY_NACK,
                    contents={
                        "handle": handle,
                        "summarySequenceNumber": msg.sequence_number,
                        "message": reason,
                    },
                ),
            )
        )

    # ----------------------------------------------------------- checkpoint

    def checkpoint_state(self) -> dict:
        return {
            "protocol": self.protocol.snapshot(),
            "head": self.last_summary_head,
            "offset": self.last_offset,
        }

    def checkpoint(self) -> None:
        self._db.upsert(
            SCRIBE_CHECKPOINT_COLLECTION,
            f"{self.tenant_id}/{self.document_id}",
            {"state": self.checkpoint_state()},
        )
