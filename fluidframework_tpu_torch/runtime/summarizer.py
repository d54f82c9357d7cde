"""Client-side summarizer: election + attempt heuristics + ack tracking.

JAX counterpart: ``fluidframework_tpu/runtime/summarizer.py``; the port's copy,
imports rebased to this package.

Ref: runtime/container-runtime summarizer subsystem — SummaryManager
elects the summarizer from the OLDEST quorum member (summaryManager.ts:
139,269); RunningSummarizer drives attempts off ops-since-last-ack
heuristics (summarizer.ts:232,403); SummaryCollection correlates the
broadcast summarize op with its ack/nack (summaryCollection.ts).

Differences from the reference, by design: the reference spawns a hidden
"/_summarizer" container so the summarizing replica never holds pending
local ops; here the elected client summarizes in-process and simply
defers while it has unacked ops (same invariant — summaries capture only
acked state — without the second container).
"""

from __future__ import annotations

from typing import Optional

from ..config import DEFAULT as _CFG
from ..protocol.messages import MessageType, SequencedDocumentMessage

# ops since last acked summary that trigger an attempt (config registry)
DEFAULT_MAX_OPS = _CFG.summary_max_ops


class SummaryManager:
    """Attach one per container (`SummaryManager(container)`); it watches
    the quorum, self-elects when oldest, and summarizes on the heuristics.
    """

    def __init__(
        self,
        container,
        max_ops: Optional[int] = None,
    ):
        max_ops = max_ops if max_ops is not None else _CFG.summary_max_ops
        self.container = container
        self.max_ops = max_ops
        self.last_acked_handle: Optional[str] = None
        # capture seq of the last ACKED summary — the threshold for
        # per-channel handle reuse. Learned from broadcast SUMMARIZE ops
        # (anyone's), correlated on ack; None (e.g. storage-seeded head
        # whose proposal predates us) forces a full upload.
        self.last_acked_capture_seq: Optional[int] = None
        self._proposal_heads: dict[str, int] = {}  # handle → capture seq
        self._pending_handle: Optional[str] = None
        self._ops_since_ack = 0
        self._nack_retries = 0
        self.summaries_acked = 0
        self.summaries_nacked = 0
        # seed the head from storage: a manager attached after boot missed
        # the SUMMARY_ACKs already in the op tail, and proposing
        # parent=None against an existing chain would nack-loop forever
        versions = container.storage.get_versions(1)
        if versions:
            self.last_acked_handle = versions[0]["id"]
        container.add_message_observer(self._observe)

    # ------------------------------------------------------------ election

    @property
    def elected_summarizer(self) -> Optional[str]:
        """Oldest quorum member = lowest join sequence number
        (ref: summaryManager electing via quorum join order)."""
        members = self.container.quorum.members
        if not members:
            return None
        return min(members.items(), key=lambda kv: kv[1].sequence_number)[0]

    @property
    def is_summarizer(self) -> bool:
        return (
            self.container.client_id is not None
            and self.elected_summarizer == self.container.client_id
        )

    # ------------------------------------------------------------ observer

    def _observe(self, msg: SequencedDocumentMessage) -> None:
        if msg.type == MessageType.SUMMARIZE:
            # remember every proposal's capture seq so an eventual ack
            # (ours or another client's) sets the handle-reuse threshold
            c = msg.contents or {}
            if c.get("handle") is not None and c.get("head") is not None:
                self._proposal_heads[c["handle"]] = c["head"]
            return
        if msg.type == MessageType.SUMMARY_ACK:
            handle = (msg.contents or {}).get("handle")
            self.last_acked_handle = handle
            self.last_acked_capture_seq = self._proposal_heads.pop(handle, None)
            self._proposal_heads.clear()  # older proposals can never ack now
            self._ops_since_ack = 0
            self._nack_retries = 0
            if handle == self._pending_handle:
                self._pending_handle = None
                self.summaries_acked += 1
            return
        if msg.type == MessageType.SUMMARY_NACK:
            # correlate by handle: another client's nack must not clear
            # OUR in-flight attempt
            if (msg.contents or {}).get("handle") == self._pending_handle \
                    and self._pending_handle is not None:
                self._pending_handle = None
                self.summaries_nacked += 1
                # safe retry (ref: summaryNack → retry, summarizer.ts:
                # 403-428): without it a transient nack (e.g. a parent
                # raced another client's ack) strands the attempt until
                # the next op — which may never come on an idle doc.
                # Refresh the head from storage first so a parent-
                # mismatch retry proposes against the REAL chain instead
                # of failing identically.
                if self._nack_retries < 2:
                    self._nack_retries += 1
                    versions = self.container.storage.get_versions(1)
                    if versions:
                        self.last_acked_handle = versions[0]["id"]
                        self.last_acked_capture_seq = None
                    self._maybe_summarize(force=True)
            return
        if msg.type == MessageType.OPERATION:
            self._ops_since_ack += 1
            self._maybe_summarize()

    def _maybe_summarize(self, force: bool = False) -> None:
        if (
            (self._ops_since_ack < self.max_ops and not force)
            or not self.is_summarizer
            or self._pending_handle is not None
            or not self.container.connected
            # only acked state may be summarized (the reference gets this
            # invariant from the hidden summarizer container)
            or self.container.runtime.pending.count > 0
        ):
            return
        self.summarize_now()

    # ------------------------------------------------------------- attempt

    def summarize_now(self) -> Optional[str]:
        """Generate, upload, and propose an INCREMENTAL summary (ref:
        ContainerRuntime.generateSummary containerRuntime.ts:1631 +
        summarize op submission §3.4): a recursive SummaryTree where
        channels untouched since the parent's capture seq ride as
        SummaryHandles and re-upload nothing."""
        import json

        from ..protocol.summary import SummaryBlob, SummaryTree

        if self.container.runtime.pending.count > 0:
            raise RuntimeError("cannot summarize with pending local ops")
        seq = self.container.delta_manager.last_processed_seq
        cap = (self.last_acked_capture_seq
               if self.last_acked_handle is not None else None)
        root = SummaryTree(tree={
            "protocol": SummaryBlob(json.dumps(
                self.container.protocol.snapshot(),
                separators=(",", ":")).encode()),
            "sequence_number": SummaryBlob(json.dumps(seq).encode()),
            "runtime": self.container.runtime.summarize(cap),
        })
        handle = self.container.storage.upload_summary(
            root, parent=self.last_acked_handle)
        self._pending_handle = handle
        self._proposal_heads[handle] = seq
        self.container.delta_manager.submit(
            MessageType.SUMMARIZE,
            {"handle": handle, "parent": self.last_acked_handle,
             "head": seq},
        )
        return handle
