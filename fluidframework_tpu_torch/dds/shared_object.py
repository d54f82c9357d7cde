"""SharedObject: the contract every DDS implements.

JAX counterpart: ``fluidframework_tpu/dds/shared_object.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/shared-object-base/src/sharedObject.ts — snapshot()
:191, loadCore() :206, processCore() :237, reSubmit() :398, plus dirty/ack
bookkeeping. Channels submit through a bound connection adapter
(datastore ChannelDeltaConnection analog) and receive every sequenced op
for their address, with ``local`` telling them it is their own ack.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Callable, Optional

from ..protocol.messages import SequencedDocumentMessage
from ..protocol.summary import SummaryBlob, SummaryHandle, SummaryObject


class SharedObject:
    channel_type: str = "shared-object"

    def __init__(self, channel_id: str):
        self.id = channel_id
        self._submit_fn: Optional[Callable[[Any], None]] = None
        self._is_connected_fn: Callable[[], bool] = lambda: False
        self._listeners: dict[str, list[Callable]] = defaultdict(list)
        self.client_id: Optional[str] = None
        # seq of the last sequenced op that touched this channel — the
        # incremental-summary producer compares it against the parent
        # summary's capture seq to decide handle reuse (ref: summarizer
        # tracking in summarizerNode / channel contexts)
        self.last_changed_seq = 0

    # ------------------------------------------------------------- wiring

    def _bind(self, submit: Callable[[Any], None], is_connected: Callable[[], bool]) -> None:
        self._submit_fn = submit
        self._is_connected_fn = is_connected

    @property
    def is_attached(self) -> bool:
        return self._submit_fn is not None

    def submit_local_message(self, contents: Any) -> None:
        """Send a local op (the runtime records it as pending even while
        disconnected, replaying on reconnect)."""
        if self._submit_fn is None:
            raise RuntimeError(f"channel {self.id} is not attached")
        self._submit_fn(contents)

    # ------------------------------------------------------------- events

    def on(self, event: str, cb: Callable) -> Callable:
        self._listeners[event].append(cb)
        return cb

    def off(self, event: str, cb: Callable) -> None:
        if cb in self._listeners[event]:
            self._listeners[event].remove(cb)

    def _emit(self, event: str, *args) -> None:
        for cb in list(self._listeners[event]):
            cb(*args)

    # ----------------------------------------------------------- contract

    def process(self, msg: SequencedDocumentMessage, local: bool) -> None:
        self.last_changed_seq = msg.sequence_number
        self.process_core(msg, local)

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        raise NotImplementedError

    def resubmit_pending(self) -> None:
        """Regenerate + resubmit all unacked local ops after reconnect
        (ref: reSubmit sharedObject.ts:398)."""
        raise NotImplementedError

    def set_connection_state(self, connected: bool, client_id: Optional[str]) -> None:
        if connected:
            self.client_id = client_id
            self.on_connect(client_id)
        else:
            self.on_disconnect()

    def on_connect(self, client_id: str) -> None:
        pass

    def on_disconnect(self) -> None:
        pass

    def snapshot(self) -> dict:
        raise NotImplementedError

    def load_core(self, snap: dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------ summary

    def summarize(self, path: str,
                  parent_capture_seq: Optional[int] = None) -> SummaryObject:
        """Incremental summary entry: a channel untouched since the parent
        summary's capture seq is sent as a HANDLE to the parent's subtree
        at ``path`` — nothing re-uploads (ref: protocol-definitions
        summary.ts ISummaryHandle; channel contexts deciding reuse).

        ``last_changed_seq > 0`` guards new channels: one that never saw a
        sequenced op (attach included) cannot be in the parent tree."""
        from ..protocol.summary import SummaryTree

        if (
            parent_capture_seq is not None
            and 0 < self.last_changed_seq <= parent_capture_seq
        ):
            return SummaryHandle(handle=path)
        return SummaryTree(tree={
            "type": SummaryBlob(json.dumps(self.channel_type).encode()),
            "snapshot": self.summarize_core(),
        })

    def summarize_core(self) -> SummaryObject:
        """Full (non-handle) summary content. Default: one blob holding
        the snapshot; DDSes with big state override with a chunked tree
        (merge-tree, ref snapshotV1.ts:87)."""
        return SummaryBlob(
            json.dumps(self.snapshot(), separators=(",", ":")).encode())
