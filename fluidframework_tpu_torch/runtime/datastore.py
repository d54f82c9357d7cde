"""DataStoreRuntime: a named collection of channels (DDS instances).

JAX counterpart: ``fluidframework_tpu/runtime/datastore.py``; the port's copy,
imports rebased to this package.

Ref: runtime/datastore/src/dataStoreRuntime.ts:81 — routes channel ops to
channel contexts (:462,718); channel creation travels as a chanattach op
with the channel's snapshot (localChannelContext → attach). The channel
talks back through a ChannelDeltaConnection adapter
(channelDeltaConnection.ts:10), here a bound submit closure.

Inner envelope format (contents of a "chanop" runtime envelope):

- {"address": channel_id, "contents": wire_op}                channel op
- {"address": channel_id, "attach": {"type", "snapshot"}}     channel attach
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..dds.registry import create_channel, load_channel
from ..protocol.messages import SequencedDocumentMessage


class DataStoreRuntime:
    def __init__(self, runtime, ds_id: str, pkg: str = "default"):
        self.runtime = runtime
        self.id = ds_id
        self.pkg = pkg
        self.channels: dict[str, object] = {}

    # ------------------------------------------------------------ channels

    def create_channel(self, channel_id: str, channel_type: str):
        """Create a channel locally and announce it (attach op)."""
        if channel_id in self.channels:
            raise KeyError(f"channel {channel_id} exists")
        channel = create_channel(channel_type, channel_id)
        self._connect_channel(channel)
        self.channels[channel_id] = channel
        self.runtime.submit_channel_op(
            self.id,
            {
                "address": channel_id,
                "attach": {"type": channel_type, "snapshot": channel.snapshot()},
            },
        )
        return channel

    def get_channel(self, channel_id: str):
        return self.channels[channel_id]

    def _connect_channel(self, channel) -> None:
        channel._bind(
            submit=lambda contents: self.runtime.submit_channel_op(
                self.id, {"address": channel.id, "contents": contents}
            ),
            is_connected=lambda: self.runtime.connected,
        )
        # stream-head accessor for channels whose state changes without
        # ops (shared-summary-block dirty tracking)
        channel._head_fn = (
            lambda: self.runtime.container.delta_manager.last_processed_seq)
        if self.runtime.connected:
            channel.set_connection_state(True, self.runtime.client_id)

    # ------------------------------------------------------------- op flow

    def process(self, msg: SequencedDocumentMessage, local: bool) -> None:
        inner = msg.contents
        channel_id = inner["address"]
        if "attach" in inner:
            if channel_id not in self.channels:
                attach = inner["attach"]
                channel = load_channel(attach["type"], channel_id, attach["snapshot"])
                self._connect_channel(channel)
                self.channels[channel_id] = channel
            # stamp on the creator too (the skip branch): a channel born
            # after the parent summary must never summarize as a handle
            self.channels[channel_id].last_changed_seq = msg.sequence_number
            return
        channel = self.channels.get(channel_id)
        if channel is None:
            raise KeyError(f"op for unknown channel {channel_id} in store {self.id}")
        channel.process(replace(msg, contents=inner["contents"]), local)

    def resubmit_channel(self, channel_id: str) -> None:
        self.channels[channel_id].resubmit_pending()

    def set_connection_state(self, connected: bool, client_id: Optional[str]) -> None:
        for channel in self.channels.values():
            channel.set_connection_state(connected, client_id)

    def on_member_removed(self, client_id: str, seq: int = 0) -> None:
        for channel in self.channels.values():
            handler = getattr(channel, "on_member_removed", None)
            if handler:
                # a sequenced leave can mutate the channel (consensus
                # collections requeue the leaver's holdings) — it must
                # disqualify handle reuse like any other sequenced change
                channel.last_changed_seq = max(channel.last_changed_seq, seq)
                handler(client_id)

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        return {
            "channels": {
                cid: {"type": ch.channel_type, "snapshot": ch.snapshot()}
                for cid, ch in self.channels.items()
            }
        }

    def summarize(self, path: str, parent_capture_seq=None):
        """Summary subtree mirroring ``snapshot()``'s dict shape, with
        per-channel handle reuse (ref: FluidDataStoreRuntime summarize →
        channel contexts)."""
        import json as _json

        from ..protocol.summary import SummaryBlob, SummaryTree

        return SummaryTree(tree={
            "pkg": SummaryBlob(_json.dumps(self.pkg).encode()),
            "snapshot": SummaryTree(tree={
                "channels": SummaryTree(tree={
                    cid: ch.summarize(
                        f"{path}/snapshot/channels/{cid}", parent_capture_seq)
                    for cid, ch in self.channels.items()
                })
            }),
        })

    def load_snapshot(self, snap: dict, base_seq: int = 0) -> None:
        for cid, entry in snap.get("channels", {}).items():
            channel = load_channel(entry["type"], cid, entry["snapshot"])
            self._connect_channel(channel)
            # the boot summary captured this channel at base_seq: that is
            # its change floor, and (being > 0 for any real summary) it
            # keeps never-touched channels ELIGIBLE for handle reuse
            channel.last_changed_seq = base_seq
            self.channels[cid] = channel
