"""Last-edited tracker: who touched the document last, convergent.

JAX counterpart: ``fluidframework_tpu/framework/last_edited.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/last-edited-experimental — watches the sequenced
op stream and records (clientId, user detail, timestamp, seq) of the
last CONTENT edit into shared state every replica agrees on (system
messages and noops don't count as edits).
"""

from __future__ import annotations

from typing import Optional

from ..protocol.messages import MessageType, SequencedDocumentMessage

LAST_EDITED_KEY = "lastEdited"


class LastEditedTracker:
    def __init__(self, container, ds_id: str = "default",
                 channel_id: str = "last-edited"):
        self.container = container
        ds = container.runtime.get_data_store(ds_id)
        if channel_id in ds.channels:
            self._map = ds.get_channel(channel_id)
        else:
            self._map = ds.create_channel(channel_id, "shared-map")
        container.add_message_observer(self._observe)

    @property
    def last_edited(self) -> Optional[dict]:
        return self._map.get(LAST_EDITED_KEY)

    def _observe(self, msg: SequencedDocumentMessage) -> None:
        if msg.type is not MessageType.OPERATION or msg.client_id is None:
            return
        env = msg.contents
        if not isinstance(env, dict) or env.get("kind") != "chanop":
            return  # only content edits count
        # every replica observes the same stream, but only ONE should
        # write the record (or the tracker's own writes would cascade);
        # the oldest member writes — deterministic on every replica
        members = self.container.quorum.members
        if not members:
            return
        writer = min(members.items(), key=lambda kv: kv[1].sequence_number)[0]
        if writer != self.container.client_id:
            return
        if env["contents"].get("address") == self._map.id:
            return  # our own record write: not an edit
        member = members.get(msg.client_id)
        self._map.set(LAST_EDITED_KEY, {
            "clientId": msg.client_id,
            "user": member.client.user_id if member is not None else None,
            "sequenceNumber": msg.sequence_number,
            "timestamp": msg.timestamp,
        })
