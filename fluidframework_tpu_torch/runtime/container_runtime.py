"""ContainerRuntime: op multiplexer + pending-state replay.

JAX counterpart: ``fluidframework_tpu/runtime/container_runtime.py``; the port's copy,
imports rebased to this package. One repair (ROADMAP C2): submissions and
the activation replay hold the delta manager's ``dispatch_guard``.

Ref: runtime/container-runtime/src/containerRuntime.ts — process (:1094)
routes envelopes to data stores; submit batches local ops; the
PendingStateManager (pendingStateManager.ts:69) records every local
submission and replays it through ``reSubmit`` after reconnect (:301 →
SharedObject.reSubmit, sharedObject.ts:398). Data-store creation travels
as an attach op carrying the store's initial snapshot (:1451).

Envelope format on the wire (contents of a MessageType.OPERATION):

- {"kind": "attach", "id", "pkg", "snapshot"}            create data store
- {"kind": "chanop", "address", "contents": {
       "address": channel_id, "contents": dds_wire_op}}  channel op
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from enum import Enum
from typing import Any, Optional

from ..protocol.messages import MessageType, SequencedDocumentMessage
from .datastore import DataStoreRuntime


class FlushMode(Enum):
    """Ref: containerRuntime.ts FlushMode — IMMEDIATE sends every op as
    its own submission; TURN_BASED coalesces until flush()."""

    IMMEDIATE = 0
    TURN_BASED = 1


@dataclass
class PendingEntry:
    client_seq: int
    envelope: dict


class PendingStateManager:
    """Local ops awaiting server ack; the replay source after reconnect.

    Ref: pendingStateManager.ts:69 — entries are appended on submit,
    matched FIFO against our own sequenced messages (the server preserves
    per-client FIFO), and replayed through the runtime on reconnect (:301).
    """

    def __init__(self):
        self._pending: list[PendingEntry] = []

    def record_entry(self, entry: PendingEntry) -> None:
        self._pending.append(entry)

    def ack(self, msg: SequencedDocumentMessage) -> Optional[PendingEntry]:
        if not self._pending:
            raise RuntimeError(
                f"own op {msg.client_sequence_number} sequenced with no pending state"
            )
        head = self._pending.pop(0)
        return head

    def take_all(self) -> list[PendingEntry]:
        pending, self._pending = self._pending, []
        return pending

    @property
    def count(self) -> int:
        return len(self._pending)


class ContainerRuntime:
    def __init__(self, container):
        self.container = container
        self.data_stores: dict[str, DataStoreRuntime] = {}
        self.pending = PendingStateManager()
        self.connected = False
        self.client_id: Optional[str] = None
        # op batching (ref: containerRuntime.ts:1207-1271 FlushMode +
        # orderSequentially): entries held here are already recorded as
        # pending; flush() ships them as ONE batch submission
        self.flush_mode = FlushMode.IMMEDIATE
        self._batch: list[PendingEntry] = []
        self._order_depth = 0

    # --------------------------------------------------------- data stores

    def create_data_store(self, ds_id: str, pkg: str = "default") -> DataStoreRuntime:
        """Create locally and announce via an attach op carrying the
        initial snapshot (ref: containerRuntime.ts:1451 attach flow)."""
        if ds_id in self.data_stores:
            raise KeyError(f"data store {ds_id} exists")
        ds = DataStoreRuntime(self, ds_id, pkg)
        self.data_stores[ds_id] = ds
        self._submit({"kind": "attach", "id": ds_id, "pkg": pkg,
                      "snapshot": ds.snapshot()})
        return ds

    def get_data_store(self, ds_id: str) -> DataStoreRuntime:
        return self.data_stores[ds_id]

    # ------------------------------------------------------------- op flow

    def process(self, msg: SequencedDocumentMessage, local: bool) -> None:
        envelope = msg.contents
        if local:
            self.pending.ack(msg)
        kind = envelope.get("kind")
        if kind == "attach":
            if envelope["id"] not in self.data_stores:
                ds = DataStoreRuntime(self, envelope["id"], envelope["pkg"])
                ds.load_snapshot(envelope["snapshot"])
                self.data_stores[envelope["id"]] = ds
            return
        if kind == "chanop":
            ds = self.data_stores.get(envelope["address"])
            if ds is None:
                raise KeyError(f"op for unknown data store {envelope['address']}")
            inner = replace(msg, contents=envelope["contents"])
            ds.process(inner, local)
            return
        raise ValueError(f"unknown envelope kind {kind!r}")

    def submit_channel_op(self, ds_id: str, contents: dict) -> None:
        self._submit({"kind": "chanop", "address": ds_id, "contents": contents})

    def _submit(self, envelope: dict) -> None:
        """Record locally; send only while connected. Disconnected
        submissions replay on the next connect (the reference queues at the
        DeltaManager + replays via PendingStateManager; state here lives in
        one place). Recording MUST precede the send: with a synchronous
        in-proc service the ack can arrive inside the submit call."""
        # the delta manager's dispatch guard (ROADMAP C2), held here and
        # around the activation replay: an op the app submits on its
        # thread while the reader thread replays the pending ops is
        # either replayed with them or sent after them, never between
        with self.container.delta_manager.dispatch_guard():
            self._submit_locked(envelope)

    def _submit_locked(self, envelope: dict) -> None:
        if getattr(self.container, "readonly", False):
            # the DDS already applied the edit optimistically; a replica
            # holding a mutation that can never be submitted is corrupt,
            # so close it (the reference's readonly assert likewise kills
            # the container) — apps must gate editing on container.readonly
            self.container.close()
            raise PermissionError(
                "container is readonly: local edits are disabled")
        entry = PendingEntry(-1, envelope)
        self.pending.record_entry(entry)
        if not self.connected:
            return
        if self.flush_mode is FlushMode.TURN_BASED or self._order_depth:
            self._batch.append(entry)
        else:
            entry.client_seq = self.container.delta_manager.submit(
                MessageType.OPERATION, envelope
            )

    # ----------------------------------------------------------- batching

    def set_flush_mode(self, mode: FlushMode) -> None:
        if mode is FlushMode.IMMEDIATE:
            self.flush()  # pending batch must not straddle the switch
        self.flush_mode = mode

    def flush(self) -> None:
        """Ship the accumulated batch as one contiguous submission — one
        boxcar on the raw log, sequenced without interleaving."""
        if self._order_depth:
            return  # orderSequentially flushes at its own close
        with self.container.delta_manager.dispatch_guard():
            batch, self._batch = self._batch, []
            if not batch:
                return
            seqs = self.container.delta_manager.submit_batch(
                MessageType.OPERATION, [e.envelope for e in batch])
            for entry, seq in zip(batch, seqs):
                entry.client_seq = seq

    @contextlib.contextmanager
    def order_sequentially(self):
        """Everything submitted inside runs as ONE atomic batch (ref:
        orderSequentially containerRuntime.ts:1207). An exception closes
        the container — partially-applied optimistic local state cannot
        be rolled back, so the replica must not keep talking."""
        self._order_depth += 1
        try:
            yield
        except BaseException:
            self._order_depth -= 1
            self._batch.clear()
            self.container.close()
            raise
        self._order_depth -= 1
        if self._order_depth == 0 and self.flush_mode is FlushMode.IMMEDIATE:
            self.flush()

    def on_member_removed(self, client_id: str, seq: int = 0) -> None:
        for ds in self.data_stores.values():
            ds.on_member_removed(client_id, seq)

    # ----------------------------------------------------------- reconnect

    def set_connection_state(self, connected: bool, client_id: Optional[str]) -> None:
        with self.container.delta_manager.dispatch_guard():
            self._set_connection_state_locked(connected, client_id)

    def _set_connection_state_locked(self, connected: bool,
                                     client_id: Optional[str]) -> None:
        self.connected = connected
        if connected:
            old_client_id, self.client_id = self.client_id, client_id
            for ds in self.data_stores.values():
                ds.set_connection_state(connected, client_id)
            self._replay_pending()
        else:
            self.client_id = None
            # unflushed batch entries were never sent; they stay recorded
            # as pending and regenerate through the reconnect replay
            self._batch.clear()
            for ds in self.data_stores.values():
                ds.set_connection_state(connected, None)

    def _replay_pending(self) -> None:
        """Rebase + resubmit everything unacked (ref: replayPendingStates
        pendingStateManager.ts:301).

        Channel ops route to the channel's ``resubmit`` so the DDS can
        regenerate against current state (merge-tree rebases positions);
        attach ops resubmit verbatim. Each resubmission re-records itself
        via the normal submit path.
        """
        regenerated: set[tuple[str, str]] = set()
        for entry in self.pending.take_all():
            env = entry.envelope
            if env["kind"] == "attach" or "attach" in env.get("contents", {}):
                # data-store and channel attach ops resubmit verbatim: the
                # original (empty-state) snapshot plus the regenerated
                # content ops that follow rebuild remote replicas exactly
                self._submit(env)
            elif env["kind"] == "chanop":
                key = (env["address"], env["contents"]["address"])
                if key in regenerated:
                    continue  # this channel already regenerated all pending
                regenerated.add(key)
                ds = self.data_stores[env["address"]]
                ds.resubmit_channel(env["contents"]["address"])

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        return {
            "dataStores": {
                ds_id: {"pkg": ds.pkg, "snapshot": ds.snapshot()}
                for ds_id, ds in self.data_stores.items()
            }
        }

    def summarize(self, parent_capture_seq=None):
        """Recursive SummaryTree over stores → channels with handle reuse
        (ref: ContainerRuntime.summarize containerRuntime.ts:1424). The
        tree materializes back into exactly ``snapshot()``'s dict shape,
        so boot needs no incremental-aware path."""
        from ..protocol.summary import SummaryTree

        return SummaryTree(tree={
            "dataStores": SummaryTree(tree={
                ds_id: ds.summarize(
                    f"runtime/dataStores/{ds_id}", parent_capture_seq)
                for ds_id, ds in self.data_stores.items()
            })
        })

    def load_snapshot(self, snap: dict, base_seq: int = 0) -> None:
        for ds_id, entry in snap.get("dataStores", {}).items():
            ds = DataStoreRuntime(self, ds_id, entry["pkg"])
            ds.load_snapshot(entry["snapshot"], base_seq)
            self.data_stores[ds_id] = ds
