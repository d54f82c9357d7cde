"""Partition runtime: hosts, partitions, rebalance (the lambdas-driver).

JAX counterpart: ``fluidframework_tpu/service/partitions.py``; the port's
copy of ``partition_of``, ``Partition`` and ``PartitionManager``, imports
rebased to this package.

Ref: server/routerlicious/packages/lambdas-driver — KafkaRunner starts a
PartitionManager (kafka-service/partitionManager.ts:22) which owns one
Partition per Kafka partition (partition.ts:24); documents hash onto
partitions; a consumer-group rebalance (partitionManager.ts:93-111)
checkpoints and closes the partitions that move away and recreates them
on their new host from the stored checkpoint. The document-router demuxes
each partition into per-document lambdas.

Here: a :class:`PartitionManager` spreads N partitions over registered
hosts and routes each ``(tenant, doc)`` to its partition's host. Each
:class:`Partition` lazily builds the per-document pipeline (LocalOrderer:
real deli/scribe/scriptorium/broadcaster over the shared log). Moving a
partition checkpoints every document pipeline it owns and closes it; the
next host resumes from those checkpoints, and deli's log-offset
idempotency absorbs replayed raw records. ``remove_host`` (crash
recovery) skips the graceful checkpoint — recovery leans entirely on the
last durable checkpoint + raw-log replay.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from .local_orderer import LocalOrderer


def partition_of(tenant_id: str, document_id: str, n_partitions: int) -> int:
    key = f"{tenant_id}/{document_id}".encode()
    return int.from_bytes(hashlib.sha1(key).digest()[:4], "little") \
        % n_partitions


class Partition:
    """One partition's per-document pipelines on its current host."""

    #: chaos seam (fluidframework_tpu/chaos): a crash mid-checkpoint —
    #: some orderers checkpointed, the rest not — the partial-progress
    #: window a rebalance-during-crash exposes. None = disarmed.
    fault_plane = None

    def __init__(self, pid: int, log, db, pubsub, clock=None):
        self.pid = pid
        self._log = log
        self._db = db
        self._pubsub = pubsub
        self._clock = clock
        self.orderers: dict[str, LocalOrderer] = {}

    def orderer(self, tenant_id: str, document_id: str) -> LocalOrderer:
        key = f"{tenant_id}/{document_id}"
        o = self.orderers.get(key)
        if o is None:
            kw = {}
            if self._clock is not None:
                kw["clock"] = self._clock
            o = self.orderers[key] = LocalOrderer(
                tenant_id, document_id, self._log, self._db, self._pubsub,
                **kw)
        return o

    def checkpoint(self) -> None:
        """Checkpoint every doc pipeline. One raising orderer must not
        abort the rest — every doc that CAN shrink its replay window
        does; each failure is journaled and the first re-raises at the
        end so callers still see it."""
        first_err = None
        for key, o in self.orderers.items():
            if self.fault_plane is not None:
                # kill between one doc's checkpoint and the next: the
                # un-checkpointed docs recover by raw-log replay
                self.fault_plane("partition.checkpoint", pid=self.pid)
            try:
                o.checkpoint()
            except Exception as e:  # noqa: BLE001 — isolate per doc
                self._note_checkpoint_fail(key, e)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def _note_checkpoint_fail(self, key: str, err: Exception) -> None:
        from ..obs.journal import get_journal

        get_journal().emit("part.checkpoint_fail",
                           cause=f"{type(err).__name__}: {err}",
                           pid=self.pid, doc=key)

    def close(self, graceful: bool = True) -> None:
        """Graceful close checkpoints first (rebalance); a crash close
        (graceful=False) just detaches — recovery is checkpoint+replay.
        A failing checkpoint never strands the remaining docs: every
        orderer still checkpoints (best effort) AND closes, then the
        first checkpoint error re-raises."""
        first_err = None
        for key, o in self.orderers.items():
            if graceful:
                try:
                    o.checkpoint()
                except Exception as e:  # noqa: BLE001 — isolate per doc
                    self._note_checkpoint_fail(key, e)
                    if first_err is None:
                        first_err = e
            o.close()
        self.orderers.clear()
        if first_err is not None:
            raise first_err


class PartitionHost:
    """One process/VM's share of the partition space (KafkaRunner role)."""

    def __init__(self, host_id: str, log, db, pubsub, clock=None):
        self.host_id = host_id
        self._log = log
        self._db = db
        self._pubsub = pubsub
        self._clock = clock
        self.partitions: dict[int, Partition] = {}

    def assign(self, pid: int) -> Partition:
        if pid not in self.partitions:
            self.partitions[pid] = Partition(
                pid, self._log, self._db, self._pubsub, self._clock)
        return self.partitions[pid]

    def release(self, pid: int, graceful: bool = True) -> None:
        part = self.partitions.pop(pid, None)
        if part is not None:
            part.close(graceful)


class PartitionManager:
    """Spreads partitions over hosts; routes and rebalances.

    Ref: partitionManager.ts:22 (ownership), :93-111 (rebalance). The
    assignment is deterministic round-robin over the sorted host list so
    every participant computes the same map.
    """

    def __init__(self, n_partitions: int, log, db, pubsub, clock=None):
        self.n_partitions = n_partitions
        self._log = log
        self._db = db
        self._pubsub = pubsub
        self._clock = clock
        self.hosts: dict[str, PartitionHost] = {}
        self.assignment: dict[int, str] = {}  # pid → host_id

    # ---------------------------------------------------------- membership

    def add_host(self, host_id: str) -> PartitionHost:
        host = PartitionHost(host_id, self._log, self._db, self._pubsub,
                             self._clock)
        self.hosts[host_id] = host
        self._rebalance(graceful=True)
        return host

    def remove_host(self, host_id: str, crashed: bool = False) -> None:
        host = self.hosts.pop(host_id, None)
        if host is not None:
            for pid in list(host.partitions):
                host.release(pid, graceful=not crashed)
        self._rebalance(graceful=not crashed)

    def _rebalance(self, graceful: bool) -> None:
        if not self.hosts:
            self.assignment.clear()
            return
        order = sorted(self.hosts)
        want = {pid: order[pid % len(order)]
                for pid in range(self.n_partitions)}
        for pid, new_host in want.items():
            old_host = self.assignment.get(pid)
            if old_host == new_host:
                continue
            if old_host in self.hosts:
                # the moving partition checkpoints + closes on its old
                # host; the new host resumes lazily from the checkpoint
                self.hosts[old_host].release(pid, graceful)
            self.assignment[pid] = new_host
        self.rebalances = getattr(self, "rebalances", 0) + 1

    # ------------------------------------------------------------- routing

    def host_of(self, tenant_id: str, document_id: str) -> PartitionHost:
        pid = partition_of(tenant_id, document_id, self.n_partitions)
        return self.hosts[self.assignment[pid]]

    def order(self, raw) -> None:
        """Route a raw record to the owning partition's document pipeline
        (the front door's connection.order())."""
        host = self.host_of(raw.tenant_id, raw.document_id)
        pid = partition_of(raw.tenant_id, raw.document_id,
                           self.n_partitions)
        host.assign(pid).orderer(raw.tenant_id, raw.document_id).order(raw)

    def checkpoint_all(self) -> None:
        for host in self.hosts.values():
            for part in host.partitions.values():
                part.checkpoint()
