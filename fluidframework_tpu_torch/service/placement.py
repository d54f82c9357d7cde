"""Lease-based doc-partition placement for the sharded ordering core.

JAX counterpart: ``fluidframework_tpu/service/placement.py``; the port's
copy of the flock'd partition leases (``PlacementDir``), imports rebased
to this package.

Ref: memory-orderer/src/reservationManager.ts:21 — the reference's
multi-node orderer takes Mongo lease reservations on documents and
proxies connections to the owner node (remoteNode.ts:92). Here the unit
of ownership is the doc PARTITION (``stage_runner.doc_partition`` —
md5(doc) mod N, the same stable map the pipeline stages shard by), and
the registry is a shared lease DIRECTORY: one file per partition,
heartbeat by mtime, atomic takeover by rename. A partition's lease names
its owner's client-facing address, which is also the key to its durable
state: partition k's log lives in ``<shard_dir>/log-<k>``, so whoever
holds the lease resumes the partition's pipeline from its checkpoints —
ownership and durability move together.

Liveness: owners touch their lease every ``heartbeat_s``; a lease older
than ``ttl_s`` is STALE and any core may take it over. Takeover is an
atomic rename, so two racing claimants cannot both win (the loser's
rename replaces the winner's file only if it also observed staleness
within the same race window — the subsequent ``owner_of`` read settles
on one file content, and the heartbeat loop self-corrects: a core that
reads another owner's id in its supposed lease drops the partition).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Optional

from ..utils.affinity import holds_lock

DEFAULT_TTL_S = 3.0


class PlacementDir:
    """Shared-directory lease registry over ``n_partitions`` partitions."""

    def __init__(self, directory: str, n_partitions: int,
                 ttl_s: float = DEFAULT_TTL_S):
        self.directory = directory
        self.n = n_partitions
        self.ttl_s = ttl_s
        os.makedirs(directory, exist_ok=True)

    def _path(self, k: int) -> str:
        return os.path.join(self.directory, f"part-{k}.lease")

    def _read(self, k: int) -> Optional[dict]:
        try:
            with open(self._path(k)) as f:
                rec = json.load(f)
            rec["_age"] = time.time() - os.stat(self._path(k)).st_mtime
            return rec
        except (OSError, json.JSONDecodeError):
            return None

    # ------------------------------------------------------------- owners

    def _lock(self, k: int):
        """flock-serialized claim critical section: two racing claimants
        cannot both observe staleness and both install their lease (the
        rename-and-reread scheme allowed exactly that). The lock file is
        separate from the lease so readers never block."""
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def held():
            fd = os.open(self._path(k) + ".lock",
                         os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
        return held()

    @holds_lock("partition_claim_flock")
    def try_claim(self, k: int, owner_id: str, address: str) -> bool:
        """Claim partition ``k`` if it is unowned or its lease is stale.
        Returns True when this owner holds the lease afterwards."""
        with self._lock(k):
            cur = self._read(k)
            if cur is not None and cur.get("owner") != owner_id \
                    and cur["_age"] < self.ttl_s:
                return False  # live lease held by someone else
            fd, tmp = tempfile.mkstemp(dir=self.directory,
                                       prefix=".lease-")
            with os.fdopen(fd, "w") as f:
                json.dump({"owner": owner_id, "address": address}, f)
            os.replace(tmp, self._path(k))
            return True

    @holds_lock("partition_claim_flock")
    def heartbeat(self, k: int, owner_id: str) -> bool:
        """Refresh the lease mtime; returns False if the lease was lost
        (taken over) — the caller must stop serving the partition.

        Read-check-utime runs under the SAME flock as try_claim: a
        stalled ex-owner whose heartbeat resumes mid-takeover would
        otherwise re-read its own (stale) lease, then utime the file the
        claimant just replaced — two cores each believing they hold the
        lease (the two-writer window)."""
        with self._lock(k):
            cur = self._read(k)
            if cur is None or cur.get("owner") != owner_id:
                return False
            os.utime(self._path(k))
            return True

    @holds_lock("partition_claim_flock")
    def transfer(self, k: int, from_owner: str, to_owner: str,
                 to_address: str) -> bool:
        """Migration handoff: atomically rewrite ``k``'s lease from
        ``from_owner`` to ``to_owner`` under the claim flock. Unlike
        release-then-claim there is NO unowned window a third core could
        steal, and unlike ``try_claim`` it succeeds while the source's
        lease is still FRESH — the source consents by naming itself.
        Returns False (and changes nothing) if the lease is no longer
        ``from_owner``'s (it crashed and was taken over mid-handoff)."""
        with self._lock(k):
            cur = self._read(k)
            if cur is None or cur.get("owner") != from_owner:
                return False
            fd, tmp = tempfile.mkstemp(dir=self.directory,
                                       prefix=".lease-")
            with os.fdopen(fd, "w") as f:
                json.dump({"owner": to_owner, "address": to_address}, f)
            os.replace(tmp, self._path(k))
            return True

    @holds_lock("partition_claim_flock")
    def release(self, k: int, owner_id: str) -> None:
        # same flock as try_claim/heartbeat: a release racing a takeover
        # must not unlink the NEW owner's lease after a stale read
        with self._lock(k):
            cur = self._read(k)
            if cur is not None and cur.get("owner") == owner_id:
                try:
                    os.unlink(self._path(k))
                except OSError:
                    pass

    # ------------------------------------------------------------ routers

    def owner_of(self, k: int) -> Optional[str]:
        """The owning core's address, or None (unowned / stale lease)."""
        cur = self._read(k)
        if cur is None or cur["_age"] >= self.ttl_s:
            return None
        return cur.get("address")

    def table(self) -> dict[int, Optional[str]]:
        return {k: self.owner_of(k) for k in range(self.n)}
