"""Placement control plane: epoch-numbered routing + live doc migration.

JAX counterpart: ``fluidframework_tpu/service/placement_plane.py``; the
port's copy of the epoch table, routing cache, migration engine and
``admin_rpc``, imports rebased to this package.

Ref: memory-orderer/src/reservationManager.ts (lease reservations) and
the Kafka partition-reassignment protocol the reference inherits for
free — here an explicit subsystem over the flock-leased
``PlacementDir`` (service/placement.py):

- :class:`EpochTable` — a shard-dir routing table (``placement/
  table.json``) stamped with a monotone global epoch. Every ownership
  change (claim, release, migration transfer) bumps the epoch under one
  flock, so ANY two table states are ordered and a router can discard
  stale routes by comparing integers instead of re-reading leases.
- :class:`RoutingCache` — the gateway-side view: an in-memory dict on
  the hot path (no per-request lease reads), refreshed from the epoch
  table on miss and PATCHED by ``fplacement`` pushes from the cores on
  migration; an older epoch can never overwrite a newer route.
- :class:`MigrationEngine` — moves a live partition between cores
  without losing, duplicating or reordering a single op: seal → fence →
  checkpoint → handoff (atomic lease transfer, no unowned window) →
  epoch bump. In-flight submits bounce on the shed-retry lane and
  resubmit in client-sequence order against the new owner.

Fencing is layered: the seal refuses submits at the front door, the
lease-freshness clock refuses a stalled ex-owner, and deli's admission
refuses any record whose partition epoch is older than the table's
(``DeliLambda.epoch_fence``) — a doc mid-migration is sequenced by
exactly one core, provably.

The engine's ``fault_plane`` seam (class attribute, ``None`` by
default, same duck-typing as service/partitions.py) exposes the three
crash windows the chaos campaign kills: ``placement.pre_fence``,
``placement.pre_handoff``, ``placement.post_handoff``.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import time
from typing import Callable, Optional

from ..obs import get_journal, tier_counters
from ..utils.affinity import blocking, holds_lock, loop_only
from .placement import PlacementDir

#: subdirectory of the shard dir holding the routing table
TABLE_DIRNAME = "placement"

#: core membership states in the table's ``cores`` section (elastic
#: membership, ref: consumer-group join/leave): ``active`` serves and
#: may receive rebalanced partitions, ``draining`` is being emptied by
#: live migration (``admin placement drain``), ``drained`` owns nothing
#: and is safe to decommission.
CORE_ACTIVE = "active"
CORE_DRAINING = "draining"
CORE_DRAINED = "drained"

_SHARED_COUNTERS = None


def placement_counters():
    """The module-held placement ``Counters`` for per-event seam call
    sites (deli's epoch fence, the front end's redirect bounces). Those
    sites must not mint a fresh ``tier_counters`` instance per event:
    the metrics registry tracks instances weakly, and a temporary dies
    before the next scrape ever sees its counts."""
    global _SHARED_COUNTERS
    if _SHARED_COUNTERS is None:
        _SHARED_COUNTERS = tier_counters("placement")
    return _SHARED_COUNTERS


def _flock(path: str):
    @contextlib.contextmanager
    def held():
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)
    return held()


class EpochTable:
    """Epoch-stamped doc→core routing table, one JSON file per shard dir.

    The table is a routing VIEW with total epoch order; the lease
    directory stays the liveness truth. A reader holding a stale table
    falls back to a lease read (``RoutingCache.refresh``), so a crash
    between a lease claim and the table write is merely a cache miss,
    never a wrong route that sticks.
    """

    def __init__(self, directory: str, counters=None, journal=None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "table.json")
        self._lock_path = os.path.join(directory, "table.lock")
        self.counters = (counters if counters is not None
                         else tier_counters("placement"))
        # audit journal: disarmed singleton by default (free), or an
        # injected per-core instance (in-proc multi-core tests)
        self.journal = journal if journal is not None else get_journal()
        self._cache: Optional[dict] = None
        self._cache_stamp = None

    @classmethod
    def for_shard_dir(cls, shard_dir: str, counters=None) -> "EpochTable":
        return cls(os.path.join(shard_dir, TABLE_DIRNAME), counters=counters)

    # ------------------------------------------------------------- readers

    def read(self) -> dict:
        """Current table (mtime-cached): ``{"epoch": N, "parts":
        {"<k>": {"owner", "addr", "epoch"}}}``."""
        try:
            st = os.stat(self.path)
            stamp = (st.st_ino, st.st_mtime_ns, st.st_size)
        except OSError:
            return {"epoch": 0, "parts": {}}
        if self._cache is not None and stamp == self._cache_stamp:
            return self._cache
        rec = self._read_fresh()
        self._cache, self._cache_stamp = rec, stamp
        return rec

    def _read_fresh(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"epoch": 0, "parts": {}}

    def global_epoch(self) -> int:
        return self.read()["epoch"]

    def epoch_of(self, k: int) -> int:
        part = self.read()["parts"].get(str(k))
        return part["epoch"] if part else 0

    def addr_of(self, k: int) -> Optional[str]:
        part = self.read()["parts"].get(str(k))
        return part["addr"] if part else None

    def part_epochs(self) -> dict[int, int]:
        """``{k: epoch}`` for every routed partition — the ShardHost
        refreshes its in-memory fence view from this once per poll."""
        return {int(k): p["epoch"]
                for k, p in self.read()["parts"].items()}

    def cores(self) -> dict:
        """Core membership: ``{owner: {"addr", "state"}}``. Registration
        is the ShardHost's per-poll ``record_core``; the rebalancer reads
        this to know which cores exist (cold joiners included — a fresh
        member owns nothing, so ``parts`` alone can't see it)."""
        return self.read().get("cores", {})

    def core_state(self, owner: str) -> Optional[str]:
        row = self.cores().get(owner)
        return row["state"] if row else None

    # ------------------------------------------------------------- writers

    def _write(self, rec: dict) -> None:
        d = os.path.dirname(self.path)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".table-")
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    @holds_lock("epoch_table_flock")
    def record_claim(self, k: int, owner: str, addr: str,
                     cause: Optional[str] = None) -> int:
        """Record that ``owner@addr`` now serves partition ``k`` (initial
        claim, takeover, or migration adoption). Returns the new epoch.
        ``cause`` links the journal's ``epoch.bump`` to the event that
        drove the ownership change (a migration adopt, a takeover)."""
        with _flock(self._lock_path):
            rec = self._read_fresh()
            rec["epoch"] += 1
            rec["parts"][str(k)] = {
                "owner": owner, "addr": addr, "epoch": rec["epoch"]}
            self._write(rec)
        self.counters.inc("placement.epoch.bumps")
        self.journal.emit("epoch.bump", cause=cause, epoch=rec["epoch"],
                          part=k, owner=owner, addr=addr, change="claim")
        return rec["epoch"]

    @holds_lock("epoch_table_flock")
    def record_release(self, k: int, owner: str,
                       cause: Optional[str] = None) -> Optional[int]:
        """Drop ``k``'s route if ``owner`` still holds it; the bump makes
        the removal itself ordered (a cached route older than the release
        epoch is discardable)."""
        with _flock(self._lock_path):
            rec = self._read_fresh()
            part = rec["parts"].get(str(k))
            if part is None or part["owner"] != owner:
                return None
            rec["epoch"] += 1
            del rec["parts"][str(k)]
            self._write(rec)
        self.counters.inc("placement.epoch.bumps")
        self.journal.emit("epoch.bump", cause=cause, epoch=rec["epoch"],
                          part=k, owner=owner, change="release")
        return rec["epoch"]

    @holds_lock("epoch_table_flock")
    def record_core(self, owner: str, addr: str,
                    host: Optional[str] = None) -> None:
        """Register ``owner@addr`` as a member (ShardHost calls this once
        per poll — cheap no-op when the row already matches). Membership
        is a capacity advertisement, not a route: nothing fences on it,
        so it does NOT bump the epoch. An existing draining/drained mark
        survives re-registration — the drain decision outlives the
        core's own heartbeat. ``host`` is the member's host-group id
        (multi-host fleets): the rebalancer's locality tiebreak and the
        gateways' same-host accounting read it back from the row."""
        row = self.cores().get(owner)
        if row is not None and row["addr"] == addr \
                and row.get("host") == host:
            return
        with _flock(self._lock_path):
            rec = self._read_fresh()
            cores = rec.setdefault("cores", {})
            prev = cores.get(owner)
            cores[owner] = {
                "addr": addr,
                "state": prev["state"] if prev else CORE_ACTIVE}
            if host is not None:
                cores[owner]["host"] = host
            self._write(rec)

    @holds_lock("epoch_table_flock")
    def set_core_state(self, owner: str, state: str,
                       cause: Optional[str] = None) -> bool:
        """Flip a member's state (``admin placement drain``, or the
        rebalancer marking a drained core). False for unknown owners —
        draining a core that never registered is an operator typo, not
        a pending instruction."""
        changed = False
        with _flock(self._lock_path):
            rec = self._read_fresh()
            row = rec.get("cores", {}).get(owner)
            if row is None:
                return False
            if row["state"] != state:
                row["state"] = state
                self._write(rec)
                changed = True
        if changed:
            self.journal.emit("core.state", cause=cause,
                             epoch=rec["epoch"], owner=owner, state=state)
        return True

    @holds_lock("epoch_table_flock")
    def remove_core(self, owner: str, cause: Optional[str] = None) -> None:
        """Forget a decommissioned member entirely."""
        removed = False
        with _flock(self._lock_path):
            rec = self._read_fresh()
            if rec.get("cores", {}).pop(owner, None) is not None:
                self._write(rec)
                removed = True
        if removed:
            self.journal.emit("core.state", cause=cause,
                              epoch=rec["epoch"], owner=owner,
                              state="removed")


class RoutingCache:
    """Gateway-side doc→core routing: dict lookup on the hot path.

    Replaces per-request ``PlacementDir.owner_of`` reads. Misses refresh
    from the epoch table (one mtime-cached file read), falling back to a
    lease read for partitions the table hasn't seen; ``fplacement``
    pushes from the cores patch entries the moment a migration commits.
    Epoch-stamped invalidation: an update only lands if its epoch is
    newer than the cached one, so a delayed push about yesterday's owner
    cannot clobber today's route.
    """

    def __init__(self, placement: PlacementDir, table: EpochTable,
                 counters=None):
        self.placement = placement
        self.table = table
        self.counters = (counters if counters is not None
                         else tier_counters("placement"))
        self.addrs: dict[int, Optional[str]] = {}
        self.epochs: dict[int, int] = {}

    def resolve(self, k: int) -> Optional[str]:
        addr = self.addrs.get(k)
        if addr is not None:
            self.counters.inc("placement.cache.hits")
            return addr
        return self.refresh(k)

    def refresh(self, k: int) -> Optional[str]:
        """Re-read ``k``'s route: epoch table first, lease directory as
        the liveness fallback (covers the claim→table-write crash gap and
        pre-epoch-table deployments)."""
        self.counters.inc("placement.cache.refreshes")
        part = self.table.read()["parts"].get(str(k))
        if part is not None and part["epoch"] >= self.epochs.get(k, 0):
            self._store(k, part["addr"], part["epoch"])
            return part["addr"]
        addr = self.placement.owner_of(k)
        if addr is not None:
            self._store(k, addr, self.epochs.get(k, 0))
        return addr

    def note_epoch(self, k: int, addr: Optional[str], epoch: int) -> bool:
        """Apply a pushed route (``fplacement``) iff it is newer than the
        cached epoch. Returns True when the route changed."""
        if epoch <= self.epochs.get(k, 0):
            return False
        self._store(k, addr, epoch)
        return True

    def invalidate(self, k: int) -> None:
        """Dial failure against the cached address: drop the route (the
        epoch stays, so only a NEWER route can repopulate via push)."""
        self.addrs.pop(k, None)
        self.counters.inc("placement.cache.invalidations")

    def _store(self, k: int, addr: Optional[str], epoch: int) -> None:
        if addr is None:
            self.addrs.pop(k, None)
        else:
            self.addrs[k] = addr
        self.epochs[k] = epoch


class MigrationEngine:
    """Live migration of one partition between two cores.

    Source-side protocol (:meth:`migrate`):

    1. **seal** — the source's LocalServer refuses new submits; the front
       end bounces them on the shed-retry lane (echoed op +
       ``retry_after_ms``), so drivers park and resubmit in cseq order.
    2. **fence** — record each live doc's deli sequence number; the
       ordering loop is single-threaded, so after the seal nothing new
       can be ticketed and these are exact.
    3. **checkpoint** — ``checkpoint_all`` + durable-log flush: the deli/
       scribe state the target resumes from (the same machinery
       partitions.py uses for crash recovery). The raw-log tail past the
       checkpoint replays idempotently on the target.
    4. **handoff** — the target adopts: atomic lease TRANSFER under the
       partition flock (owner rewritten in place — no unowned window a
       third core could steal), epoch-table claim, server rebuild.
    5. **flip** — the source pushes the new route (``fplacement``) and
       drops the partition's sessions; clients reconnect and land on the
       target via the refreshed routing cache.

    A source crash anywhere in this sequence is the chaos campaign's
    subject: before the fence the migration simply never happened (lease
    TTL takeover recovers); after the handoff the target already owns the
    log. The engine never holds both cores' state — the target side is
    :meth:`adopt`, reachable in-proc (tests, chaos) or over the admin
    plane (``admin_adopt_partition``).
    """

    #: chaos seam (duck-typed FaultPlane), None when disarmed
    fault_plane = None

    def __init__(self, host, counters=None, journal=None):
        # ``host`` is duck-typed (front_end.ShardHost): owner_id, address,
        # placement, table, servers, hb_times, claim_epochs, table_epochs,
        # migrating, _make_server(k)
        self.host = host
        self.counters = (counters if counters is not None
                         else tier_counters("placement"))
        self.journal = journal if journal is not None else get_journal()
        self._adopt_cause: Optional[str] = None
        self._adopt_log_blob: Optional[str] = None

    # -------------------------------------------------------------- source

    @loop_only("core")
    def migrate(self, k: int, target_addr: str,
                adopt: Optional[Callable[[int, str], dict]] = None,
                on_flip: Optional[Callable] = None,
                cause: Optional[str] = None) -> dict:
        """Move partition ``k`` from this host to ``target_addr``.

        ``adopt(k, from_owner)`` performs the target side; defaults to an
        ``admin_adopt_partition`` RPC against ``target_addr``. ``on_flip``
        (if given) runs after the epoch bump with ``(k, target_addr,
        epoch, server)`` — the front end uses it to push ``fplacement``
        and drop the partition's live sessions. ``cause`` roots the
        journal chain (the rebalance actuation or operator command that
        asked for the move); every phase then links to the previous
        one, and the cause id crosses to the target over the adopt RPC,
        so the fleet-merged journal shows one connected chain:
        cause → seal → fence → checkpoint → adopt → epoch bump → commit.
        """
        host = self.host
        server = host.servers.get(k)
        if server is None:
            raise RuntimeError(f"not the owner of partition {k}")
        if k in host.migrating:
            raise RuntimeError(f"partition {k} already migrating")
        host.migrating.add(k)
        jr = self.journal
        try:
            if self.fault_plane is not None:
                self.fault_plane("placement.pre_fence", k=k)
            # 1. seal: submits bounce from here on (front-end shed nacks)
            server.seal()
            seal_id = jr.emit("migration.seal", cause=cause, part=k,
                              target=target_addr)
            # 2. fence seqs: drain queued raw records first, then they are
            # exact — sealed + single-threaded means nothing is in flight
            server.drain()
            fences = server.doc_sequence_numbers()
            fence_id = jr.emit("migration.fence", cause=seal_id, part=k,
                               docs=len(fences))
            # 3. checkpoint + flush: the state the target resumes from
            server.checkpoint_all()
            flush = getattr(server.log, "flush", None)
            if flush is not None:
                flush()
            self.counters.inc("placement.migration.fences")
            ckpt_id = jr.emit("migration.checkpoint", cause=fence_id,
                              part=k)
            if self.fault_plane is not None:
                self.fault_plane("placement.pre_handoff", k=k)
            # stop heartbeating/serving k BEFORE the transfer: the lease
            # stays ours (fresh) until the target rewrites it in place
            host.hb_times.pop(k, None)
            host.servers.pop(k, None)
            server.revoke()
            # cross-host handoff: the flushed log dir lives in THIS host
            # group's disjoint working dir, so ship it through the shared
            # storage tier — the target then resumes from exactly the
            # checkpoint + idempotent tail a shared filesystem would give
            log_blob = self._ship_log(k, target_addr, cause=ckpt_id)
            # 4. handoff: the target transfers the lease + claims the epoch
            do_adopt = adopt if adopt is not None else self._rpc_adopt
            self._adopt_cause = ckpt_id
            self._adopt_log_blob = log_blob
            try:
                result = do_adopt(k, target_addr)
            except Exception as exc:
                jr.emit("migration.fail", cause=ckpt_id, part=k,
                        target=target_addr, error=str(exc))
                self._reclaim(k)
                raise
            finally:
                self._adopt_cause = None
                self._adopt_log_blob = None
            if self.fault_plane is not None:
                # the "source dies during target replay" window: the
                # target owns the lease + epoch; the source merely fails
                # to push the flip (clients discover via reconnect)
                self.fault_plane("placement.post_handoff", k=k)
            epoch = result["epoch"]
            self.counters.inc("placement.migration.committed")
            jr.emit("migration.commit",
                    cause=result.get("journal") or ckpt_id, part=k,
                    target=target_addr, epoch=epoch)
            # 5. flip: push the new route, drop the sealed sessions
            if on_flip is not None:
                on_flip(k, target_addr, epoch, server)
            return {"k": k, "target": target_addr, "epoch": epoch,
                    "fences": fences}
        finally:
            host.migrating.discard(k)

    def _reclaim(self, k: int) -> None:
        """Adoption failed before the lease moved: the lease is still
        ours, so rebuild the partition server and resume serving."""
        host = self.host
        self.counters.inc("placement.migration.failed")
        if host.placement.try_claim(k, host.owner_id, host.address):
            host.claim_epochs[k] = host.table.record_claim(
                k, host.owner_id, host.address)
            host.servers[k] = host._make_server(k)
            host.hb_times[k] = time.monotonic()

    def _host_of_addr(self, addr: str) -> Optional[str]:
        """The host-group id advertising ``addr`` in the table's cores
        section, or None (single-host fleet / unregistered core)."""
        for row in self.host.table.cores().values():
            if row.get("addr") == addr:
                return row.get("host")
        return None

    @loop_only("core")
    def _ship_log(self, k: int, target_addr: str,
                  cause: Optional[str] = None) -> Optional[str]:
        """When the target core lives in ANOTHER host group, upload the
        (sealed, flushed) ``log-<k>`` dir to the shared storage tier as
        one blob and return its id for the adopt frame. Same-host and
        single-host moves return None — the shared dir IS the transport
        there, exactly as before."""
        my_host = getattr(self.host, "host_id", None)
        if my_host is None:
            return None
        dst_host = self._host_of_addr(target_addr)
        if dst_host is None or dst_host == my_host:
            return None
        storage = getattr(self.host, "storage_server", None)
        if storage is None:
            raise RuntimeError(
                f"cross-host migration of partition {k} needs a storage "
                "tier to ship the durable log through")
        import io
        import tarfile

        log_dir = os.path.join(self.host.shard_dir, f"log-{k}")
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            tf.add(log_dir, arcname=".")
        s_host, s_port = storage
        reply = admin_rpc(s_host, int(s_port),
                          {"t": "write_blob", "hex": buf.getvalue().hex()})
        self.journal.emit("migration.ship", cause=cause, part=k,
                          src_host=my_host, dst_host=dst_host,
                          blob=reply["id"], bytes=buf.getbuffer().nbytes)
        return reply["id"]

    def _fetch_log(self, k: int, log_blob: str) -> None:
        """Target side of the ship: replace the local ``log-<k>`` dir
        with the shipped one (any content there is a dead generation —
        the partition's live log just arrived)."""
        import io
        import shutil
        import tarfile

        storage = getattr(self.host, "storage_server", None)
        if storage is None:
            raise RuntimeError(
                f"adopting partition {k} with a shipped log needs a "
                "storage tier")
        s_host, s_port = storage
        reply = admin_rpc(s_host, int(s_port),
                          {"t": "read_blob", "id": log_blob})
        log_dir = os.path.join(self.host.shard_dir, f"log-{k}")
        shutil.rmtree(log_dir, ignore_errors=True)
        os.makedirs(log_dir, exist_ok=True)
        buf = io.BytesIO(bytes.fromhex(reply["hex"]))
        with tarfile.open(fileobj=buf, mode="r:gz") as tf:
            try:
                tf.extractall(log_dir, filter="data")
            except TypeError:  # filter= needs py3.12; our own archive
                tf.extractall(log_dir)  # noqa: S202

    @loop_only("core")
    def _rpc_adopt(self, k: int, target_addr: str) -> dict:
        """Default target-side handoff: one blocking admin RPC against the
        target core (uniform deployments share the admin secret)."""
        host_s, _, port_s = target_addr.rpartition(":")
        frame = {"t": "admin_adopt_partition", "k": k,
                 "from_owner": self.host.owner_id}
        if self._adopt_cause:
            # the cause id crosses the wire so the TARGET core's journal
            # links its adopt entry back to the source's checkpoint —
            # the fleet merge stitches the chain across processes
            frame["journal_cause"] = self._adopt_cause
        if self._adopt_log_blob:
            frame["log_blob"] = self._adopt_log_blob
        secret = getattr(self.host, "admin_secret", None)
        if secret:
            frame["secret"] = secret
        return admin_rpc(host_s or "127.0.0.1", int(port_s), frame)

    # -------------------------------------------------------------- target

    @loop_only("core")
    def adopt(self, k: int, from_owner: str, cause: Optional[str] = None,
              log_blob: Optional[str] = None) -> dict:
        """Target side: take over ``k`` from ``from_owner`` and resume its
        pipeline from the shipped checkpoint + idempotent raw-log tail.
        ``log_blob`` (cross-host moves) names the storage-tier blob
        carrying the source's sealed log dir; it is materialized BEFORE
        the lease transfer so a fetch failure aborts the handoff while
        the source can still reclaim."""
        host = self.host
        if log_blob:
            self._fetch_log(k, log_blob)
        if not host.placement.transfer(k, from_owner, host.owner_id,
                                       host.address):
            if log_blob:
                import shutil

                shutil.rmtree(
                    os.path.join(host.shard_dir, f"log-{k}"),
                    ignore_errors=True)
            raise RuntimeError(
                f"partition {k} not transferable from {from_owner}")
        adopt_id = self.journal.emit("migration.adopt", cause=cause,
                                     part=k, from_owner=from_owner)
        epoch = host.table.record_claim(k, host.owner_id, host.address,
                                        cause=adopt_id)
        host.claim_epochs[k] = epoch
        host.table_epochs[k] = epoch
        server = host._make_server(k)
        host.servers[k] = server
        host.hb_times[k] = time.monotonic()
        self.counters.inc("placement.migration.adopted")
        return {"epoch": epoch, "journal": adopt_id}


@blocking("synchronous socket dial + rid round trip — the loopback "
          "migration/actuation seam; never call on the loop "
          "unless the synchrony IS the design")
def admin_rpc(host: str, port: int, frame: dict,
              timeout: float = 30.0) -> dict:
    """One rid-matched admin RPC round trip (length-prefixed JSON — the
    same wire shape bench.py and the admin CLI use)."""
    import socket

    with socket.create_connection((host, port), timeout=timeout) as s:
        body = json.dumps(dict(frame, rid=1)).encode()
        s.sendall(len(body).to_bytes(4, "big") + body)

        def read_exactly(n):
            buf = b""
            while len(buf) < n:
                chunk = s.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            return buf

        while True:
            n = int.from_bytes(read_exactly(4), "big")
            reply = json.loads(read_exactly(n).decode())
            if reply.get("rid") != 1:
                continue
            if reply.get("t") == "error":
                raise RuntimeError(reply.get("message"))
            return reply
