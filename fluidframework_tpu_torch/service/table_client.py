"""Networked placement plane: the ``TableClient`` local/remote split.

JAX counterpart: ``fluidframework_tpu/service/table_client.py``; the
port's copy of the placement table seam (local and remote) and the storage
server's table door, imports rebased to this package.

Ref: memory-orderer/src/reservationManager.ts — the reference's lease
reservations live in Mongo, a NETWORK service, so any orderer node on
any machine can take one. Our ``PlacementDir``/``EpochTable`` pair is
strictly stronger on one box (flock-serialized claims, monotone global
epoch) but both assume a shared filesystem. This module splits every
consumer onto a ``TableClient`` interface with two implementations:

- :class:`LocalTableClient` — binds the raw flock-backed
  ``PlacementDir`` + ``EpochTable`` objects as-is. ZERO indirection:
  ``client.leases`` IS the ``PlacementDir`` and ``client.table`` IS the
  ``EpochTable``, so the single-host hot path pays nothing for the
  split (the knee A/B acceptance gate).
- :class:`RemoteTableClient` — RPC proxies speaking the
  ``admin_table_*`` frame family against the **table door**
  (:class:`TableDoorService`, served next to the storage tier on the
  placement host). Every WRITE still lands under the placement host's
  flock, so the monotone-epoch and 3-layer-fencing proofs carry
  verbatim: remote hosts changed the transport, not the serialization
  point.

Cache coherence for remote readers is the same epoch-gated protocol
``RoutingCache`` already uses for ``fplacement`` pushes: the remote
table proxy serves reads from a short-lived snapshot
(``placement.table.cache_hits``) and drops it the moment a newer epoch
is observed (``note_epoch``) — an older snapshot can never veto a newer
route, it can only cost one extra RPC.

Counters (locked in fluidlint's ``placement.`` family):
``placement.table.rpc_reads`` / ``rpc_writes`` — door round trips;
``placement.table.cache_hits`` — remote reads served from the snapshot;
``placement.table.stale_rejections`` — remote writes the door's fence
refused (a zombie ex-owner writing through yesterday's claim).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Optional

from ..utils.affinity import any_thread, blocking
from .placement import DEFAULT_TTL_S, PlacementDir
from .placement_plane import EpochTable, placement_counters

#: every table-door frame name starts with this (routed by the storage
#: process's dispatcher next to the blob/ref RPCs)
TABLE_FRAME_PREFIX = "admin_table_"

#: how long a remote snapshot serves reads before re-RPCing; well under
#: the lease TTL so liveness decisions never ride a stale snapshot
SNAP_TTL_S = 0.25


class TableFenceError(RuntimeError):
    """The table door refused a write: the caller's lease claim is no
    longer the one on file (zombie ex-owner) — counted client-side as
    ``placement.table.stale_rejections``."""


# --------------------------------------------------------------- clients


class LocalTableClient:
    """Single-host (shared-filesystem) placement plane: the raw objects.

    ``leases``/``table`` are the unwrapped ``PlacementDir``/``EpochTable``
    so every existing call site, lock marker, and perf characteristic is
    byte-for-byte what it was before the split.
    """

    remote = False

    def __init__(self, shard_dir: str, n_partitions: int,
                 ttl_s: float = DEFAULT_TTL_S, counters=None):
        import os

        self.leases = PlacementDir(
            os.path.join(shard_dir, "placement"), n_partitions, ttl_s)
        self.table = EpochTable.for_shard_dir(shard_dir, counters=counters)


class RemoteTableClient:
    """Placement plane over the wire: proxies against the table door."""

    remote = True

    def __init__(self, addr: str, n_partitions: int,
                 ttl_s: float = DEFAULT_TTL_S, counters=None,
                 timeout: float = 10.0):
        host, _, port_s = addr.rpartition(":")
        self._chan = _DoorChannel(host or "127.0.0.1", int(port_s),
                                  timeout=timeout)
        c = counters if counters is not None else placement_counters()
        self.table = RemoteEpochTable(self._chan, c)
        self.leases = RemoteLeaseDir(self._chan, n_partitions, ttl_s,
                                     self.table, c)

    def close(self) -> None:
        self._chan.close()


class _DoorChannel:
    """One persistent framed-JSON connection to the table door, shared
    by both proxies (lock-serialized call/response; reconnects once on a
    broken pipe — the door is stateless per frame, so a retried frame is
    safe: every write is idempotent-keyed by owner/epoch semantics)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._rid = 0

    @blocking("synchronous table-door dial + rid round trip — remote "
              "placement reads/writes run on the lease poll executor or "
              "a ticker, never the loop")
    def call(self, frame: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                try:
                    return self._call_locked(frame)
                except (OSError, ConnectionError):
                    self._drop_locked()
                    if attempt:
                        raise
        raise ConnectionError("unreachable")  # pragma: no cover

    def _call_locked(self, frame: dict) -> dict:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout)
        self._rid += 1
        rid = self._rid
        body = json.dumps(dict(frame, rid=rid)).encode()
        self._sock.sendall(len(body).to_bytes(4, "big") + body)

        def read_exactly(n: int) -> bytes:
            buf = b""
            while len(buf) < n:
                chunk = self._sock.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("closed")
                buf += chunk
            return buf

        while True:
            n = int.from_bytes(read_exactly(4), "big")
            reply = json.loads(read_exactly(n).decode())
            if reply.get("rid") != rid:
                continue
            if reply.get("t") == "error":
                raise RuntimeError(reply.get("message"))
            return reply

    def _drop_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


class RemoteEpochTable:
    """``EpochTable`` surface over ``admin_table_*`` frames.

    Reads serve from an epoch-gated snapshot no older than
    ``SNAP_TTL_S``; writes invalidate it (our own write bumped the
    epoch) and every fence rejection raises :class:`TableFenceError`
    after counting ``placement.table.stale_rejections`` — the zombie
    never mistakes a refusal for a transport error.
    """

    def __init__(self, chan: _DoorChannel, counters):
        self._chan = chan
        self.counters = counters
        self._snap: Optional[dict] = None
        self._snap_t = 0.0
        self._snap_epoch = -1

    # ------------------------------------------------------------ readers

    def read(self) -> dict:
        now = time.monotonic()
        if self._snap is not None and now - self._snap_t < SNAP_TTL_S:
            self.counters.inc("placement.table.cache_hits")
            return self._snap
        self.counters.inc("placement.table.rpc_reads")
        rec = self._chan.call({"t": "admin_table_read"})["rec"]
        self._snap, self._snap_t = rec, now
        self._snap_epoch = rec.get("epoch", 0)
        return rec

    def global_epoch(self) -> int:
        return self.read()["epoch"]

    def epoch_of(self, k: int) -> int:
        part = self.read()["parts"].get(str(k))
        return part["epoch"] if part else 0

    def addr_of(self, k: int) -> Optional[str]:
        part = self.read()["parts"].get(str(k))
        return part["addr"] if part else None

    def part_epochs(self) -> dict:
        return {int(k): p["epoch"]
                for k, p in self.read()["parts"].items()}

    def cores(self) -> dict:
        return self.read().get("cores", {})

    def core_state(self, owner: str) -> Optional[str]:
        row = self.cores().get(owner)
        return row["state"] if row else None

    @any_thread
    def note_epoch(self, epoch: int) -> None:
        """Coherence push: a peer told us the table reached ``epoch``
        (an ``fplacement`` frame, a migration reply). A snapshot older
        than that is dead — drop it so the next read re-RPCs."""
        if epoch > self._snap_epoch:
            self._snap = None
            self._snap_epoch = epoch

    def _invalidate(self) -> None:
        self._snap = None

    # ------------------------------------------------------------ writers

    def _write(self, frame: dict) -> dict:
        self.counters.inc("placement.table.rpc_writes")
        self._invalidate()
        reply = self._chan.call(frame)
        if reply.get("t") == "table_reject":
            self.counters.inc("placement.table.stale_rejections")
            raise TableFenceError(
                reply.get("reason", "rejected by table door fence"))
        return reply

    def record_claim(self, k: int, owner: str, addr: str,
                     cause: Optional[str] = None) -> int:
        return self._write({"t": "admin_table_record_claim", "k": k,
                            "owner": owner, "addr": addr,
                            "cause": cause})["epoch"]

    def record_release(self, k: int, owner: str,
                       cause: Optional[str] = None) -> Optional[int]:
        return self._write({"t": "admin_table_record_release", "k": k,
                            "owner": owner, "cause": cause})["epoch"]

    def record_core(self, owner: str, addr: str,
                    host: Optional[str] = None) -> None:
        self._write({"t": "admin_table_record_core", "owner": owner,
                     "addr": addr, "host": host})

    def set_core_state(self, owner: str, state: str,
                       cause: Optional[str] = None) -> bool:
        return self._write({"t": "admin_table_set_core_state",
                            "owner": owner, "state": state,
                            "cause": cause})["ok"]

    def remove_core(self, owner: str,
                    cause: Optional[str] = None) -> None:
        self._write({"t": "admin_table_remove_core", "owner": owner,
                     "cause": cause})


class RemoteLeaseDir:
    """``PlacementDir`` surface over ``admin_table_*`` frames. The flock
    critical sections run door-side, so two racing remote claimants
    serialize exactly like two local ones."""

    def __init__(self, chan: _DoorChannel, n_partitions: int,
                 ttl_s: float, table: RemoteEpochTable, counters):
        self._chan = chan
        self.n = n_partitions
        self.ttl_s = ttl_s
        self._table = table
        self.counters = counters

    def _call(self, frame: dict, write: bool = True) -> dict:
        self.counters.inc("placement.table.rpc_writes" if write
                          else "placement.table.rpc_reads")
        if write:
            self._table._invalidate()
        reply = self._chan.call(frame)
        if reply.get("t") == "table_reject":
            self.counters.inc("placement.table.stale_rejections")
            raise TableFenceError(
                reply.get("reason", "rejected by table door fence"))
        return reply

    def try_claim(self, k: int, owner_id: str, address: str) -> bool:
        return self._call({"t": "admin_table_try_claim", "k": k,
                           "owner": owner_id, "addr": address})["ok"]

    def heartbeat(self, k: int, owner_id: str) -> bool:
        return self._call({"t": "admin_table_heartbeat", "k": k,
                           "owner": owner_id})["ok"]

    def transfer(self, k: int, from_owner: str, to_owner: str,
                 to_address: str) -> bool:
        return self._call({"t": "admin_table_transfer", "k": k,
                           "from_owner": from_owner, "to_owner": to_owner,
                           "to_addr": to_address})["ok"]

    def release(self, k: int, owner_id: str) -> None:
        self._call({"t": "admin_table_release", "k": k,
                    "owner": owner_id})

    def owner_of(self, k: int) -> Optional[str]:
        return self._call({"t": "admin_table_owner_of", "k": k},
                          write=False)["addr"]

    def table(self) -> dict:
        raw = self._call({"t": "admin_table_lease_table"},
                         write=False)["table"]
        return {int(k): v for k, v in raw.items()}


# ------------------------------------------------------------------ door


class TableDoorService:
    """The placement host's table door: ``admin_table_*`` dispatch over
    the REAL flock-backed lease dir + epoch table.

    Served by the storage process (``storage_server --table-dir``) so
    multi-host fleets need exactly one extra socket, not one extra
    process. Every write runs the same flocked critical section the
    local client runs — one serialization point for local cores (direct
    flock) and remote cores (RPC into this door's flock) alike.

    The door adds ONE check the local path never needed: a
    ``record_claim`` whose claimed owner no longer matches the lease on
    file is refused (``table_reject``). Locally a zombie discovers the
    takeover on its next heartbeat; remotely the door is the last line
    before an epoch bump, and a refusal here is observable
    (``placement.table.stale_rejections``) instead of being a silent
    wrong-owner route.
    """

    def __init__(self, shard_dir: str, n_partitions: int,
                 ttl_s: float = DEFAULT_TTL_S):
        import os

        self.leases = PlacementDir(
            os.path.join(shard_dir, "placement"), n_partitions, ttl_s)
        self.table = EpochTable.for_shard_dir(shard_dir)

    def handle(self, frame: dict) -> dict:
        t = frame.get("t", "")
        k = frame.get("k")
        owner = frame.get("owner")
        if t == "admin_table_read":
            return {"t": "table_rec", "rec": self.table.read()}
        if t == "admin_table_ping":
            return {"t": "table_pong", "shards": self.leases.n,
                    "ttl_s": self.leases.ttl_s}
        if t == "admin_table_try_claim":
            return {"t": "ok", "ok": self.leases.try_claim(
                int(k), owner, frame["addr"])}
        if t == "admin_table_heartbeat":
            return {"t": "ok", "ok": self.leases.heartbeat(int(k), owner)}
        if t == "admin_table_transfer":
            return {"t": "ok", "ok": self.leases.transfer(
                int(k), frame["from_owner"], frame["to_owner"],
                frame["to_addr"])}
        if t == "admin_table_release":
            self.leases.release(int(k), owner)
            return {"t": "ok", "ok": True}
        if t == "admin_table_owner_of":
            return {"t": "addr", "addr": self.leases.owner_of(int(k))}
        if t == "admin_table_lease_table":
            return {"t": "lease_table",
                    "table": {str(kk): v
                              for kk, v in self.leases.table().items()}}
        if t == "admin_table_record_claim":
            # the door-side fence: the epoch bump is reserved for the
            # owner the LEASE names — a zombie whose lease was taken
            # over cannot re-route the partition through the door
            cur = self.leases._read(int(k))
            if cur is None or cur.get("owner") != owner:
                return {"t": "table_reject",
                        "reason": f"lease for part {k} not held by "
                                  f"{owner}"}
            epoch = self.table.record_claim(int(k), owner, frame["addr"],
                                            cause=frame.get("cause"))
            return {"t": "epoch", "epoch": epoch}
        if t == "admin_table_record_release":
            epoch = self.table.record_release(int(k), owner,
                                              cause=frame.get("cause"))
            return {"t": "epoch", "epoch": epoch}
        if t == "admin_table_record_core":
            self.table.record_core(owner, frame["addr"],
                                   host=frame.get("host"))
            return {"t": "ok", "ok": True}
        if t == "admin_table_set_core_state":
            return {"t": "ok", "ok": self.table.set_core_state(
                owner, frame["state"], cause=frame.get("cause"))}
        if t == "admin_table_remove_core":
            self.table.remove_core(owner, cause=frame.get("cause"))
            return {"t": "ok", "ok": True}
        raise ValueError(f"unknown table rpc {t!r}")
