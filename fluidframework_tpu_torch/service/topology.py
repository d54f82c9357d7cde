"""Fleet topology spec: a whole deployment — and its restart — as ONE
declarative object.

JAX counterpart: ``fluidframework_tpu/service/topology.py``; the port's
copy of ``TopologySpec``, ``build_core`` and the ``Fleet`` launcher, which
spawns the port's modules, imports rebased to this package.

Ref: Routerlicious ships as a helm chart — alfred/deli/scribe replica
counts, kafka topics, and redis endpoints live in one values file, and
"restart the cluster" means re-applying that file (SURVEY §5). Our
deployment knowledge had instead spread across four construction paths
that each re-derived it by hand: ``front_end`` main()'s flag soup,
bench harnesses re-assembling argv per core, gateways wired by
positional ports, and in-process tests building ShardHosts directly.
A cold restart therefore had no single artifact to restart FROM — the
operator (or bench) had to replay the original command lines from
memory.

:class:`TopologySpec` is that artifact: partitions, cores (with their
preferred claims and ports), gateway relay tiers, the shard dir, and
the boot-admission budget, JSON round-trippable via ``save``/``load``.
Every construction path now converges on :func:`build_core` — the one
function that turns (spec, core_index) into a serving
``NetworkFrontEnd`` — so ``front_end --topology spec.json
--core-index 2`` and an in-process test fleet are the same code.
:class:`Fleet` drives the whole object: start every core (and gateway)
from the spec, SIGKILL the lot mid-traffic, and restart from the same
spec — the cold-start storm bench (``bench.py net_cold_storm``) and
the cold-start chaos drill are its two callers.

Counters (tier "frontend", locked in fluidlint's registry):

    topology.fleet.starts       fleets started from a spec
    topology.fleet.restarts     fleets RE-started from the same spec
    topology.fleet.kills        whole-fleet kill -9s issued
    topology.fleet.host_kills   single host-group kill -9s (kill_host)
    topology.fleet.host_starts  single host-group respawns (start_host)
    topology.core.spawns        cores constructed via build_core
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional


@dataclasses.dataclass
class CoreSpec:
    """One ordering core: which partitions it prefers to claim and
    where it listens. ``port=0`` lets the OS pick (the Fleet records
    the bound port from the core's LISTENING line / front object)."""

    name: str
    prefer: list = dataclasses.field(default_factory=list)
    port: int = 0
    # multi-host fleets: which host group (TopologySpec.hosts key) runs
    # this core; None = the placement host
    host: Optional[str] = None


@dataclasses.dataclass
class GatewaySpec:
    """One gateway tier node. ``upstream`` chains relay tiers: None
    routes shard-aware against the epoch table (leaf-of-cores tier),
    an int splices through that gateway index (deeper fan-out tiers
    speak the muxed link protocol upward)."""

    name: str
    port: int = 0
    upstream: Optional[int] = None
    # multi-host fleets: which host group runs this gateway
    host: Optional[str] = None


@dataclasses.dataclass
class TopologySpec:
    """The whole fleet as data. See the module docstring."""

    shard_dir: str
    n_partitions: int
    cores: list = dataclasses.field(default_factory=list)
    gateways: list = dataclasses.field(default_factory=list)
    host: str = "127.0.0.1"
    lease_ttl: Optional[float] = None
    admin_secret: Optional[str] = None
    summarize_every: Optional[int] = None
    storage_server: Optional[str] = None  # "host:port" or "port"
    # when set, the Fleet RUNS a storage server over this dir and wires
    # every core to it — summaries must outlive core processes or a
    # cold restart has no snapshot to lazy-boot from
    storage_dir: Optional[str] = None
    # boot-storm admission (service/rehydrate.py): each core's
    # rehydration executor budget; rate <= 0 disarms (unbounded boots)
    boot_rate: float = 200.0
    boot_burst: int = 32
    # self-driving placement: kwargs for enable_rebalancer, or None
    rebalance: Optional[dict] = None
    # live health plane: kwargs for enable_health (canary prober +
    # streaming doctor on every core), or None = unarmed
    health: Optional[dict] = None
    # ---- multi-host fleets ----------------------------------------
    # host groups: {host_id: address}. Empty = classic single-host.
    # Each non-placement group runs in a DISJOINT working dir
    # (``host_dir``) with its own process group — no flock, no file
    # sharing with the placement host; its cores reach the lease/epoch
    # plane only through the table door (``table_server``).
    hosts: dict = dataclasses.field(default_factory=dict)
    # which host group owns the shard dir, the storage tier, and the
    # table door; None defaults to the lexicographically first host id
    placement_host: Optional[str] = None
    # "host:port" of the admin_table_* door — resolved by the Fleet
    # once the storage process binds (the door rides its socket)
    table_server: Optional[str] = None
    # ShardHost claim policy: None/"any" (historical — claim stale
    # leases anywhere) or "prefer" (pinned: multi-host fleets without
    # log replication can't resume a foreign group's log by takeover)
    claim_policy: Optional[str] = None
    # forward-compat (rolling upgrade): top-level keys this build does
    # not know survive load→save round-trips via this bag — a newer
    # spec rewritten by an older core keeps the newer fields
    extras: dict = dataclasses.field(default_factory=dict)

    # ---- JSON round-trip ------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cores"] = [dataclasses.asdict(c) if not isinstance(c, dict)
                      else c for c in self.cores]
        d["gateways"] = [dataclasses.asdict(g) if not isinstance(g, dict)
                         else g for g in self.gateways]
        # unknown-key passthrough: flatten the bag back to the top
        # level (known fields win on collision — ours are typed)
        extras = d.pop("extras", None) or {}
        return {**extras, **d}

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        known = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        extras = {k: v for k, v in d.items() if k not in known}
        d = {k: v for k, v in d.items() if k in known}
        d["cores"] = [CoreSpec(**c) for c in d.get("cores", [])]
        d["gateways"] = [GatewaySpec(**g) for g in d.get("gateways", [])]
        return cls(**d, extras=extras)

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "TopologySpec":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    # ---- derived views --------------------------------------------

    def storage_addr(self) -> Optional[tuple]:
        if not self.storage_server:
            return None
        host, _, port = self.storage_server.rpartition(":")
        return (host or "127.0.0.1", int(port))

    def table_addr(self) -> Optional[tuple]:
        if not self.table_server:
            return None
        host, _, port = self.table_server.rpartition(":")
        return (host or "127.0.0.1", int(port))

    def core_name(self, i: int) -> str:
        return self.cores[i].name or f"core{i}"

    # ---- host groups ----------------------------------------------

    def placement_host_id(self) -> Optional[str]:
        """The host group owning the shard dir / storage / table door
        (None for classic single-host specs)."""
        if self.placement_host:
            return self.placement_host
        return min(self.hosts) if self.hosts else None

    def host_addr(self, hid: Optional[str]) -> str:
        """A host group's network address (``spec.host`` for None or
        unknown ids — the single-host fallback)."""
        if hid is None:
            return self.host
        return self.hosts.get(hid, self.host)

    def host_is_remote(self, hid: Optional[str]) -> bool:
        return bool(self.hosts) and hid is not None \
            and hid != self.placement_host_id()

    def host_dir(self, hid: Optional[str]) -> str:
        """The group's working dir: the shard dir for the placement
        host, a DISJOINT sibling for every other group — remote cores
        never open (or flock) a placement-host path; simulated machines
        on one box share nothing but sockets."""
        if not self.host_is_remote(hid):
            return self.shard_dir
        return f"{self.shard_dir.rstrip(os.sep)}-host-{hid}"

    def host_spec_path(self, hid: Optional[str]) -> str:
        return os.path.join(self.host_dir(hid), "topology.json")

    def core_host(self, i: int) -> Optional[str]:
        """Which host group core ``i`` runs in (None single-host)."""
        if not self.hosts:
            return None
        return self.cores[i].host or self.placement_host_id()

    def core_is_remote(self, i: int) -> bool:
        return self.host_is_remote(self.core_host(i))

    def core_dir(self, i: int) -> str:
        return self.host_dir(self.core_host(i))

    def core_host_addr(self, i: int) -> str:
        return self.host_addr(self.core_host(i))

    def gateway_host(self, i: int) -> Optional[str]:
        if not self.hosts:
            return None
        return self.gateways[i].host or self.placement_host_id()

    def spec_path(self) -> str:
        """Canonical on-disk home: the spec lives beside the state it
        describes, so a restart needs only the shard dir."""
        return os.path.join(self.shard_dir, "topology.json")

    def core_argv(self, i: int, spec_path: str,
                  python: str = sys.executable) -> list:
        return [python, "-m", "fluidframework_tpu_torch.service.front_end",
                "--topology", spec_path, "--core-index", str(i)]

    def gateway_argv(self, i: int, core_ports: dict,
                     gateway_ports: dict,
                     python: str = sys.executable) -> list:
        g = self.gateways[i]
        ghid = self.gateway_host(i)
        argv = [python, "-m", "fluidframework_tpu_torch.service.gateway",
                "--host", self.host_addr(ghid), "--port", str(g.port)]
        if g.upstream is not None:
            up = gateway_ports[g.upstream]
            up_addr = self.host_addr(self.gateway_host(g.upstream))
            argv += ["--upstream-gateway", f"{up_addr}:{up}"]
        elif self.host_is_remote(ghid):
            # remote host group: route from the table door over the
            # wire — this gateway has no placement dir to read
            if not self.table_server:
                raise RuntimeError(
                    f"gateway {g.name} is in remote host group "
                    f"{ghid!r} but the spec has no table_server")
            argv += ["--table-server", self.table_server,
                     "--shards", str(self.n_partitions)]
        else:
            argv += ["--shard-dir", self.shard_dir,
                     "--shards", str(self.n_partitions)]
        if ghid is not None and g.upstream is None:
            argv += ["--host-id", ghid]
        return argv


def build_core(spec: TopologySpec, core_index: int, *,
               port: Optional[int] = None, arm_journal: bool = True):
    """THE core construction path: (spec, index) → an un-started
    ``NetworkFrontEnd``. ``front_end --topology`` (subprocess mode)
    and :class:`Fleet` in-process mode both land here, so a restarted
    fleet is byte-for-byte the construction the first start ran.

    ``arm_journal=False`` skips arming the process-singleton audit
    journal — required in-process, where many cores share one process
    and tests inject private Journal instances instead.
    """
    from ..obs import get_journal
    from .front_end import NetworkFrontEnd, ShardHost
    from .rehydrate import boot_counters

    core = spec.cores[core_index]
    core_dir = spec.core_dir(core_index)
    table_client = None
    if spec.core_is_remote(core_index):
        # remote host group: the lease/epoch plane is the placement
        # host's table door, reached over the wire — this process
        # neither sees nor flocks any placement-host file
        from .placement import DEFAULT_TTL_S
        from .table_client import RemoteTableClient

        taddr = spec.table_addr()
        if taddr is None:
            raise RuntimeError(
                f"core {spec.core_name(core_index)} is in remote host "
                f"group {spec.core_host(core_index)!r} but the spec "
                "has no table_server (start the fleet's storage "
                "process with --table-dir first)")
        table_client = RemoteTableClient(
            f"{taddr[0]}:{taddr[1]}", spec.n_partitions,
            ttl_s=(spec.lease_ttl if spec.lease_ttl is not None
                   else DEFAULT_TTL_S))
    host = ShardHost(core_dir, spec.n_partitions,
                     prefer=core.prefer,
                     storage_server=spec.storage_addr(),
                     ttl_s=spec.lease_ttl,
                     table_client=table_client,
                     host_id=spec.core_host(core_index),
                     claim_policy=spec.claim_policy)
    if arm_journal:
        from ..obs import arm_journal as _arm

        # journal file named by the core's STABLE role so a restarted
        # core continues its id space; anonymous cores fall back to
        # their (fresh) owner id — unique but not restart-stable
        name = spec.cores[core_index].name or host.owner_id
        table = host.table
        jr = _arm(os.path.join(core_dir, "journal",
                               f"{name}.jsonl"),
                  core=name,
                  epoch_fn=lambda: table.read().get("epoch", 0))
    else:
        jr = get_journal()
    jr.emit("core.recover" if jr.seq else "core.start",
            owner=host.owner_id, shards=spec.n_partitions,
            prefer=list(core.prefer))
    front = NetworkFrontEnd(
        host=spec.core_host_addr(core_index),
        port=core.port if port is None else port,
        shard_host=host, admin_secret=spec.admin_secret)
    if spec.summarize_every is not None:
        front.enable_summarizer(spec.summarize_every)
    if spec.rebalance is not None:
        front.enable_rebalancer(**spec.rebalance)
    if spec.health is not None:
        front.enable_health(**spec.health)
    if spec.boot_rate and spec.boot_rate > 0:
        front.enable_boot_admission(spec.boot_rate, spec.boot_burst)
    boot_counters().inc("topology.core.spawns")
    return front


def default_spec(shard_dir: str, n_cores: int, n_partitions: int,
                 **kw) -> TopologySpec:
    """The common shape: partitions dealt round-robin across cores,
    OS-assigned ports, no gateways, a fleet-run storage tier under the
    shard dir (durable summaries are what make a cold boot
    O(snapshot+tail) instead of O(log))."""
    cores = [CoreSpec(name=f"core{i}",
                      prefer=[k for k in range(n_partitions)
                              if k % n_cores == i])
             for i in range(n_cores)]
    kw.setdefault("storage_dir", os.path.join(shard_dir, "storage"))
    return TopologySpec(shard_dir=shard_dir, n_partitions=n_partitions,
                        cores=cores, **kw)


def multihost_spec(shard_dir: str, n_hosts: int, cores_per_host: int,
                   n_partitions: int, gateway_per_host: bool = True,
                   **kw) -> TopologySpec:
    """The common multi-host shape: ``n_hosts`` simulated host groups
    (``h0`` is the placement host — shard dir, storage tier, table
    door), ``cores_per_host`` cores each with partitions dealt
    round-robin across ALL cores, one shard-aware gateway per host, and
    ``claim_policy="prefer"`` (partitions are pinned — without log
    replication a foreign group's log cannot be resumed by takeover;
    cross-host MIGRATION ships the log through storage instead)."""
    n_cores = n_hosts * cores_per_host
    cores = []
    for i in range(n_cores):
        cores.append(CoreSpec(
            name=f"core{i}",
            prefer=[k for k in range(n_partitions)
                    if k % n_cores == i],
            host=f"h{i // cores_per_host}"))
    gateways = []
    if gateway_per_host:
        gateways = [GatewaySpec(name=f"gw-h{h}", host=f"h{h}")
                    for h in range(n_hosts)]
    kw.setdefault("storage_dir", os.path.join(shard_dir, "storage"))
    kw.setdefault("claim_policy", "prefer")
    return TopologySpec(
        shard_dir=shard_dir, n_partitions=n_partitions, cores=cores,
        gateways=gateways,
        hosts={f"h{h}": "127.0.0.1" for h in range(n_hosts)},
        placement_host="h0", **kw)


class Fleet:
    """Drive a TopologySpec: start, kill -9, restart — the whole fleet
    as one object.

    Two modes share the spec and the construction path:

    * ``subprocess=True`` — each core is ``front_end --topology
      spec.json --core-index i`` (plus gateway processes); ``kill()``
      is a real SIGKILL. The storm bench and chaos drill mode.
    * in-process (default) — each core is ``build_core(...).
      start_background()`` on its own loop thread; ``kill()`` abandons
      the fronts without checkpoint or close (stop() tears down the
      loop and sockets but never flushes pipeline state — the same
      on-disk picture a SIGKILL leaves). The net_smoke gate and unit
      tests run this mode.

    ``restart()`` = ``kill()`` scars healed only by the recovery path:
    a fresh Fleet state is rebuilt from the SAME spec, so anything the
    spec fails to capture shows up as a restart that comes up wrong.
    """

    def __init__(self, spec: TopologySpec, subprocess: bool = False,
                 env: Optional[dict] = None):
        self.spec = spec
        self.subprocess = subprocess
        self.env = env
        self.procs: dict[int, "subprocess.Popen"] = {}
        self.gw_procs: dict[int, "subprocess.Popen"] = {}
        self.fronts: dict[int, object] = {}  # in-proc NetworkFrontEnds
        self.core_ports: dict[int, int] = {}
        self.gw_ports: dict[int, int] = {}
        self.storage_proc = None   # subprocess mode
        self.storage_runner = None  # in-proc mode
        self._generation = 0
        # multi-host: host group id → that group's live Popens (cores +
        # gateways), the unit kill_host()/start_host() operate on
        self.host_procs: dict = {}

    # ---- lifecycle ------------------------------------------------

    def start(self) -> "Fleet":
        from .rehydrate import boot_counters

        os.makedirs(self.spec.shard_dir, exist_ok=True)
        # epoch floor: claims recorded AFTER this instant bump past it,
        # which is how wait_claimed tells this generation's ownership
        # from a dead generation's leftover rows (same addrs when the
        # spec pins ports)
        from .placement_plane import EpochTable

        self._epoch_floor = EpochTable.for_shard_dir(
            self.spec.shard_dir).read().get("epoch", 0)
        counters = boot_counters()
        if self._generation == 0:
            counters.inc("topology.fleet.starts")
        else:
            counters.inc("topology.fleet.restarts")
        self._generation += 1
        if self.subprocess:
            self._start_subprocess()
        else:
            self._start_inproc()
        return self

    def _start_inproc(self) -> None:
        spec = self.spec
        if spec.storage_dir:
            door = None
            if spec.hosts:
                from .placement import DEFAULT_TTL_S
                from .table_client import TableDoorService

                door = TableDoorService(
                    spec.shard_dir, spec.n_partitions,
                    ttl_s=(spec.lease_ttl if spec.lease_ttl is not None
                           else DEFAULT_TTL_S))
            placement_addr = spec.host_addr(spec.placement_host_id())
            self.storage_runner = _StorageRunner(
                spec.storage_dir, placement_addr, table_door=door)
            port = self.storage_runner.start()
            spec.storage_server = f"{placement_addr}:{port}"
            if door is not None:
                spec.table_server = spec.storage_server
        for hid in spec.hosts:
            os.makedirs(spec.host_dir(hid), exist_ok=True)
        for i in range(len(spec.cores)):
            front = build_core(spec, i, arm_journal=False)
            front.start_background()
            self.fronts[i] = front
            self.core_ports[i] = front.port
        # in-process mode serves cores directly; gateway tiers are a
        # subprocess-mode concern (their loops want own processes)

    def _start_subprocess(self) -> None:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self._env_cache = env
        spec = self.spec
        if spec.storage_dir:
            placement_addr = spec.host_addr(spec.placement_host_id())
            argv = [sys.executable, "-m",
                    "fluidframework_tpu_torch.service.storage_server",
                    "--dir", spec.storage_dir,
                    "--host", placement_addr]
            if spec.hosts:
                # the table door rides the storage socket: one extra
                # frame family, zero extra processes
                argv += ["--table-dir", spec.shard_dir,
                         "--shards", str(spec.n_partitions)]
                if spec.lease_ttl is not None:
                    argv += ["--lease-ttl", str(spec.lease_ttl)]
            self.storage_proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env)
            port = _read_listening(self.storage_proc, "storage")
            spec.storage_server = f"{placement_addr}:{port}"
            if spec.hosts:
                spec.table_server = spec.storage_server
        # saved AFTER the storage tier binds: the spec file each core
        # loads carries the resolved storage + table-door addresses
        spec.save(spec.spec_path())
        # each remote host group gets a COPY of the spec in its own
        # disjoint dir — its processes never read a placement-host path
        for hid in spec.hosts:
            if spec.host_is_remote(hid):
                os.makedirs(spec.host_dir(hid), exist_ok=True)
                spec.save(spec.host_spec_path(hid))
        for i in range(len(spec.cores)):
            self._spawn_core(i, env)
        for i, p in self.procs.items():
            self.core_ports[i] = _read_listening(p, spec.core_name(i))
        # gateways after cores: a shard-aware gateway routes from the
        # epoch table the cores have begun writing; relay tiers after
        # their upstream so the splice target exists
        order = [i for i, g in enumerate(spec.gateways)
                 if g.upstream is None]
        order += [i for i, g in enumerate(spec.gateways)
                  if g.upstream is not None]
        for i in order:
            self._spawn_gateway(i, env)
            self.gw_ports[i] = _read_listening(
                self.gw_procs[i], spec.gateways[i].name)

    def _spawn_core(self, i: int, env: dict) -> None:
        spec = self.spec
        hid = spec.core_host(i)
        spec_path = (spec.host_spec_path(hid) if spec.host_is_remote(hid)
                     else spec.spec_path())
        p = subprocess.Popen(
            spec.core_argv(i, spec_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env,
            start_new_session=bool(spec.hosts))
        self.procs[i] = p
        if hid is not None:
            self.host_procs.setdefault(hid, []).append(p)

    def _spawn_gateway(self, i: int, env: dict) -> None:
        spec = self.spec
        p = subprocess.Popen(
            spec.gateway_argv(i, self.core_ports, self.gw_ports),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, start_new_session=bool(spec.hosts))
        self.gw_procs[i] = p
        hid = spec.gateway_host(i)
        if hid is not None:
            self.host_procs.setdefault(hid, []).append(p)

    def kill(self) -> "Fleet":
        """kill -9 the whole fleet: no checkpoint, no close, no
        goodbye — the cold-start bench's opening move."""
        from .rehydrate import boot_counters

        boot_counters().inc("topology.fleet.kills")
        victims = (list(self.gw_procs.values())
                   + list(self.procs.values()))
        if self.storage_proc is not None:
            victims.append(self.storage_proc)
        for p in victims:
            try:
                p.send_signal(signal.SIGKILL)
            except OSError:
                pass
        for p in victims:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
        for front in self.fronts.values():
            # abandon: stop() kills the loop + sockets but flushes
            # NOTHING (no checkpoint_all, no orderer close) — the
            # on-disk state is what the last 2 s ticker left, exactly
            # a SIGKILL's aftermath
            front.stop()
        if self.storage_runner is not None:
            self.storage_runner.stop()
        self.procs.clear()
        self.gw_procs.clear()
        self.fronts.clear()
        self.core_ports.clear()
        self.gw_ports.clear()
        self.host_procs.clear()
        self.storage_proc = None
        self.storage_runner = None
        return self

    def kill_host(self, hid: str) -> "Fleet":
        """kill -9 ONE host group (its separate process group simulates
        a machine dying): every core and gateway of ``hid``, nothing
        else. The placement host's storage/table door stays up unless
        ``hid`` IS the placement host."""
        from .rehydrate import boot_counters

        boot_counters().inc("topology.fleet.host_kills")
        victims = list(self.host_procs.pop(hid, []))
        if (hid == self.spec.placement_host_id()
                and self.storage_proc is not None):
            victims.append(self.storage_proc)
            self.storage_proc = None
        for p in victims:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                try:
                    p.send_signal(signal.SIGKILL)
                except OSError:
                    pass
        for p in victims:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
        dead = set(victims)
        for i in [i for i, p in self.procs.items() if p in dead]:
            self.procs.pop(i)
            self.core_ports.pop(i, None)
        for i in [i for i, p in self.gw_procs.items() if p in dead]:
            self.gw_procs.pop(i)
            self.gw_ports.pop(i, None)
        return self

    def start_host(self, hid: str) -> "Fleet":
        """Respawn ONE host group from its spec copy — the recovery
        half of :meth:`kill_host` (subprocess mode only)."""
        from .rehydrate import boot_counters

        boot_counters().inc("topology.fleet.host_starts")
        env = getattr(self, "_env_cache", None)
        if env is None:
            env = dict(os.environ)
            if self.env:
                env.update(self.env)
        spec = self.spec
        mine = [i for i in range(len(spec.cores))
                if spec.core_host(i) == hid]
        for i in mine:
            self._spawn_core(i, env)
        for i in mine:
            self.core_ports[i] = _read_listening(self.procs[i],
                                                 spec.core_name(i))
        gws = [i for i, g in enumerate(spec.gateways)
               if spec.gateway_host(i) == hid]
        for i in sorted(gws, key=lambda i:
                        spec.gateways[i].upstream is not None):
            self._spawn_gateway(i, env)
            self.gw_ports[i] = _read_listening(
                self.gw_procs[i], spec.gateways[i].name)
        return self

    def restart(self) -> "Fleet":
        """Restart from the spec — the artifact IS the runbook."""
        if self.procs or self.fronts:
            self.kill()
        return self.start()

    def checkpoint_all(self) -> None:
        """Checkpoint + flush every in-proc core. The 2s checkpoint
        ticker lives in serve_forever (subprocess cores get it for
        free); an in-proc fleet must ask explicitly before a kill is
        expected to be recoverable from the checkpoint."""
        for front in self.fronts.values():
            for server in front._all_servers():
                server.checkpoint_all()
            front._flush_logs()

    def stop(self) -> None:
        """Graceful-ish teardown for harness cleanup (not part of the
        crash story): terminate subprocesses, stop in-proc loops."""
        victims = (list(self.gw_procs.values())
                   + list(self.procs.values()))
        if self.storage_proc is not None:
            victims.append(self.storage_proc)
        for p in victims:
            try:
                p.terminate()
            except OSError:
                pass
        for p in victims:
            try:
                p.wait(timeout=10)
            except Exception:
                p.kill()
        for front in self.fronts.values():
            front.stop()
        if self.storage_runner is not None:
            self.storage_runner.stop()
        self.procs.clear()
        self.gw_procs.clear()
        self.fronts.clear()
        self.storage_proc = None
        self.storage_runner = None

    # ---- addressing -----------------------------------------------

    def core_addr(self, i: int) -> tuple:
        return (self.spec.core_host_addr(i), self.core_ports[i])

    def client_addr(self) -> tuple:
        """Where clients dial: the deepest gateway tier if one exists,
        else the first core."""
        if self.gw_ports:
            leaf = max(self.gw_ports)
            return (self.spec.host_addr(self.spec.gateway_host(leaf)),
                    self.gw_ports[leaf])
        return self.core_addr(0)

    def gateway_addr(self, i: int) -> tuple:
        return (self.spec.host_addr(self.spec.gateway_host(i)),
                self.gw_ports[i])

    def wait_claimed(self, timeout: float = 30.0,
                     parts: Optional[set] = None) -> None:
        """Block until every partition (or just ``parts``) is routed to
        one of THIS generation's cores in the epoch table — 'the fleet
        is up'. (After a restart the table still carries the dead
        generation's rows, so mere presence of an owner proves
        nothing.)"""
        from .placement_plane import EpochTable

        table = EpochTable.for_shard_dir(self.spec.shard_dir)
        want = {f"{self.spec.core_host_addr(i)}:{p}"
                for i, p in self.core_ports.items()}
        floor = getattr(self, "_epoch_floor", 0)
        need = (set(range(self.spec.n_partitions)) if parts is None
                else {int(k) for k in parts})
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rows = table.read().get("parts", {})
            have = {int(k): p for k, p in rows.items() if int(k) in need}
            if (len(have) == len(need)
                    and all(p.get("addr") in want
                            and p.get("epoch", 0) > floor
                            for p in have.values())):
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"fleet: partitions unclaimed after {timeout}s")

    def wait_healthy(self, host_id: Optional[str] = None,
                     timeout: float = 60.0) -> dict:
        """Block until the probe-backed live health plane answers
        ``ok`` — the rolling-upgrade go/no-go gate (requires
        ``spec.health``; an unarmed fleet answers ``unknown`` forever).

        With ``host_id`` only that host group's cores must be healthy
        (the host just respawned; the rest of the fleet is a later
        upgrade step); without it every core must be. Generation-gated
        like :meth:`wait_claimed` (the epoch floor first — a dead
        generation's core can still answer on a recycled port), and
        PROBE-backed: a core counts healthy only once a whole canary
        pass that BEGAN after its verdict turned ``ok`` has ended with
        every door it armed ``ok``, not merely once its engine boots
        with nothing evaluated yet, nor once the first door of a pass
        reports. With ``host_id`` the route door of that pass may fail
        (a peer on a host not yet upgraded may be down); the session
        doors may not.

        Returns {core_name: health dict}; raises TimeoutError with the
        failing verdicts otherwise."""
        from .placement_plane import admin_rpc

        deadline = time.monotonic() + timeout
        if host_id is None:
            targets = sorted(self.core_ports)
            parts = None
        else:
            targets = [i for i in sorted(self.core_ports)
                       if self.spec.core_host(i) == host_id]
            parts = {k for i in targets
                     for k in self.spec.cores[i].prefer} or None
        self.wait_claimed(
            timeout=max(0.1, deadline - time.monotonic()), parts=parts)
        last: dict = {}
        # core → the prober's ``started`` count when its verdict was
        # last seen turning ok (dropped whenever it is not ok)
        ok_at: dict = {}
        while time.monotonic() < deadline:
            verdicts = {}
            ok = True
            for i in targets:
                frame = {"t": "admin_health"}
                if self.spec.admin_secret:
                    frame["secret"] = self.spec.admin_secret
                try:
                    reply = admin_rpc(*self.core_addr(i), frame,
                                      timeout=5.0)
                    h = reply.get("health") or {}
                except (OSError, ValueError, RuntimeError) as e:
                    h = {"verdict": "unreachable", "error": str(e)}
                verdicts[self.spec.core_name(i)] = h
                if not self._probed_ok(i, h, ok_at, host_id is not None):
                    ok = False
            last = verdicts
            if ok:
                return verdicts
            time.sleep(0.2)
        summary = {name: h.get("verdict") for name, h in last.items()}
        raise TimeoutError(
            f"fleet: not healthy after {timeout}s: {summary}")

    @staticmethod
    def _probed_ok(i: int, h: dict, ok_at: dict, route_may_fail: bool
                   ) -> bool:
        """One core's gate of :meth:`wait_healthy`: its verdict is ok,
        and its prober's last ended pass began after the verdict was
        first seen ok and armed at least one door, all of them ok
        (``route`` excepted when ``route_may_fail``)."""
        passes = (h.get("probes") or {}).get("passes") or {}
        if h.get("verdict") != "ok":
            ok_at.pop(i, None)
            return False
        if i not in ok_at:
            ok_at[i] = passes.get("started", 0)
            return False
        last = passes.get("last") or {}
        doors = {d: v for d, v in (last.get("doors") or {}).items()
                 if not (route_may_fail and d == "route")}
        return (last.get("n", 0) > ok_at[i] and bool(doors)
                and all(doors.values()))


class _StorageRunner:
    """In-process storage tier: StorageServer on its own loop thread
    (it has no background mode of its own — subprocess deployments run
    it as a process)."""

    def __init__(self, directory: str, host: str, table_door=None):
        from .storage_server import StorageServer

        self.srv = StorageServer(directory, host=host, port=0,
                                 table_door=table_door)
        self.loop = None
        self.thread = None

    def start(self) -> int:
        import asyncio
        import threading

        ready = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            self.loop = loop
            asyncio.set_event_loop(loop)

            async def bind():
                s = await asyncio.start_server(
                    self.srv._handle_conn, self.srv.host, self.srv.port,
                    backlog=256)
                self.srv.port = s.sockets[0].getsockname()[1]

            loop.run_until_complete(bind())
            ready.set()
            loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True,
                                       name="fluid-storage")
        self.thread.start()
        ready.wait(timeout=10)
        return self.srv.port

    def stop(self) -> None:
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            if self.thread is not None:
                self.thread.join(timeout=5)
            self.loop = None


def _read_listening(proc, name: str, timeout: float = 60.0) -> int:
    """Parse the LISTENING readiness line a core/gateway prints; fail
    loudly with the process's output if it died instead."""
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            continue
        lines.append(line.rstrip())
        if line.startswith("LISTENING"):
            return int(line.rsplit(":", 1)[1])
    tail = "\n".join(lines[-20:])
    raise RuntimeError(f"{name} never reported LISTENING "
                       f"(rc={proc.poll()}):\n{tail}")
