"""The sharded ordering core of the port as a whole, on the CPU.

In process: two port ``ShardHost`` cores over one shard dir, seeded
clients editing docs of both partitions, a live migration of each
partition to the second core, then the second core's death and the first
core's takeover after the lease TTL. Two port ``ApplierStage``s
(``device="cpu"``) tail ``log-0`` and ``log-1``; their texts equal a JAX
``ApplierStage`` fed the same logs and the clients' converged replicas,
each partition's epochs rise at every ownership change, and the dead
core's server refuses a new connect.

Over sockets, still in process: two port front ends with
``shard_host=`` serve the placement admin doors (``admin_placement``,
``admin_migrate_part``, ``admin_core_heat``, ``admin_rebalance_status``,
``admin_placement_drain``) and route each doc to its partition's owner.

Also in process, the rest of ``tests/test_sharded_core.py``: a core
whose loop stalls past the lease TTL is revoked and its client moves
through the port's shard-routing gateway; the lease registry's claim,
heartbeat and takeover; the port's ``admin tenant-add`` securing a
partition claimed later; two concurrent connects through a fresh gateway
with no duplicate broadcast.

As processes (the one subprocess test of this file): a fleet of the
port's modules started from one ``TopologySpec`` (two cores, one
gateway) serves a ``Loader`` through the gateway across a migration and
a ``kill -9`` takeover.
"""

from __future__ import annotations

import os
import random
import signal
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.stage_runner import (
    ApplierStage as JaxApplierStage,
)
from fluidframework_tpu_torch.chaos.migrate import (
    TENANT,
    MigrateClient,
    _log_fingerprint,
)
from fluidframework_tpu_torch.chaos.monitor import InvariantMonitor
from fluidframework_tpu_torch.chaos.soak import _replica_fingerprint
from fluidframework_tpu_torch.service.front_end import (
    NetworkFrontEnd,
    ShardHost,
)
from fluidframework_tpu_torch.service.placement_plane import (
    MigrationEngine,
    admin_rpc,
)
from fluidframework_tpu_torch.service.stage_runner import (
    ApplierStage,
    doc_partition,
)
from fluidframework_tpu_torch.utils.telemetry import Counters

TTL = 0.6
FARM = dict(max_docs=8, max_slots=256)


def wait_for(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _docs(n_each: int, tenant: str = TENANT) -> dict:
    """``n_each`` doc names on each of the two partitions."""
    by_part = {0: [], 1: []}
    i = 0
    while any(len(v) < n_each for v in by_part.values()):
        d = f"sdoc{i}"
        k = doc_partition(tenant, d, 2)
        if len(by_part[k]) < n_each:
            by_part[k].append(d)
        i += 1
    return by_part


def _drain(stage) -> None:
    while stage.run_once():
        pass


def test_sharded_slice_in_process_matches_jax_stages(tmp_path):
    shard = str(tmp_path / "deploy")
    hosts, dead = [], set()

    def spawn(prefer=()):
        h = ShardHost(shard, 2, prefer=prefer, ttl_s=TTL)
        h.address = f"inproc/{h.owner_id}"
        hosts.append(h)
        h.poll()
        return h

    a = spawn(prefer=(0, 1))
    b = spawn()
    assert sorted(a.servers) == [0, 1] and not b.servers
    epochs = {k: [a.claim_epochs[k]] for k in (0, 1)}

    def alive():
        return [h for h in hosts if id(h) not in dead]

    def owner(k):
        for h in alive():
            s = h.servers.get(k)
            if s is not None and not s.sealed:
                return s
        return None

    def drain_all():
        # each live core heartbeats its leases here, as its front end's
        # lease loop would: a lease confirmed longer ago than 75% of the
        # TTL fences the core's servers
        for h in alive():
            h.poll()
        for h in alive():
            for s in list(h.servers.values()):
                s.drain()

    by_part = _docs(2)
    counters = Counters()
    monitor = InvariantMonitor(counters)
    clients = []
    for k, docs in by_part.items():
        for j, doc in enumerate(docs):
            for c in range(2):
                clients.append(MigrateClient(
                    doc, lambda k=k: owner(k), monitor, counters,
                    random.Random(100 * k + 10 * j + c)))

    def rounds(n):
        for _ in range(n):
            for c in clients:
                if c.conn is None or c.severed:
                    c.reconnect()
            drain_all()
            for c in clients:
                c.edit(2)
            drain_all()

    for c in clients:
        assert c.connect()
    rounds(6)
    # live migration of both partitions a → b (b then owns both)
    for k in (0, 1):
        res = MigrationEngine(a).migrate(
            k, b.address,
            adopt=lambda k, addr: MigrationEngine(b).adopt(k, a.owner_id))
        assert res["target"] == b.address
        epochs[k].append(b.claim_epochs[k])
        for c in clients:
            if doc_partition(TENANT, c.doc, 2) == k:
                c.sever()
    rounds(6)
    # b dies: a takes both partitions over once b's leases go stale
    for s in b.servers.values():
        s.log.flush()
    zombie = dict(b.servers)
    dead.add(id(b))
    for c in clients:
        c.sever()
    assert wait_for(lambda: (a.poll(), sorted(a.servers))[1] == [0, 1],
                    timeout=10 * TTL + 5)
    for k in (0, 1):
        epochs[k].append(a.claim_epochs[k])
    with pytest.raises(RuntimeError, match="lease lost"):
        zombie[0].connect(TENANT, by_part[0][0])
    rounds(4)
    for _ in range(10):
        drain_all()
        if all(c.settled for c in clients):
            break
        for c in clients:
            if not c.settled:
                c.reconnect()
    drain_all()
    assert all(c.settled for c in clients)
    for c in clients:
        c.catch_up()
    for k in (0, 1):
        assert epochs[k] == sorted(set(epochs[k])), epochs
        assert len(epochs[k]) == 3

    # every replica of a doc converged on the log's oracle
    want = {}
    for c in clients:
        k = doc_partition(TENANT, c.doc, 2)
        oracle = _log_fingerprint(owner(k), c.doc)
        assert _replica_fingerprint(c.replica) == oracle
        want[c.doc] = c.replica.get_text()
    for s in a.servers.values():
        s.log.flush()

    # the partition stages: the port's on the CPU, and the JAX package's
    for k in (0, 1):
        log_dir = os.path.join(shard, f"log-{k}")
        port = ApplierStage(log_dir, str(tmp_path / f"port-{k}"),
                            device="cpu", **FARM)
        jax = JaxApplierStage(log_dir, str(tmp_path / f"jax-{k}"), **FARM)
        _drain(port)
        _drain(jax)
        for doc in by_part[k]:
            text = port.applier.get_text(TENANT, doc)
            assert text == jax.applier.get_text(TENANT, doc) == want[doc]
        assert port.applier.host_escalations == 0
        port.shared.close()
        jax.shared.close()
    for s in a.servers.values():
        s.log.close()


def test_sharded_front_end_admin_doors(tmp_path):
    """Two port front ends with ``shard_host=`` in process: the doors
    route each doc to its owner, and the placement admin doors report,
    migrate, drain and read heat."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )

    shard = str(tmp_path / "deploy")
    fa = NetworkFrontEnd(shard_host=ShardHost(shard, 2, prefer=(0, 1),
                                              ttl_s=30.0)).start_background()
    fb = NetworkFrontEnd(shard_host=ShardHost(shard, 2,
                                              ttl_s=30.0)).start_background()
    try:
        by_part = _docs(1, tenant="t")
        rpc = admin_rpc
        place = rpc("127.0.0.1", fa.port, {"t": "admin_placement"})[
            "placement"]
        assert place["owned"] == [0, 1]
        assert place["parts"]["0"]["addr"] == f"127.0.0.1:{fa.port}"

        # a client on partition 0's doc through core a's socket
        svc = NetworkDocumentServiceFactory("127.0.0.1", fa.port) \
            .create_document_service("t", by_part[0][0])
        conn = svc.connect_to_delta_stream()
        conn.close()
        heat = rpc("127.0.0.1", fa.port, {"t": "admin_core_heat"})["heat"]
        assert heat["owner"] == fa.shard_host.owner_id
        assert set(heat["parts"]) == {"0", "1"}

        res = rpc("127.0.0.1", fa.port, {
            "t": "admin_migrate_part", "k": 0,
            "target": f"127.0.0.1:{fb.port}"})
        assert res["target"] == f"127.0.0.1:{fb.port}"
        assert wait_for(lambda: 0 in fb.shard_host.servers
                        and 0 not in fa.shard_host.servers)
        # core a now refuses partition 0's docs; core b serves them
        with pytest.raises(RuntimeError, match="not the owner"):
            NetworkDocumentServiceFactory("127.0.0.1", fa.port) \
                .create_document_service("t", by_part[0][0]) \
                .connect_to_delta_stream()
        conn = NetworkDocumentServiceFactory("127.0.0.1", fb.port) \
            .create_document_service("t", by_part[0][0]) \
            .connect_to_delta_stream()
        conn.close()
        status = rpc("127.0.0.1", fa.port, {"t": "admin_rebalance_status"})
        assert status["rebalance"] == {"armed": False}
        drained = rpc("127.0.0.1", fb.port, {
            "t": "admin_placement_drain",
            "owner": fa.shard_host.owner_id})
        assert drained["ok"]
        counters = rpc("127.0.0.1", fb.port, {"t": "admin_placement"})[
            "placement"]["counters"]
        assert counters.get("placement.migration.committed", 0) >= 1
    finally:
        fa.stop()
        fb.stop()
        for front in (fa, fb):
            for s in front.shard_host.servers.values():
                s.log.close()


def test_fleet_from_spec_rides_migration_and_takeover(tmp_path):
    """Port processes from one ``TopologySpec``: two cores and a gateway.
    A ``Loader`` writes through the gateway, partition 0 migrates to
    core 1 by ``admin_migrate_part``, core 1 (then owner of both) is
    killed with SIGKILL, core 0 takes both partitions over, and the
    container's edits all land, readable by a fresh boot."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.placement_plane import EpochTable
    from fluidframework_tpu_torch.service.topology import (
        Fleet,
        GatewaySpec,
        default_spec,
    )

    # no storage process: a summary-less fleet is enough here, and one
    # process fewer beside the rest of the suite
    spec = default_spec(str(tmp_path / "fleet"), n_cores=2,
                        n_partitions=2, lease_ttl=1.0, storage_dir=None)
    spec.gateways = [GatewaySpec(name="gw0")]
    fl = Fleet(spec, subprocess=True).start()
    try:
        fl.wait_claimed()
        gport = fl.gw_ports[0]
        by_part = _docs(1, tenant="t")
        d0 = by_part[0][0]
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", gport),
                        auto_reconnect=True)
        c0 = loader.resolve("t", d0)
        s0 = c0.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s0.insert_text(0, "before ")
        assert wait_for(lambda: c0.runtime.pending.count == 0)

        table = EpochTable.for_shard_dir(spec.shard_dir)
        e0 = table.read()["parts"]["0"]["epoch"]
        addr = {i: f"{spec.host}:{p}" for i, p in fl.core_ports.items()}
        src = next(i for i, a in addr.items()
                   if a == table.read()["parts"]["0"]["addr"])
        dst = 1 - src
        res = admin_rpc(spec.host, fl.core_ports[src], {
            "t": "admin_migrate_part", "k": 0, "target": addr[dst]})
        assert res["target"] == addr[dst]
        e1 = table.read()["parts"]["0"]["epoch"]
        assert e1 > e0

        def edit(text):
            def go():
                if not c0.connected:
                    return False
                try:
                    s0.insert_text(len(s0.get_text()), text)
                    return True
                except RuntimeError:
                    return False
            assert wait_for(go, timeout=30)
            assert wait_for(lambda: c0.runtime.pending.count == 0,
                            timeout=30)

        edit("migrated ")
        # the owner of both partitions now is dst: kill it
        if table.read()["parts"]["1"]["addr"] != addr[dst]:
            admin_rpc(spec.host, fl.core_ports[src], {
                "t": "admin_migrate_part", "k": 1, "target": addr[dst]})
        os.kill(fl.procs[dst].pid, signal.SIGKILL)
        fl.procs[dst].wait(timeout=10)
        assert wait_for(
            lambda: table.read()["parts"]["0"]["addr"] == addr[src]
            and table.read()["parts"]["1"]["addr"] == addr[src],
            timeout=30)
        assert table.read()["parts"]["0"]["epoch"] > e1
        edit("taken over")
        fresh = loader.resolve("t", d0)
        assert wait_for(
            lambda: "default" in fresh.runtime.data_stores
            and "text" in fresh.runtime.get_data_store("default").channels
            and fresh.runtime.get_data_store("default").get_channel(
                "text").get_text() == s0.get_text(), timeout=30)
        assert s0.get_text() == "before migrated taken over"
    finally:
        fl.stop()


# ------------------- twins of the rest of tests/test_sharded_core.py, in
# process: cores are port front ends with ``shard_host=`` on background
# threads, the shard-routing gateway a port ``Gateway`` on its own loop

#: the lease TTL of the takeover twins: the JAX file's 1.5 s is for cores
#: in processes of their own; here two cores, a gateway and the clients
#: share one interpreter, so their lease polls get twice the slack
SHARD_TTL = 3.0


class _Gateway:
    """The port's shard-routing gateway (``gateway --shard-dir D
    --shards 2``) on a loop thread of this process."""

    def __init__(self, shard: str):
        import asyncio
        import threading

        from fluidframework_tpu_torch.service.gateway import Gateway

        self.gw = Gateway("127.0.0.1", 0, shard_dir=shard, shards=2)
        ready = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.gw._start())
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(10)
        self.port = self.gw.port

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


def _shard_core(shard: str, prefer: int, ttl_s: float = SHARD_TTL,
                **kw) -> NetworkFrontEnd:
    return NetworkFrontEnd(shard_host=ShardHost(
        shard, 2, prefer=(prefer,), ttl_s=ttl_s), **kw).start_background()


def _stop_cores(fronts) -> None:
    for front in fronts:
        front.stop()
    for front in fronts:
        for s in front.shard_host.servers.values():
            s.log.close()


def test_stalled_core_is_revoked_and_clients_move(tmp_path):
    """A core whose loop stalls past the lease TTL (the GC-pause model,
    a ``SIGSTOP`` in the JAX test) is dispossessed while alive: on resume
    its heartbeat fails, it revokes the partition, and the client lands
    on the takeover owner through the gateway by auto-reconnect."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader

    shard = str(tmp_path / "deploy")
    fronts = [_shard_core(shard, 0), _shard_core(shard, 1)]
    gw = _Gateway(shard)
    try:
        d0 = _docs(1, tenant="t")[0][0]
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", gw.port),
                        auto_reconnect=True)
        c = loader.resolve("t", d0)
        s = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s.insert_text(0, "before stall ")
        assert wait_for(lambda: c.runtime.pending.count == 0)
        assert 0 in fronts[0].shard_host.servers

        # the lease goes stale while core 0's loop sleeps; core 1 claims
        fronts[0]._loop.call_soon_threadsafe(time.sleep, SHARD_TTL + 1.0)
        assert wait_for(lambda: 0 in fronts[1].shard_host.servers,
                        timeout=30)

        def can_edit():
            if not c.connected:
                return False
            try:
                s.insert_text(0, "y")
                return True
            except RuntimeError:
                return False
        assert wait_for(can_edit, timeout=30)
        s.insert_text(len(s.get_text()), " after")
        assert wait_for(lambda: c.runtime.pending.count == 0, timeout=30)
        assert wait_for(lambda: 0 not in fronts[0].shard_host.servers)

        c2 = loader.resolve("t", d0)
        assert wait_for(
            lambda: "default" in c2.runtime.data_stores
            and "text" in c2.runtime.get_data_store("default").channels
            and c2.runtime.get_data_store("default").get_channel(
                "text").get_text() == s.get_text(), timeout=30)
        c.close()
        c2.close()
    finally:
        gw.stop()
        _stop_cores(fronts)


def test_lease_registry_claim_heartbeat_takeover(tmp_path):
    from fluidframework_tpu_torch.service.placement import PlacementDir

    pd = PlacementDir(str(tmp_path / "pl"), 2, ttl_s=0.3)
    assert pd.try_claim(0, "a", "addr-a")
    assert pd.owner_of(0) == "addr-a"
    # live lease refuses another claimant
    assert not pd.try_claim(0, "b", "addr-b")
    # heartbeat keeps it alive across the ttl
    for _ in range(3):
        time.sleep(0.15)
        assert pd.heartbeat(0, "a")
    assert pd.owner_of(0) == "addr-a"
    # stop heartbeating: stale → takeover succeeds
    time.sleep(0.4)
    assert pd.owner_of(0) is None
    assert pd.try_claim(0, "b", "addr-b")
    assert pd.owner_of(0) == "addr-b"
    # the loser notices on its next heartbeat and must stop serving
    assert not pd.heartbeat(0, "a")
    # release clears the file
    pd.release(0, "b")
    assert pd.owner_of(0) is None


def test_admin_tenant_add_secures_partitions_claimed_later(tmp_path):
    """The port's ``admin tenant-add`` on one sharded core secures docs
    in partitions this core claims later by lease takeover, and the
    other core reloads the deployment-wide registry on its lease poll."""
    from fluidframework_tpu_torch import admin
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.tenants import sign_token

    shard = str(tmp_path / "deploy")
    fronts = [_shard_core(shard, 0, admin_secret="adm1n"),
              _shard_core(shard, 1, admin_secret="adm1n")]
    p0, p1 = fronts[0].port, fronts[1].port
    try:
        assert admin.main(["--port", str(p1), "--admin-secret", "adm1n",
                           "tenant-add", "acme", "shh"]) == 0
        d0 = _docs(1, tenant="acme")[0][0]  # a partition core 1 lacks
        assert 0 not in fronts[1].shard_host.servers

        time.sleep(SHARD_TTL)  # > ttl/3 poll cadence
        unsigned0 = Loader(NetworkDocumentServiceFactory("127.0.0.1", p0))
        with pytest.raises(RuntimeError):
            unsigned0.resolve("acme", d0)

        # core 0 dies (its leases are left to go stale); core 1 claims
        fronts[0].stop()
        assert wait_for(lambda: 0 in fronts[1].shard_host.servers,
                        timeout=30)
        unsigned = Loader(NetworkDocumentServiceFactory("127.0.0.1", p1))
        with pytest.raises(RuntimeError):
            unsigned.resolve("acme", d0)
        signed = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", p1,
            token_provider=lambda t, d: sign_token(t, d, "shh")))
        c = signed.resolve("acme", d0)
        assert c.connected
        c.close()
    finally:
        _stop_cores(fronts)


def test_concurrent_connects_no_duplicate_broadcasts(tmp_path):
    """Two clients of one doc connecting concurrently through a fresh
    gateway get every broadcast once (the gateway's lazy per-core dial
    must not open two backbone connections)."""
    import threading

    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader

    shard = str(tmp_path / "deploy")
    # no takeover here: a long TTL keeps a loaded test process's lease
    # polls from dropping the partitions mid-connect
    fronts = [_shard_core(shard, 0, ttl_s=30.0),
              _shard_core(shard, 1, ttl_s=30.0)]
    gw = _Gateway(shard)
    try:
        d0 = _docs(1, tenant="t")[0][0]
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", gw.port))
        results = [None, None]

        def resolve(i):
            results[i] = loader.resolve("t", d0)

        threads = [threading.Thread(target=resolve, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        c1, c2 = results
        assert c1 is not None and c2 is not None

        s1 = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        for i in range(10):
            s1.insert_text(0, f"x{i}")
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        assert wait_for(
            lambda: c2.runtime.data_stores and "text" in
            c2.runtime.get_data_store("default").channels and
            c2.runtime.get_data_store("default").get_channel(
                "text").get_text() == s1.get_text())
        assert c1.delta_manager.duplicates_received == 0
        assert c2.delta_manager.duplicates_received == 0
        c1.close()
        c2.close()
    finally:
        gw.stop()
        _stop_cores(fronts)
