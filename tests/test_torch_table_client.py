"""Networked placement plane twin: the port's ``service/table_client.py``,
the storage server's table door and ``service/topology.py`` against the JAX
package's, on the CPU.

The local/remote equivalence fuzz runs at seeds 0, 7 and 42: the same
claim/heartbeat/transfer/release plan through the port's flock, through
the port's table door (a ``StorageServer(table_door=)`` on a daemon
thread) and through the JAX package's flock gives one trace and one final
table. A zombie ex-owner is fenced through the remote path in both
packages alike, and a JAX client reaches the port's door. A
``TopologySpec`` saved by either package is read by the other, unknown
keys included, and both derive the same multi-host views.
"""

import random
import threading
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service import table_client as jax_tc
from fluidframework_tpu.service import topology as jax_topology
from fluidframework_tpu.utils.telemetry import Counters as JaxCounters
from fluidframework_tpu_torch.service import table_client as port_tc
from fluidframework_tpu_torch.service import topology as port_topology
from fluidframework_tpu_torch.service.storage_server import StorageServer
from fluidframework_tpu_torch.utils.telemetry import Counters

N_PARTS = 4
OWNERS = ("a", "b", "c")


@pytest.fixture
def door(tmp_path):
    """Start the port's table door on a real socket (a storage server on
    a daemon thread); yields a factory, stops every door at the end."""
    servers = []

    def start(name, ttl_s=30.0):
        shard_dir = str(tmp_path / name)
        srv = StorageServer(str(tmp_path / f"{name}-storage"), port=0,
                            table_door=port_tc.TableDoorService(
                                shard_dir, N_PARTS, ttl_s=ttl_s))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        deadline = time.monotonic() + 10.0
        while srv.port == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.port, "door server did not bind"
        servers.append(srv)
        return f"127.0.0.1:{srv.port}"

    yield start
    for srv in servers:
        srv.stop()


def _plan(seed: int) -> list:
    rng = random.Random(seed)
    return [(rng.choice(("claim", "heartbeat", "release", "transfer",
                         "owner_of", "epoch")),
             rng.randrange(N_PARTS), rng.choice(OWNERS),
             rng.choice(OWNERS)) for _ in range(120)]


def _run(client, ops) -> list:
    trace = []
    for op, k, o, o2 in ops:
        addr = f"addr-{o}"
        if op == "claim":
            ok = client.leases.try_claim(k, o, addr)
            trace.append(("claim", k, o, ok))
            if ok:
                trace.append(("epoch",
                              client.table.record_claim(k, o, addr)))
        elif op == "heartbeat":
            trace.append(("hb", k, o, client.leases.heartbeat(k, o)))
        elif op == "release":
            if client.leases.owner_of(k) == addr:
                client.leases.release(k, o)
                trace.append(("release", k, o,
                              client.table.record_release(k, o)))
        elif op == "transfer":
            ok = client.leases.transfer(k, o, o2, f"addr-{o2}")
            trace.append(("transfer", k, o, o2, ok))
            if ok:
                trace.append(("epoch", client.table.record_claim(
                    k, o2, f"addr-{o2}")))
        elif op == "owner_of":
            trace.append(("owner_of", k, client.leases.owner_of(k)))
        elif op == "epoch":
            trace.append(("gepoch", client.table.global_epoch()))
    return trace


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_local_remote_equivalence_fuzz(tmp_path, door, seed):
    """One plan through the port's flock, the port's door and the JAX
    package's flock: identical traces, leases and epoch records."""
    ops = _plan(seed)
    local = port_tc.LocalTableClient(str(tmp_path / "local"), N_PARTS,
                                     ttl_s=30.0, counters=Counters())
    remote = port_tc.RemoteTableClient(door("remote"), N_PARTS,
                                       ttl_s=30.0, counters=Counters())
    jax_local = jax_tc.LocalTableClient(str(tmp_path / "jax"), N_PARTS,
                                        ttl_s=30.0, counters=JaxCounters())
    trace = _run(local, ops)
    assert _run(remote, ops) == trace
    assert _run(jax_local, ops) == trace
    assert local.leases.table() == remote.leases.table() == \
        jax_local.leases.table()
    remote.table._invalidate()
    recs = [c.table.read() for c in (local, remote, jax_local)]
    assert len({r["epoch"] for r in recs}) == 1
    assert recs[0]["parts"] == recs[1]["parts"] == recs[2]["parts"]
    remote.close()


def _zombie(tc, counters_cls, addr) -> tuple:
    ca, cb = counters_cls(), counters_cls()
    zombie = tc.RemoteTableClient(addr, N_PARTS, ttl_s=0.6, counters=ca)
    usurper = tc.RemoteTableClient(addr, N_PARTS, ttl_s=0.6, counters=cb)
    try:
        assert zombie.leases.try_claim(0, "a", "addr-a")
        e1 = zombie.table.record_claim(0, "a", "addr-a")
        time.sleep(0.9)  # the lease expires; "a" never heartbeats again
        assert usurper.leases.try_claim(0, "b", "addr-b")
        e2 = usurper.table.record_claim(0, "b", "addr-b")
        with pytest.raises(tc.TableFenceError):
            zombie.table.record_claim(0, "a", "addr-a")
        assert ca.snapshot().get("placement.table.stale_rejections") == 1
        usurper.table._invalidate()
        rec = usurper.table.read()
        assert rec["epoch"] == e2
        assert rec["parts"]["0"]["owner"] == "b"
        return e1, e2
    finally:
        zombie.close()
        usurper.close()


def test_zombie_ex_owner_fenced_via_remote_path(door):
    """A remote zombie whose lease was taken over is refused by the
    port's door (``TableFenceError``, ``stale_rejections``), the port's
    client and the JAX package's client alike, at the same epochs."""
    got = _zombie(port_tc, Counters, door("port", ttl_s=0.6))
    assert got == _zombie(jax_tc, JaxCounters, door("jax", ttl_s=0.6))


class _FakeChan:
    """A scripted door: counts calls, serves a mutable record."""

    def __init__(self):
        self.rec = {"epoch": 1, "parts": {}, "cores": {}}
        self.calls = 0

    def call(self, frame):
        assert frame["t"] == "admin_table_read"
        self.calls += 1
        return {"t": "table_rec", "rec": dict(self.rec)}


def test_remote_snapshot_epoch_gated_coherence():
    """Reads inside SNAP_TTL_S hit the snapshot; a newer ``note_epoch``
    drops it at once; an older or equal one is ignored."""
    chan, c = _FakeChan(), Counters()
    table = port_tc.RemoteEpochTable(chan, c)
    assert table.global_epoch() == 1
    assert table.global_epoch() == 1
    assert chan.calls == 1
    assert c.snapshot()["placement.table.cache_hits"] == 1
    table.note_epoch(1)
    assert table.global_epoch() == 1 and chan.calls == 1
    chan.rec["epoch"] = 5
    table.note_epoch(5)
    assert table.global_epoch() == 5 and chan.calls == 2
    assert c.snapshot()["placement.table.rpc_reads"] == 2


@pytest.mark.parametrize("writer, reader", [
    (port_topology, jax_topology), (jax_topology, port_topology)])
def test_topology_spec_json_read_by_both(tmp_path, writer, reader):
    """A spec saved by one package loads in the other to the same dict,
    unknown top-level keys included, and saves back byte for byte."""
    d = {"shard_dir": str(tmp_path / "s"), "n_partitions": 4,
         "cores": [{"name": "c0", "prefer": [0, 1]},
                   {"name": "c1", "prefer": [2, 3], "port": 7001}],
         "gateways": [{"name": "g0"}], "lease_ttl": 1.5,
         "rebalance": {"tick_s": 0.5}, "future_knob": {"x": 1},
         "operator_note": "keep me"}
    spec = writer.TopologySpec.from_dict(d)
    assert spec.extras == {"future_knob": {"x": 1},
                           "operator_note": "keep me"}
    path = spec.save(str(tmp_path / "spec.json"))
    text = open(path).read()
    back = reader.TopologySpec.load(path)
    assert back.to_dict() == spec.to_dict()
    assert back.to_dict()["future_knob"] == {"x": 1}
    assert back.to_dict()["n_partitions"] == 4
    back.save(str(tmp_path / "again.json"))
    assert open(tmp_path / "again.json").read() == text


def test_multihost_spec_derived_views(tmp_path):
    """Host groups derive the same dirs, claim policy and gateway argv in
    both packages; the port's argv names the port's modules; a remote
    group without a table door is refused."""
    shard = str(tmp_path / "fleet")
    specs = {}
    for name, mod in (("jax", jax_topology), ("torch", port_topology)):
        spec = mod.multihost_spec(shard, n_hosts=2, cores_per_host=2,
                                  n_partitions=8)
        spec.table_server = "127.0.0.1:9999"
        specs[name] = spec
    spec = specs["torch"]
    assert spec.to_dict() == specs["jax"].to_dict()
    assert spec.placement_host_id() == "h0"
    assert spec.core_dir(0) == shard
    assert spec.core_dir(3) == f"{shard}-host-h1"
    assert spec.claim_policy == "prefer"
    core_ports = {i: 7000 + i for i in range(4)}
    for i in range(len(spec.gateways)):
        argv = spec.gateway_argv(i, core_ports, {}, python="py")
        want = specs["jax"].gateway_argv(i, core_ports, {}, python="py")
        assert argv[2] == "fluidframework_tpu_torch.service.gateway"
        assert argv[3:] == want[3:]
        assert ("--table-server" in argv) == (spec.gateway_host(i) == "h1")
    assert spec.core_argv(1, "s.json", python="py") == [
        "py", "-m", "fluidframework_tpu_torch.service.front_end",
        "--topology", "s.json", "--core-index", "1"]
    spec.table_server = None
    bad = next(i for i in range(len(spec.gateways))
               if spec.gateway_host(i) == "h1")
    with pytest.raises(RuntimeError):
        spec.gateway_argv(bad, core_ports, {})
