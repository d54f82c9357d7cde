"""Lease heartbeat witness: the JAX package's sharded fleet beside the
port's, at the width of ``chip_smoke.py``'s ``sharded`` phase, on one
machine with one card.

    python3 sharded_lease_witness.py [--order jax,port,port,jax]

Each run starts one package's ``service.topology.Fleet`` as processes from
the same ``TopologySpec``: two cores over one shard dir (``--shards 2``,
core ``i`` preferring partition ``i``, the smoke's lease TTL, boot
admission off) and two shard-routing gateways. Both packages' cores are
host code: the JAX package's import no JAX. Beside them run the port's applier stage children
on the card, one a partition log (the durable-log format is shared, so the
same child tails either package's cores), so that each run has the smoke's
processes. The smoke's socket load (1024 docs x 2 clients x 48 ops in two
halves, boxcars of 12 at 0.4 Hz, the port's ``load_async`` workers through
the gateways) runs with partition 0 migrating from core 0 to core 1
between the halves, beside the smoke's 64 containers of the port's client
stack, 8 of them probing. A thread samples each partition lease file's mtime
every 50 ms (a heartbeat touches it).

Prints one JSON line a run: the longest gap between two heartbeats of
each partition against the fence (75% of the TTL) and how far past the
poll's period (TTL/3) it ran, each half's ops/s and ack p99, each
partition's epochs, the cores' CPU seconds, the leases taken over, and
whether the run failed (chip_smoke's checks of the load); then the card's
name and power limit. A failed run does not stop the next one. Exits
nonzero when a run failed or a core's journal shows a lease taken over.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import threading
import time

import chip_smoke as smoke
from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Loader

PACKAGES = {"jax": "fluidframework_tpu", "port": "fluidframework_tpu_torch"}


def _takeovers(shard: str) -> int:
    """Leases lost to a peer or claimed from a live owner, from the cores'
    journals (a migration hands its lease over and journals neither)."""
    n = 0
    jdir = os.path.join(shard, "journal")
    for name in os.listdir(jdir) if os.path.isdir(jdir) else ():
        with open(os.path.join(jdir, name)) as f:
            for ln in f:
                e = json.loads(ln) if ln.strip() else {}
                n += e.get("kind") == "lease.takeover" or bool(
                    e.get("kind") == "lease.claim" and e.get("takeover"))
    return n


def one_run(which: str, root: str, device: str) -> dict:
    pkg = PACKAGES[which]
    ttl = smoke.SHARDED_TTL_S
    topo = importlib.import_module(f"{pkg}.service.topology")
    plane = importlib.import_module(f"{pkg}.service.placement_plane")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shard = os.path.join(root, "deploy")
    err_path = os.path.join(root, "stderr.txt")
    open(err_path, "w").close()
    spec = topo.TopologySpec(
        shard_dir=shard, n_partitions=2, lease_ttl=ttl, boot_rate=0.0,
        cores=[topo.CoreSpec(name=f"core{i}", prefer=[i]) for i in range(2)],
        gateways=[topo.GatewaySpec(name=f"gw{i}") for i in range(2)])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [smoke.HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                        if p])
    # the cores' durable-log library, built once before they start: the
    # JAX package's build renames a temp file of a fixed name, so two
    # cores building it at once race
    importlib.import_module(f"{pkg}.native.build").load_library("oplog")
    table = plane.EpochTable.for_shard_dir(shard)
    fleet = topo.Fleet(spec, subprocess=True, env=env)
    stages, procs, conts, leases = [], [], [], None
    row = {"package": pkg, "lease_ttl_s": ttl, "fence_s": 0.75 * ttl,
           "failed": False}
    t_run = time.perf_counter()
    try:
        fleet.start()
        for p in [*fleet.procs.values(), *fleet.gw_procs.values()]:
            threading.Thread(target=lambda p=p: shutil.copyfileobj(
                p.stdout, open(err_path, "a")), daemon=True).start()
        fleet.wait_claimed(timeout=smoke.CHILD_TIMEOUT_S)
        parts = table.read()["parts"]
        epochs = {k: [parts[str(k)]["epoch"]] for k in range(2)}
        leases = smoke._LeaseWatch(shard, 2)
        for k in range(2):
            stages.append(smoke._StageProcess(
                os.path.join(shard, f"log-{k}"),
                os.path.join(root, f"stage{k}"), device, err_path,
                what=f"{which} stage {k}"))
        servers = {"core0": fleet.procs[0].pid, "core1": fleet.procs[1].pid}
        ports = [fleet.gw_ports[0], fleet.gw_ports[1]] * 2
        # the smoke's 64 containers through the gateways, 8 of them probing:
        # a gateway learns a partition's new owner from the placement push
        # on its open sessions
        strings = []
        for i in range(smoke.SHARDED_TAIL_DOCS):
            c = Loader(NetworkDocumentServiceFactory(
                "127.0.0.1", ports[i % 2]), auto_reconnect=True
            ).resolve("bench", f"shc{i}")
            s = c.runtime.create_data_store("default").create_channel(
                "text", "shared-string")
            s.insert_text(0, f"doc {i} ")
            conts.append(c)
            strings.append(s)
        probe = smoke._Probe(strings[:smoke.SHARDED_PROBES],
                             conts[:smoke.SHARDED_PROBES])
        halves = []
        load, _ = smoke._run_load(smoke.SHARDED_RUN, ports, "shd", servers,
                                  procs, err_path, which)
        halves.append(load)
        # the smoke's timeline: its probe's baseline and window around the
        # migration (a gateway learns the new owner within them)
        time.sleep(smoke.SHARDED_PROBE_WINDOW_S)
        target = f"{spec.host}:{fleet.core_ports[1]}"
        res = plane.admin_rpc("127.0.0.1", fleet.core_ports[0], {
            "t": "admin_migrate_part", "k": 0, "target": target},
            timeout=60.0)
        if res.get("target") != target:
            smoke.fail(f"{which}: the migration answered {res}")
        epochs[0].append(table.read()["parts"]["0"]["epoch"])
        time.sleep(smoke.SHARDED_PROBE_WINDOW_S)
        load, _ = smoke._run_load(smoke.SHARDED_RUN, ports, "shd", servers,
                                  procs, err_path, which)
        halves.append(load)
        probe.join()
        parts = table.read()["parts"]
        for k in range(2):
            if parts[str(k)]["epoch"] != epochs[k][-1]:
                epochs[k].append(parts[str(k)]["epoch"])
        row["epochs"] = epochs
        row["halves"] = [{key: h[key] for key in (
            "ops", "ops_per_sec", "p50_ack_ms", "p99_ack_ms",
            "connect_seconds", "cpu_seconds")} for h in halves]
        row["cpu_seconds_total"] = {k: smoke._cpu_seconds(pid)
                                    for k, pid in servers.items()}
    except SystemExit:  # chip_smoke.fail: the load or a check failed
        row["failed"] = True
    finally:
        if leases is not None:
            gaps = leases.join()
            row["lease_heartbeat_gap_max_s"] = list(gaps)
            # past the poll's period (TTL/3): how late the heartbeat ran
            row["lease_heartbeat_late_max_s"] = [g - ttl / 3 for g in gaps]
        for c in conts:
            c.close()
        fleet.stop()
        for st in stages:
            if st.proc.poll() is None:
                st.kill()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    row["takeovers"] = _takeovers(shard)
    row["seconds"] = time.perf_counter() - t_run
    if not row["failed"]:  # a failed run keeps its stderr and shard dir
        shutil.rmtree(root, ignore_errors=True)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="jax,port,port,jax",
                    help="comma-separated runs, each 'jax' or 'port'")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    order = args.order.split(",")
    if set(order) - set(PACKAGES):
        ap.error(f"--order takes {sorted(PACKAGES)}")
    if args.device == "cuda" and not smoke.torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false")
    root = os.path.join(smoke.HERE, "build", "witness")
    power = smoke.nvidia_smi() if args.device == "cuda" else "no card"
    rows = []
    for i, which in enumerate(order):
        rows.append(one_run(which, os.path.join(root, f"run{i}"),
                            args.device))
        smoke.emit({**rows[-1], "card": power})
    print(power, flush=True)
    bad = [r["package"] for r in rows if r["takeovers"] or r["failed"]]
    if bad:
        smoke.fail(f"a run failed or a lease was taken over: {bad}")


if __name__ == "__main__":
    sys.exit(main())
