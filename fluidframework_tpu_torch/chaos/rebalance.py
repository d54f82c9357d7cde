"""Chaos rebalance campaign: the self-driving placement loop under
hostile load shapes.

JAX counterpart: ``fluidframework_tpu/chaos/rebalance.py``; the port's
copy of the rebalancer campaign, imports rebased to this package.

``python -m fluidframework_tpu_torch.chaos.rebalance --seed N`` runs a seeded
in-proc campaign against service/rebalancer.py: four doc partitions in
one shard dir, ShardHost "cores" with a short lease TTL, seeded
merge-tree clients editing through whichever core owns their partition
(chaos/migrate.py's MigrateClient — submits bounced by a mid-migration
seal resubmit in cseq order), and one Rebalancer per core ticked
deterministically by the campaign (no ticker threads):

- **hotspot storm** — one core starts owning everything with a viral
  partition; a cold core joins. The armed loop must spread the load
  (``placement.rebalance.migrations_issued`` > 0, every live core ends
  up owning partitions) without losing an op.
- **flap bait** — synthetic heat oscillates so yesterday's move looks
  reversible every tick. The dwell gate must hold: suppression counted
  (``placement.rebalance.suppressed_hysteresis`` > 0), migrations
  bounded by one-move-per-part, flap count (re-migration of the same
  partition inside its dwell window) exactly zero.
- **core kill -9 + auto-heal** (full mode) — the busiest core is
  abandoned without releasing leases or closing logs; the survivors
  take its partitions over on the lease TTL and the loop re-spreads.
  The dead core stays registered in the membership — unreachability
  alone must keep it off the target list.
- **elastic 2→4→2** — two cold cores join under steady traffic and the
  loop drains load onto them (per-core heat spread narrows,
  counter-verified); ``set_core_state(draining)`` then evacuates them
  — every partition migrated away dwell/threshold-exempt — and each
  marks itself drained for clean decommission.

The run settles and replays every partition's multi-owner durable log
from offset 0 through an :class:`InvariantMonitor`: no gap, no dupe, no
lost or double-resolved submission, every replica converging to the
log-replay oracle. Same seed ⇒ same edit streams. Exit 1 on violation.
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
import sys
import tempfile
import time

from ..obs import MetricsRegistry, tier_counters
from ..utils.telemetry import Counters
from .migrate import TENANT, TTL, MigrateClient, _doc_for_partition, \
    _log_fingerprint
from .monitor import InvariantMonitor, InvariantViolation
from .soak import _replica_fingerprint

N_PARTS = 4


def run_campaign(seed: int, counters: Counters,
                 quick: bool = False) -> dict:
    from ..service.front_end import ShardHost
    from ..service.placement_plane import (
        CORE_DRAINED,
        CORE_DRAINING,
        EpochTable,
        MigrationEngine,
    )
    from ..service.rebalancer import (
        HEAT_OPS,
        PartHeat,
        Rebalancer,
        read_local_heat,
    )

    rng = random.Random(seed)
    pc = tier_counters("placement")
    # campaign-held registry: the REAL windowed heat machinery, but
    # isolated from the process-global registry other chaos runs share
    reg = MetricsRegistry()
    shard_dir = tempfile.mkdtemp(prefix="chaos-rebalance-")
    n = N_PARTS
    hosts: list = []
    rebs: dict = {}
    dead: set = set()  # id() of killed hosts — abandoned, never closed
    dead_owners: set = set()
    # when set, heat_readers serve this synthetic map instead of the
    # registry — the flap-bait phase needs per-tick oscillation faster
    # than any real window
    synth = {"heat": None}
    try:
        docs = [_doc_for_partition(k, n) for k in range(n)]
        table = EpochTable.for_shard_dir(shard_dir)

        def alive() -> list:
            return [h for h in hosts if id(h) not in dead]

        def owner_server(k: int):
            for h in alive():
                s = h.servers.get(k)
                if s is not None and not s.sealed:
                    return s
            return None

        def drain_alive() -> None:
            for h in alive():
                for s in list(h.servers.values()):
                    s.drain()

        def poll_alive() -> None:
            for h in alive():
                h.poll()

        def await_owner(k: int, timeout: float = 15.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                poll_alive()
                s = owner_server(k)
                if s is not None:
                    return s
                time.sleep(0.05)
            raise InvariantViolation(
                f"no live owner for partition {k} within {timeout}s — "
                "lease takeover did not happen")

        def make_rebalancer(h, dwell_s: float) -> "Rebalancer":
            def heat_reader(owners, cores, now):
                if synth["heat"] is not None:
                    heat = {k: PartHeat(ops=synth["heat"].get(k, 0.0))
                            for k in owners}
                else:
                    heat = read_local_heat(list(owners), now=now,
                                           registry=reg)
                return heat, {o for o in cores if o not in dead_owners}

            def actuate(k, target_addr, h=h):
                tgt = next(x for x in alive()
                           if x.address == target_addr)
                eng_s = MigrationEngine(h, counters=pc)
                eng_t = MigrationEngine(tgt, counters=pc)
                eng_s.migrate(
                    k, target_addr,
                    adopt=lambda kk, addr: eng_t.adopt(kk, h.owner_id))

            # cooldown_s=0: the injected heat reader is instant truth
            # (shared registry / synthetic map), so the signal-lag
            # cool-down would only slow the deterministic tick script
            return Rebalancer(h, None, heat_reader=heat_reader,
                              actuate=actuate, counters=pc,
                              dwell_s=dwell_s, cooldown_s=0.0,
                              budget=1, improvement=0.25)

        def spawn(prefer=(), dwell_s: float = 1.0) -> "ShardHost":
            h = ShardHost(shard_dir, n, prefer=prefer, ttl_s=TTL)
            h.address = f"inproc/{h.owner_id}"
            h.table.counters = pc
            hosts.append(h)
            h.poll()
            rebs[id(h)] = make_rebalancer(h, dwell_s)
            return h

        def tick_all() -> None:
            for h in alive():
                plan = rebs[id(h)].tick()
                err = rebs[id(h)].last_error
                if err is not None:
                    raise InvariantViolation(
                        f"rebalancer tick failed on {h.owner_id}: {err}")
                del plan

        def all_flaps() -> int:
            return sum(r.flap_count() for r in rebs.values())

        def live_loads() -> dict:
            """Per-core heat sums from the registry — the spread the
            counters verify (exact windowed sums, no sampling)."""
            heat = read_local_heat(range(n), registry=reg)
            return {h.owner_id:
                    sum(heat[k].load for k in h.servers)
                    for h in alive()}

        def spread() -> float:
            """Relative heat spread (max-min over total) across live
            cores: 1.0 = one core carries everything, 0.0 = flat.
            Normalized because window sums keep growing while the
            campaign runs."""
            loads = list(live_loads().values())
            if len(loads) < 2 or sum(loads) <= 0:
                return 0.0
            return (max(loads) - min(loads)) / sum(loads)

        # ---- topology: one core owns EVERYTHING, one cold joiner -----
        src0 = spawn(prefer=tuple(range(n)))
        if sorted(src0.servers) != list(range(n)):
            raise InvariantViolation("preferring core failed to claim")
        spawn()  # the storm's cold joiner

        monitors = [InvariantMonitor(counters) for _ in range(n)]
        clients = []
        for k in range(n):
            c = MigrateClient(docs[k], (lambda k=k: owner_server(k)),
                              monitors[k], counters,
                              random.Random(seed * 1000 + k))
            c.part_k = k
            clients.append(c)
        for c in clients:
            if not c.connect():
                raise InvariantViolation("initial connect failed")
        drain_alive()

        hot = {"k": 0}

        def rounds(nr: int) -> None:
            for _ in range(nr):
                for c in clients:
                    n_ops = 6 if c.part_k == hot["k"] \
                        else 1 + rng.randrange(2)
                    before = c.cseq
                    c.edit(n_ops)
                    submitted = c.cseq - before
                    if submitted:
                        reg.observe_windowed(HEAT_OPS, float(submitted),
                                             part=str(c.part_k))
                drain_alive()
                poll_alive()
                for c in clients:
                    if c.conn is None or c.severed or c.nacked:
                        c.reconnect()
                drain_alive()

        # ---------------------------------------------- hotspot storm
        rounds(3)  # warm the heat window before the loop is armed
        spread_at_start = spread()  # one core carries everything: ~1.0
        storm_rounds = 12 if quick else 24
        for i in range(storm_rounds):
            rounds(1)
            tick_all()
            if all(h.servers for h in alive()) and i >= 2:
                break
        issued = pc.snapshot().get(
            "placement.rebalance.migrations_issued", 0)
        if issued < 1:
            raise InvariantViolation(
                "hotspot storm: the armed loop issued no migrations")
        if any(not h.servers for h in alive()):
            raise InvariantViolation(
                "hotspot storm: a live core ended up owning nothing — "
                "load did not spread")
        if spread() >= spread_at_start:
            raise InvariantViolation(
                f"hotspot storm: heat spread did not narrow "
                f"({spread_at_start:.2f} -> {spread():.2f})")

        # ------------------------------------------------- flap bait
        # oscillating synthetic heat: the hot partition alternates, so
        # every tick yesterday's move looks tempting to undo. Fresh
        # rebalancers with an effectively infinite dwell: each part may
        # move at most once, the rest is counted suppression.
        for h in alive():
            rebs[id(h)] = make_rebalancer(h, dwell_s=10_000.0)
        supp_before = pc.snapshot().get(
            "placement.rebalance.suppressed_hysteresis", 0)
        issued_before = pc.snapshot().get(
            "placement.rebalance.migrations_issued", 0)
        bait = sorted(range(n))
        for i in range(14):
            hot_k = bait[i % 2]  # partitions 0/1 alternate as viral
            synth["heat"] = {k: (40.0 if k == hot_k else 10.0)
                             for k in range(n)}
            tick_all()
            poll_alive()
        synth["heat"] = None
        snap = pc.snapshot()
        flap_migrations = snap.get(
            "placement.rebalance.migrations_issued", 0) - issued_before
        if snap.get("placement.rebalance.suppressed_hysteresis",
                    0) <= supp_before:
            raise InvariantViolation(
                "flap bait: no hysteresis suppression counted — the "
                "dwell gate never engaged")
        if flap_migrations > n:
            raise InvariantViolation(
                f"flap bait: {flap_migrations} migrations in the bait "
                f"phase (> one per partition) — the loop is flapping")
        if all_flaps() != 0:
            raise InvariantViolation(
                f"flap count {all_flaps()} != 0 — a partition "
                "re-migrated inside its dwell window")
        for h in alive():  # back to the live-load loop
            rebs[id(h)] = make_rebalancer(h, dwell_s=1.0)
        rounds(2)

        # ------------------------------------- kill -9 + auto-heal
        killed = 0
        if not quick:
            victim = max(alive(), key=lambda h: (len(h.servers),
                                                 h.owner_id))
            lost = sorted(victim.servers)
            dead.add(id(victim))
            dead_owners.add(victim.owner_id)
            for c in clients:
                if c.server is not None and any(
                        s is c.server for s in victim.servers.values()):
                    c.sever()
            if len(alive()) < 2:
                spawn()  # keep a rebalance target alive
            for k in lost:
                await_owner(k)
            killed = 1
            # the dead core is still registered active in the table:
            # unreachability must keep it off the target list while the
            # survivors re-spread
            for _ in range(8 if quick else 12):
                rounds(1)
                tick_all()
                if all(h.servers for h in alive()):
                    break
            owned = {k for h in alive() for k in h.servers}
            if owned != set(range(n)):
                raise InvariantViolation(
                    f"auto-heal: partitions {set(range(n)) - owned} "
                    "unowned after the kill")
            table.remove_core(victim.owner_id)  # operator cleanup

        # --------------------------------------- elastic join (…→4)
        hot["k"] = None  # steady traffic: every partition equally warm
        joiners = [spawn(), spawn()]
        rounds(3)
        spread_joined = spread()
        for _ in range(10 if quick else 16):
            rounds(1)
            tick_all()
            if all(j.servers for j in joiners):
                break
        if any(not j.servers for j in joiners):
            raise InvariantViolation(
                "elastic join: a cold joiner absorbed nothing")
        if spread() >= spread_joined:
            raise InvariantViolation(
                f"elastic join: heat spread did not narrow "
                f"({spread_joined:.1f} -> {spread():.1f})")

        # -------------------------------------- elastic drain (4→…)
        for j in joiners:
            if not table.set_core_state(j.owner_id, CORE_DRAINING):
                raise InvariantViolation("drain mark refused for a "
                                         "registered core")
        for _ in range(12 if quick else 20):
            rounds(1)
            poll_alive()  # pick up the drain mark
            tick_all()
            if all(not j.servers for j in joiners):
                break
        for j in joiners:
            if j.servers:
                raise InvariantViolation(
                    f"drain: core {j.owner_id} still owns "
                    f"{sorted(j.servers)} — evacuation incomplete")
        rounds(1)
        poll_alive()
        tick_all()  # the empty tick flips draining → drained
        for j in joiners:
            if table.core_state(j.owner_id) != CORE_DRAINED:
                raise InvariantViolation(
                    f"drain: core {j.owner_id} never marked drained")
            dead.add(id(j))  # decommission: stop polling it
            table.remove_core(j.owner_id)

        # ------------------------------------------ settle + verdict
        for _ in range(30):
            drain_alive()
            poll_alive()
            if all(c.settled for c in clients):
                break
            for c in clients:
                if not c.settled:
                    c.reconnect()
            time.sleep(0.02)
        drain_alive()
        for c in clients:
            if c.conn is not None:
                c.catch_up()

        sequenced = {}
        for k in range(n):
            final = owner_server(k)
            if final is None:
                raise InvariantViolation(
                    f"no live owner for partition {k} at quiescence")
            monitors[k].attach(final.log, f"deltas/{TENANT}/{docs[k]}")
            final.drain()
            monitors[k].check_quiescent({
                f"client{k}": _replica_fingerprint(clients[k].replica),
                "oracle": _log_fingerprint(final, docs[k])})
            sequenced[docs[k]] = monitors[k].observed
        if sum(sequenced.values()) < 40:
            raise InvariantViolation(
                f"observed only {sum(sequenced.values())} sequenced "
                "messages — the workload did not run")

        delta = {k: v for k, v in pc.snapshot().items() if v}
        if delta.get("placement.rebalance.ticks", 0) < 10:
            raise InvariantViolation("the loop barely ticked")
        if delta.get("placement.rebalance.migrations_issued", 0) < 3:
            raise InvariantViolation(
                "fewer than 3 automatic migrations across storm + "
                "join + drain")
        if delta.get("placement.rebalance.suppressed_hysteresis", 0) < 1:
            raise InvariantViolation("no hysteresis suppression counted")
        if delta.get("placement.migration.committed", 0) < \
                delta.get("placement.rebalance.migrations_issued", 0):
            raise InvariantViolation(
                "issued migrations were not all committed")
        if all_flaps() != 0:
            raise InvariantViolation("flap count nonzero at verdict")

        return {
            "seed": seed,
            "quick": quick,
            "killed": killed,
            "reconnects": sum(c.reconnects for c in clients),
            "sequenced": sequenced,
            "spread_final": round(spread(), 2),
            "placement": dict(sorted(delta.items())),
            "counters": {k: v for k, v in sorted(
                counters.snapshot().items()) if k.startswith("chaos.")},
        }
    finally:
        for h in hosts:
            for s in list(h.servers.values()):
                try:
                    s.log.close()
                except Exception:
                    pass
        shutil.rmtree(shard_dir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chaos rebalance campaign: hotspot storm, flap "
                    "bait, core kill + auto-heal, elastic 2→4→2 "
                    "(tier-1 entry point)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="storm + flap + elastic, no kill (CI smoke)")
    args = parser.parse_args(argv)
    counters = tier_counters("chaos")
    try:
        result = run_campaign(args.seed, counters, quick=args.quick)
    except InvariantViolation as e:
        print(f"REBALANCE CAMPAIGN FAILED (seed {args.seed}): {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
