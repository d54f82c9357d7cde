"""Rebalancer twin: the port's ``service/rebalancer.py`` (and the epoch
table's membership section it reads) against the JAX package's, on the
CPU.

The planner cases of ``tests/test_rebalancer.py`` are cases of one
parametrised test: each keeps its own assertions on the port's plan, and
the plan must equal the JAX planner's on the same input, move for move.
Permuted input, elastic membership, a draining host, the windowed heat
read, fleet counter sums and the daemon's tick loop over real in-process
migrations run through both packages and are compared.
"""

import random
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]
    reb = import_module(f"{root}.service.rebalancer")
    plane = import_module(f"{root}.service.placement_plane")
    obs = import_module(f"{root}.obs")
    return SimpleNamespace(
        reb=reb, plane=plane, obs=obs,
        ShardHost=import_module(f"{root}.service.front_end").ShardHost,
        Counters=import_module(f"{root}.utils.telemetry").Counters)


PKGS = {name: _pkg(name) for name in ROOTS}
PORT, JAX = PKGS["torch"], PKGS["jax"]


def _cores(P, *owners, draining=()):
    return {o: {"addr": f"addr-{o}",
                "state": (P.plane.CORE_DRAINING if o in draining
                          else P.plane.CORE_ACTIVE)}
            for o in owners}


def _plan(P, heat, owners, cores, last_moved=None, now=100.0, **kw):
    kw.setdefault("dwell_s", 10.0)
    kw.setdefault("budget", 2)
    kw.setdefault("improvement", 0.25)
    return P.reb.plan_rebalance(heat, owners, cores, last_moved or {}, now,
                                **kw)


def _heat(P, loads: dict) -> dict:
    return {k: P.reb.PartHeat(*v) if isinstance(v, tuple)
            else P.reb.PartHeat(ops=v) for k, v in loads.items()}


# ------------------------------------------------------------- planner


def _balanced(plan):
    assert plan.moves == ()
    assert plan.suppressed_hysteresis == 0
    assert plan.spread_before == plan.spread_after == 0.0


def _hotspot(plan):
    assert plan.moves and all(m.src == "a" for m in plan.moves)
    assert plan.spread_after < plan.spread_before
    assert {m.dst for m in plan.moves} <= {"b", "c"}


def _dwell_held(plan):
    assert plan.moves == () and plan.suppressed_hysteresis == 2


def _dwell_released(plan):
    assert [m.k for m in plan.moves] == [0]
    assert plan.suppressed_hysteresis == 0


def _budget_one(plan):
    assert len(plan.moves) == 1 and plan.suppressed_budget == 1


def _budget_three(plan):
    assert len(plan.moves) > 1


def _calm(plan):
    assert plan.moves == ()


def _slo_hot(plan):
    assert [m.k for m in plan.moves] == [1]


def _join(plan):
    assert plan.moves and all(m.dst == "c" for m in plan.moves)
    assert plan.spread_after < plan.spread_before


def _drain(plan):
    assert sorted(m.k for m in plan.moves) == [0, 1]
    assert all(m.src == "b" and m.dst == "a" for m in plan.moves)
    assert plan.moves[0].k == 1  # the hottest part leaves first


def _only_b(plan):
    assert plan.moves == ()


def _only_a(plan):
    assert all(m.src == "a" for m in plan.moves)
    assert all(m.k != 1 for m in plan.moves)  # ghost's part never planned


def _no_overshoot(plan):
    assert plan.moves == ()


#: name → (loads, owners, cores (owners, draining), plan kwargs, check)
PLANNER_CASES = {
    "balanced_load_is_a_noop": (
        {k: 10.0 for k in range(4)}, {0: "a", 1: "a", 2: "b", 3: "b"},
        (("a", "b"), ()), {}, _balanced),
    "hotspot_moves_to_coldest_core": (
        {0: 90.0, 1: 10.0, 2: 10.0, 3: 10.0}, {k: "a" for k in range(4)},
        (("a", "b", "c"), ()), {}, _hotspot),
    "dwell_suppresses_frozen_clock": (
        {0: 60.0, 1: 30.0}, {0: "a", 1: "a"}, (("a", "b"), ()),
        {"last_moved": {0: 95.0, 1: 95.0}, "now": 100.0}, _dwell_held),
    "dwell_releases_frozen_clock": (
        {0: 60.0, 1: 30.0}, {0: "a", 1: "a"}, (("a", "b"), ()),
        {"last_moved": {0: 95.0, 1: 95.0}, "now": 105.1}, _dwell_released),
    "budget_caps_moves_and_counts_the_overflow": (
        {k: 50.0 for k in range(6)}, {k: "a" for k in range(6)},
        (("a", "b"), ()), {"budget": 1}, _budget_one),
    "budget_with_room_plans_more": (
        {k: 50.0 for k in range(6)}, {k: "a" for k in range(6)},
        (("a", "b"), ()), {"budget": 3}, _budget_three),
    "improvement_threshold_holds": (
        {0: 40.0, 1: 5.0, 2: 30.0, 3: 3.0}, {0: "a", 1: "a", 2: "b", 3: "b"},
        (("a", "b"), ()), {"improvement": 0.5}, _calm),
    "slo_urgency_halves_the_threshold": (
        {0: 40.0, 1: 5.0, 2: 30.0, 3: 3.0}, {0: "a", 1: "a", 2: "b", 3: "b"},
        (("a", "b"), ()), {"improvement": 0.5, "slo_hot": True}, _slo_hot),
    "join_absorbs_load_onto_cold_core": (
        {k: 20.0 for k in range(4)}, {0: "a", 1: "a", 2: "b", 3: "b"},
        (("a", "b", "c"), ()), {}, _join),
    "drain_empties_core_ignoring_dwell_and_threshold": (
        {0: 0.0, 1: 1.0}, {0: "b", 1: "b"}, (("a", "b"), ("b",)),
        {"last_moved": {0: 99.9, 1: 99.9}, "now": 100.0, "budget": 4},
        _drain),
    "only_source_cold_core_gives_nothing": (
        {0: 90.0, 1: 90.0, 2: 1.0}, {0: "a", 1: "ghost", 2: "b"},
        (("a", "b"), ()), {"only_source": "b"}, _only_b),
    "only_source_restricts_and_unlisted_cores_untouched": (
        {0: 90.0, 1: 90.0, 2: 1.0}, {0: "a", 1: "ghost", 2: "b"},
        (("a", "b"), ()), {"only_source": "a"}, _only_a),
    "no_move_that_overshoots_the_gap": (
        {0: 100.0}, {0: "a"}, (("a", "b"), ()), {}, _no_overshoot),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_case_equals_jax(case):
    loads, owners, (names, draining), kw, check = PLANNER_CASES[case]
    plans = {}
    for name, P in PKGS.items():
        plans[name] = _plan(P, _heat(P, loads), dict(owners),
                            _cores(P, *names, draining=draining), **kw)
    check(plans["torch"])
    assert plans["torch"].to_dict() == plans["jax"].to_dict()


def test_deterministic_under_permuted_input():
    """Permuting every input mapping leaves the port's plan unchanged,
    and it equals the JAX planner's."""
    rng = random.Random(7)
    loads = {k: (float(rng.randrange(1, 100)), float(rng.randrange(0, 4096)))
             for k in range(16)}
    owners = {k: "abc"[k % 3] for k in range(16)}
    last_moved = {3: 95.0, 7: 10.0}
    baseline = _plan(PORT, _heat(PORT, loads), owners,
                     _cores(PORT, "a", "b", "c", "d"), last_moved)
    assert baseline.to_dict() == _plan(
        JAX, _heat(JAX, loads), owners, _cores(JAX, "a", "b", "c", "d"),
        last_moved).to_dict()
    for seed in range(8):
        r = random.Random(seed)

        def shuffled(d):
            items = list(d.items())
            r.shuffle(items)
            return dict(items)

        plan = _plan(PORT, shuffled(_heat(PORT, loads)), shuffled(owners),
                     shuffled(_cores(PORT, "a", "b", "c", "d")),
                     shuffled(last_moved))
        assert plan == baseline


# --------------------------------------------------- elastic membership


def _membership(P, tmp_path) -> list:
    table = P.plane.EpochTable(str(tmp_path / "placement"),
                               counters=P.Counters("placement"))
    e0 = table.global_epoch()
    table.record_core("a", "addr-a")
    table.record_core("b", "addr-b")
    assert table.global_epoch() == e0  # membership never fences
    out = [sorted(table.cores()), table.core_state("a"),
           table.set_core_state("a", P.plane.CORE_DRAINING)]
    table.record_core("a", "addr-a2")
    out += [table.core_state("a"), table.cores()["a"]["addr"],
            table.set_core_state("nobody", P.plane.CORE_DRAINING)]
    table.remove_core("a")
    out.append(table.core_state("a"))
    return out


def test_core_membership_records_without_epoch_bumps(tmp_path):
    got = _membership(PORT, tmp_path / "torch")
    assert got == _membership(JAX, tmp_path / "jax")
    assert got == [["a", "b"], PORT.plane.CORE_ACTIVE, True,
                   PORT.plane.CORE_DRAINING, "addr-a2", False, None]


def test_draining_host_stops_claiming(tmp_path):
    host = PORT.ShardHost(str(tmp_path), 2, prefer=(0, 1), ttl_s=30.0)
    host.address = f"inproc/{host.owner_id}"
    host.poll()
    assert sorted(host.servers) == [0, 1]
    assert host.table.core_state(host.owner_id) == PORT.plane.CORE_ACTIVE
    host.table.set_core_state(host.owner_id, PORT.plane.CORE_DRAINING)
    host.poll()
    assert host.draining
    logs = [s.log for s in host.servers.values()]
    host.release_all()
    host.poll()
    assert host.servers == {}
    for log in logs:
        log.close()


# ----------------------------------------------------------- heat read


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_windowed_heat_read_is_exact(pkg):
    P = PKGS[pkg]
    P.obs.reset_registry()
    try:
        reg = P.obs.get_registry()
        for _ in range(50):
            reg.observe_windowed(P.reb.HEAT_OPS, 2.0, now=1000.0, part="0")
        reg.observe_windowed(P.reb.HEAT_OPS, 7.0, now=1000.0, part="1")
        heat = P.reb.read_local_heat([0, 1, 2], now=1000.0, registry=reg)
        assert heat[0].ops == pytest.approx(100.0 / 10.0)
        assert heat[1].ops == pytest.approx(7.0 / 10.0)
        assert heat[2].ops == 0.0
    finally:
        P.obs.reset_registry()


def test_sum_counter_snapshots_fleet_totals():
    snaps = [{"placement.rebalance.ticks": 5,
              "placement.rebalance.migrations_issued": 1},
             {"placement.rebalance.ticks": 7}, {}]
    total = PORT.obs.sum_counter_snapshots(snaps)
    assert total == JAX.obs.sum_counter_snapshots(snaps) == {
        "placement.rebalance.ticks": 12,
        "placement.rebalance.migrations_issued": 1}


# ------------------------------------------------------- daemon ticks


def _two_hosts(P, tmp_path, n=2):
    a = P.ShardHost(str(tmp_path), n, prefer=range(n), ttl_s=30.0)
    a.address = f"inproc/{a.owner_id}"
    a.poll()
    b = P.ShardHost(str(tmp_path), n, ttl_s=30.0)
    b.address = f"inproc/{b.owner_id}"
    b.poll()
    return a, b


def _rebalancer_for(P, src, tgt, heat_by_part, pc, **kw):
    eng_src = P.plane.MigrationEngine(src, counters=pc)
    eng_tgt = P.plane.MigrationEngine(tgt, counters=pc)

    def heat_reader(owners, cores, now):
        heat = {k: heat_by_part.get(k, P.reb.PartHeat()) for k in owners}
        return heat, set(cores)

    def actuate(k, target_addr):
        eng_src.migrate(
            k, target_addr,
            adopt=lambda k, addr: eng_tgt.adopt(k, src.owner_id))

    kw.setdefault("dwell_s", 10.0)
    kw.setdefault("budget", 1)
    kw.setdefault("improvement", 0.25)
    return P.reb.Rebalancer(src, eng_src, heat_reader=heat_reader,
                            actuate=actuate, counters=pc, **kw)


def _close(*hosts):
    for h in hosts:
        for s in h.servers.values():
            s.log.close()


def _tick_migrates(P, tmp_path):
    pc = P.Counters("placement")
    a, b = _two_hosts(P, tmp_path)
    reb = _rebalancer_for(P, a, b, {0: P.reb.PartHeat(ops=90.0),
                                    1: P.reb.PartHeat(ops=10.0)}, pc)
    plan = reb.tick(now=100.0)
    assert [m.k for m in plan.moves] == [0]
    assert 0 in b.servers and 0 not in a.servers
    plan2 = reb.tick(now=101.0)
    assert plan2.moves == () and reb.flap_count() == 0
    _close(a, b)
    return ([m.k for m in plan.moves], plan2.suppressed_hysteresis,
            {k: v for k, v in pc.snapshot().items()
             if k.startswith("placement.rebalance.")})


def _tick_drains(P, tmp_path):
    pc = P.Counters("placement")
    a, b = _two_hosts(P, tmp_path)
    a.table.set_core_state(a.owner_id, P.plane.CORE_DRAINING)
    a.poll()
    assert a.draining
    reb = _rebalancer_for(P, a, b, {0: P.reb.PartHeat(ops=5.0),
                                    1: P.reb.PartHeat(ops=5.0)}, pc,
                          budget=2)
    reb.tick(now=100.0)
    assert a.servers == {} and sorted(b.servers) == [0, 1]
    reb.tick(now=101.0)
    assert a.table.core_state(a.owner_id) == P.plane.CORE_DRAINED
    st = reb.status()
    assert st["draining"] and st["drained"]
    _close(b)
    return st["draining"], st["drained"], sorted(b.servers)


def _dwell_follows_peers(P, tmp_path):
    pc = P.Counters("placement")
    a, b = _two_hosts(P, tmp_path)
    hb = {0: P.reb.PartHeat(), 1: P.reb.PartHeat()}
    reb = _rebalancer_for(P, a, b, hb, pc)
    assert reb.tick(now=50.0).moves == ()
    eng_a = P.plane.MigrationEngine(a, counters=pc)
    eng_b = P.plane.MigrationEngine(b, counters=pc)
    for k in (0, 1):
        eng_a.migrate(k, b.address,
                      adopt=lambda k, addr: eng_b.adopt(k, a.owner_id))
        eng_b.migrate(k, a.address,
                      adopt=lambda k, addr: eng_a.adopt(k, b.owner_id))
    hb[0] = P.reb.PartHeat(ops=60.0)
    hb[1] = P.reb.PartHeat(ops=30.0)
    plan = reb.tick(now=51.0)
    assert plan.moves == () and plan.suppressed_hysteresis == 2
    moved = [m.k for m in reb.tick(now=70.0).moves]
    assert moved == [0]
    _close(a, b)
    return plan.suppressed_hysteresis, moved


@pytest.mark.parametrize("scenario", [_tick_migrates, _tick_drains,
                                      _dwell_follows_peers],
                         ids=["tick_migrates_hot_partition_for_real",
                              "tick_drains_and_marks_drained",
                              "dwell_clock_follows_peer_epoch_bumps"])
def test_rebalancer_tick_equals_jax(tmp_path, scenario):
    assert scenario(PORT, tmp_path / "torch") == \
        scenario(JAX, tmp_path / "jax")
