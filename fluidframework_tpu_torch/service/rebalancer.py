"""Self-driving placement: the load→decision→migration loop.

JAX counterpart: ``fluidframework_tpu/service/rebalancer.py``; the port's
copy of the placement rebalancer (planner, dwell, budget, drain), imports
rebased to this package.

Ref: lambdas-driver/kafka-service/partitionManager.ts (the reference
scales by rebalancing Kafka partitions across consumer-group members);
here the same loop over our strictly richer ingredients — the SLO
engine *sees* latency burn, the migration engine *moves* a partition
with a ~3.4 ms blip, and this module decides WHEN and WHERE:

- **heat signal** — every admitted submit records per-partition ops and
  staged bytes into the windowed metrics registry
  (``placement.heat.*``, exact per-bucket sums — no reservoir
  sampling loss). :func:`read_local_heat` folds the last
  ``HEAT_WINDOW_S`` seconds into per-partition rates;
  :func:`collect_fleet_heat` fans the ``admin_core_heat`` RPC across
  the epoch table's membership so every core prices the whole fleet.
- **planner** — :func:`plan_rebalance`, a pure function: heat-aware
  greedy bin-packing (move the part that best halves the hottest→
  coldest gap) with three hysteresis gates so a borderline doc never
  flaps: per-partition **dwell** time, per-tick migration **budget**,
  and an **improvement threshold** (skewed-enough-to-bother, halved
  while the SLO engine is shedding — latency burn buys urgency).
  Deterministic under permuted input: every choice is a total-order
  ``min``/``max`` with explicit tie keys.
- **daemon** — :class:`Rebalancer`, an SLO-engine-shaped ticker thread
  per core. Each core plans only moves SOURCED from itself
  (``only_source``): decisions need no global lock because a migration
  is only actuated by the partition's owner, one at a time, through
  the full seal→fence→checkpoint→lease-transfer→adopt protocol.
- **elastic membership** — a joining core registers in the epoch
  table's ``cores`` section maximally cold and the planner drains load
  onto it within budget; ``admin placement drain CORE`` marks it
  draining and every partition is migrated away (dwell/threshold
  exempt — evacuation is not an optimization), then the core marks
  itself ``drained`` and can decommission.

Unreachable peers (dead ``admin_core_heat`` dial) are excluded from
the tick's membership view, so a crashed core is never chosen as a
migration target — the heat scrape doubles as a liveness probe.
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from ..obs import get_journal, get_registry
from ..utils.affinity import blocking, ticker_thread
from .placement_plane import (
    CORE_ACTIVE,
    CORE_DRAINED,
    CORE_DRAINING,
    admin_rpc,
    placement_counters,
)

#: locked heat family (fluidlint LOCKED_FAMILIES): per-partition windowed
#: series, labeled ``part=<k>``
HEAT_OPS = "placement.heat.ops"
HEAT_BYTES = "placement.heat.bytes"

#: how far back a heat read looks; also the rate denominator
HEAT_WINDOW_S = 10.0


@dataclass(frozen=True)
class PartHeat:
    """Windowed per-partition load: ops/s plus staged bytes/s."""

    ops: float = 0.0
    bytes: float = 0.0

    @property
    def load(self) -> float:
        # one scalar for packing: an op costs ~1 KiB of staging in the
        # fleet benches, so bytes are discounted to op-equivalents
        return self.ops + self.bytes / 1024.0


_ZERO = PartHeat()


@dataclass(frozen=True)
class Move:
    k: int
    src: str
    dst: str
    dst_addr: str
    load: float


@dataclass(frozen=True)
class Plan:
    moves: tuple = ()
    suppressed_hysteresis: int = 0
    suppressed_budget: int = 0
    spread_before: float = 0.0
    spread_after: float = 0.0

    def to_dict(self) -> dict:
        return {
            "moves": [{"k": m.k, "src": m.src, "dst": m.dst,
                       "load": round(m.load, 3)} for m in self.moves],
            "suppressed_hysteresis": self.suppressed_hysteresis,
            "suppressed_budget": self.suppressed_budget,
            "spread_before": round(self.spread_before, 3),
            "spread_after": round(self.spread_after, 3),
        }


def plan_rebalance(heat: dict, owners: dict, cores: dict,
                   last_moved: dict, now: float, *,
                   dwell_s: float = 10.0, budget: int = 2,
                   improvement: float = 0.25, slo_hot: bool = False,
                   only_source: Optional[str] = None) -> Plan:
    """Pure planner: which partitions move where, this tick.

    ``heat`` is ``{k: PartHeat}``, ``owners`` is ``{k: owner}`` (the
    epoch table's parts), ``cores`` is the membership view ``{owner:
    {"addr", "state"}}`` ALREADY filtered to reachable members,
    ``last_moved`` is ``{k: monotonic_t}``. Deterministic: permuting
    dict insertion order cannot change the plan (every pick is a
    total-order min/max).

    Draining sources evacuate first and are exempt from dwell and the
    improvement threshold (but not the budget). Active sources move a
    partition only when the hottest→coldest gap exceeds
    ``improvement × mean`` (halved under ``slo_hot``), the candidate
    strictly narrows that gap, and its dwell clock has expired.

    Locality tiebreak (multi-host fleets): cores rows may carry a
    ``host`` group id; among equally-loaded targets the planner prefers
    one in the SOURCE's host group, so a cross-host hop (and its
    log-shipping handoff) is paid only when load demands it. Single-host
    fleets have no ``host`` keys — every target ties on locality and
    the historical pick order is unchanged.
    """
    hostmap = {o: row.get("host") for o, row in cores.items()}
    active = sorted(o for o, row in cores.items()
                    if row.get("state", CORE_ACTIVE) == CORE_ACTIVE)
    draining = sorted(o for o, row in cores.items()
                      if row.get("state") == CORE_DRAINING)
    loads = {o: 0.0 for o in cores}
    placement = {}
    for k, o in owners.items():
        if o in loads:
            placement[int(k)] = o
            loads[o] += heat.get(int(k), _ZERO).load
    thr = improvement * (0.5 if slo_hot else 1.0)

    def spread() -> float:
        vals = [loads[o] for o in active]
        return max(vals) - min(vals) if len(vals) >= 2 else 0.0

    def pick():
        """One best move given the working placement, or ``(None,
        n_dwell_blocked)`` when hysteresis is the only thing standing
        between the planner and a move."""
        if only_source is not None:
            srcs = [only_source] if only_source in cores else []
        else:
            srcs = draining + sorted(active,
                                     key=lambda o: (-loads[o], o))
        for src in srcs:
            state = cores[src].get("state", CORE_ACTIVE)
            parts = sorted(k for k, o in placement.items() if o == src)
            targets = [o for o in active if o != src]
            if not targets:
                continue
            dst = min(targets, key=lambda o: (
                loads[o],
                0 if hostmap.get(o) == hostmap.get(src) else 1,
                o))
            if state in (CORE_DRAINING, CORE_DRAINED):
                if not parts:
                    continue
                # evacuation: hottest part first (ties → lowest k), no
                # dwell/threshold gate — the operator already decided
                k = max(parts, key=lambda k: (heat.get(k, _ZERO).load,
                                              -k))
                return (Move(k, src, dst, cores[dst]["addr"],
                             heat.get(k, _ZERO).load), 0)
            if state != CORE_ACTIVE:
                continue
            diff = loads[src] - loads[dst]
            mean = sum(loads[o] for o in active) / len(active)
            if diff <= 0 or diff <= thr * mean:
                continue
            eligible, blocked = [], 0
            for k in parts:
                ld = heat.get(k, _ZERO).load
                if ld <= 0.0:
                    continue
                if now - last_moved.get(k, float("-inf")) < dwell_s:
                    blocked += 1
                    continue
                nd = abs(diff - 2.0 * ld)
                if nd < diff:  # strictly narrows the gap, never flips it
                    eligible.append((nd, k, ld))
            if not eligible:
                if blocked:
                    return (None, blocked)
                continue
            nd, k, ld = min(eligible)
            return (Move(k, src, dst, cores[dst]["addr"], ld), 0)
        return (None, 0)

    spread_before = spread()
    moves: list = []
    suppressed_hysteresis = 0
    suppressed_budget = 0
    while len(moves) < max(0, budget):
        mv, blocked = pick()
        suppressed_hysteresis += blocked
        if mv is None:
            break
        moves.append(mv)
        placement[mv.k] = mv.dst
        loads[mv.src] -= mv.load
        loads[mv.dst] += mv.load
    if len(moves) == budget and budget > 0:
        # one probe past the budget: a move the planner WOULD make but
        # for the budget gate is the flap-control signal operators watch
        mv, _ = pick()
        if mv is not None:
            suppressed_budget += 1
    return Plan(moves=tuple(moves),
                suppressed_hysteresis=suppressed_hysteresis,
                suppressed_budget=suppressed_budget,
                spread_before=spread_before, spread_after=spread())


# ------------------------------------------------------------------ heat

def read_local_heat(parts: Iterable[int], now: Optional[float] = None,
                    registry=None) -> dict:
    """Fold the registry's windowed ``placement.heat.*`` series into
    ``{k: PartHeat}`` rates for this process's partitions. Cold owned
    partitions appear with zero heat — a draining core must evacuate
    idle partitions too, so absence is not an option."""
    reg = registry if registry is not None else get_registry()
    ops = reg.window_sums_by(HEAT_OPS, "part", now=now,
                             window_s=HEAT_WINDOW_S)
    byts = reg.window_sums_by(HEAT_BYTES, "part", now=now,
                              window_s=HEAT_WINDOW_S)
    out = {}
    for k in parts:
        out[int(k)] = PartHeat(
            ops=ops.get(str(k), 0.0) / HEAT_WINDOW_S,
            bytes=byts.get(str(k), 0.0) / HEAT_WINDOW_S)
    return out


@blocking("fleet-wide heat fan-out: concurrent per-peer dials joined "
          "on ONE shared deadline — runs on the rebalancer ticker")
def collect_fleet_heat(table_rec: dict, self_owner: str,
                       self_heat: dict, secret: Optional[str] = None,
                       timeout: float = 5.0) -> tuple:
    """Fan ``admin_core_heat`` across the membership and merge with the
    local read. Returns ``(heat, reachable)``; a peer whose dial fails
    is left OUT of ``reachable``, so the planner never targets a core
    that cannot answer a one-frame RPC.

    Dials run CONCURRENTLY (one daemon thread each) against a shared
    deadline: one wedged peer costs the scrape ``timeout`` seconds
    total, not ``timeout × peers`` — with 16 cores a single dead host
    group used to stall the tick for over a minute. A dial still
    in flight at the deadline is counted
    (``placement.heat.scrape_timeouts``) and its owner treated exactly
    like a refused dial: out of ``reachable``, never a target."""
    heat = dict(self_heat)
    reachable = {self_owner}
    dials = []
    for owner, row in sorted(table_rec.get("cores", {}).items()):
        if owner == self_owner:
            continue
        if row.get("state") == CORE_DRAINED:
            reachable.add(owner)  # owns nothing; no dial needed
            continue
        dials.append((owner, row))
    if not dials:
        return heat, reachable
    replies: dict = {}

    def dial(owner: str, row: dict) -> None:
        host_s, _, port_s = row.get("addr", "").rpartition(":")
        frame = {"t": "admin_core_heat"}
        if secret:
            frame["secret"] = secret
        try:
            replies[owner] = admin_rpc(host_s or "127.0.0.1",
                                       int(port_s), frame,
                                       timeout=timeout)
        except (OSError, ValueError, RuntimeError):
            pass  # unreachable: absent from replies

    threads = [threading.Thread(target=dial, args=d, daemon=True,
                                name=f"heat-scrape-{d[0]}")
               for d in dials]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    timeouts = 0
    for (owner, _row), t in zip(dials, threads):
        if t.is_alive():
            timeouts += 1  # abandoned: the daemon thread dies unheard
            continue
        reply = replies.get(owner)
        if reply is None:
            continue
        reachable.add(owner)
        for ks, h in reply.get("parts", {}).items():
            heat[int(ks)] = PartHeat(ops=float(h.get("ops", 0.0)),
                                     bytes=float(h.get("bytes", 0.0)))
    if timeouts:
        placement_counters().inc("placement.heat.scrape_timeouts",
                                 timeouts)
    return heat, reachable


@blocking("per-peer admin_rpc dial with a multi-second timeout — fleet fan-out must run on a ticker or an executor, never the loop")
def peer_tier_snapshots(table_rec: dict, self_owner: str, tier: str,
                        secret: Optional[str] = None,
                        timeout: float = 5.0) -> list:
    """Fetch ``tier_snapshot(tier)`` from every reachable peer core
    (``admin_tier_snapshot``) — the fleet-total half of
    ``obs.sum_counter_snapshots``. Unreachable peers are skipped, not
    fatal: a fleet sum is an observability read, not a correctness
    input."""
    snaps = []
    for owner, row in sorted(table_rec.get("cores", {}).items()):
        if owner == self_owner:
            continue
        host_s, _, port_s = row.get("addr", "").rpartition(":")
        frame = {"t": "admin_tier_snapshot", "tier": tier}
        if secret:
            frame["secret"] = secret
        try:
            reply = admin_rpc(host_s or "127.0.0.1", int(port_s),
                              frame, timeout=timeout)
        except (OSError, ValueError, RuntimeError):
            continue
        snaps.append(reply.get("counters", {}))
    return snaps


# ---------------------------------------------------------------- daemon

class Rebalancer:
    """Per-core rebalancing daemon (SLO-engine-shaped ticker thread).

    Each tick: refresh the dwell clock from epoch-table bumps, gather
    fleet heat, plan moves sourced from THIS core only, actuate them
    one at a time through ``MigrationEngine.migrate``, and — when this
    core is draining and owns nothing — mark it ``drained``.

    ``heat_reader(owners, cores, now) -> (heat, reachable)`` and
    ``actuate(k, target_addr)`` are injectable seams: the front end
    routes actuation through a loopback ``admin_migrate_part`` RPC so
    the migration runs on the event loop (the single-threaded
    no-two-writers guarantee), while chaos/tests drive in-proc engines
    and frozen clocks. :meth:`tick` takes an explicit ``now`` for
    deterministic hysteresis tests.
    """

    def __init__(self, host, engine, *, slo_engine=None,
                 tick_s: float = 0.5, dwell_s: float = 10.0,
                 budget: int = 2, improvement: float = 0.25,
                 cooldown_s: Optional[float] = None,
                 heat_reader: Optional[Callable] = None,
                 actuate: Optional[Callable] = None,
                 secret: Optional[str] = None, registry=None,
                 counters=None, journal=None):
        self.host = host
        self.engine = engine
        self.slo_engine = slo_engine
        self.journal = journal if journal is not None else get_journal()
        # injected actuate seams predate the journal-cause thread; only
        # pass cause= to ones that declare it (or **kwargs)
        self._actuate_cause_ok = False
        if actuate is not None:
            try:
                params = inspect.signature(actuate).parameters
                self._actuate_cause_ok = (
                    "cause" in params
                    or any(p.kind is p.VAR_KEYWORD
                           for p in params.values()))
            except (TypeError, ValueError):
                pass
        self.tick_s = float(tick_s)
        self.dwell_s = float(dwell_s)
        self.cooldown_s = (float(cooldown_s) if cooldown_s is not None
                           else self.dwell_s)
        self.budget = int(budget)
        self.improvement = float(improvement)
        self._heat_reader = heat_reader
        self._actuate_fn = actuate
        self._secret = secret
        self._registry = registry
        self.counters = (counters if counters is not None
                         else placement_counters())
        self.last_moved: dict = {}
        self._last_issued: Optional[float] = None
        self._part_epochs: dict = {}
        self.history: deque = deque(maxlen=256)
        self.last_plan: Optional[Plan] = None
        self.last_error: Optional[str] = None
        self._drained_marked = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- loop

    def start(self) -> "Rebalancer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="rebalancer", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    @ticker_thread("rebalancer")
    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception as e:  # keep ticking; surface via status()
                self.last_error = f"{type(e).__name__}: {e}"

    # ------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> Plan:
        now = time.monotonic() if now is None else now
        c = self.counters
        c.inc("placement.rebalance.ticks")
        table = self.host.table
        rec = table.read()
        owners = {int(k): p["owner"]
                  for k, p in rec.get("parts", {}).items()}
        # dwell clock: an epoch bump on k means SOMEONE moved/claimed it
        # (covers moves issued by peer cores — the table is the shared
        # clock, no cross-core gossip needed). First sighting is a
        # baseline, not a move.
        for ks, p in rec.get("parts", {}).items():
            k, e = int(ks), p["epoch"]
            prev = self._part_epochs.get(k)
            if prev is not None and e != prev:
                self.last_moved[k] = now
            self._part_epochs[k] = e
        # source cool-down: the windowed heat signal LAGS a migration —
        # the target's window starts empty, so for up to a window this
        # core still looks like the hot one. Re-planning inside that
        # lag mass-drains the source and then ping-pongs the whole set
        # back. After issuing a move, hold off further balance planning
        # until the signal has had a cool-down to re-converge. Draining
        # is exempt: evacuation ignores heat comparisons entirely.
        if (self._last_issued is not None and self.cooldown_s > 0
                and now - self._last_issued < self.cooldown_s
                and not getattr(self.host, "draining", False)):
            # keep last_plan: the admin CLI should show the real plan,
            # not the cool-down's deliberate no-op
            return Plan(moves=(), suppressed_hysteresis=0,
                        suppressed_budget=0,
                        spread_before=0.0, spread_after=0.0)
        if self._heat_reader is not None:
            heat, reachable = self._heat_reader(
                owners, rec.get("cores", {}), now)
        else:
            self_heat = read_local_heat(
                list(self.host.servers), now=now,
                registry=self._registry)
            heat, reachable = collect_fleet_heat(
                rec, self.host.owner_id, self_heat,
                secret=self._secret)
        cores = {o: row for o, row in rec.get("cores", {}).items()
                 if o in reachable}
        slo_hot = bool(self.slo_engine is not None
                       and self.slo_engine.shed_signal)
        plan = plan_rebalance(
            heat, owners, cores, self.last_moved, now,
            dwell_s=self.dwell_s, budget=self.budget,
            improvement=self.improvement, slo_hot=slo_hot,
            only_source=self.host.owner_id)
        self.last_plan = plan
        jr = self.journal
        plan_id = None
        if plan.moves or plan.suppressed_hysteresis \
                or plan.suppressed_budget:
            # decision-time heat snapshot: the journal answers "what did
            # the planner SEE", which the live metrics can't once the
            # window rolls (bounded: hottest 16 partitions)
            hot = sorted(heat.items(), key=lambda kv: -kv[1].load)[:16]
            snapshot = {str(k): round(h.load, 2) for k, h in hot}
            if plan.moves:
                plan_id = jr.emit(
                    "rebalance.plan",
                    moves=[{"k": m.k, "src": m.src, "dst": m.dst,
                            "load": round(m.load, 3)}
                           for m in plan.moves],
                    spread_before=round(plan.spread_before, 3),
                    spread_after=round(plan.spread_after, 3),
                    slo_hot=slo_hot, heat=snapshot)
            if plan.suppressed_hysteresis or plan.suppressed_budget:
                reasons = []
                if plan.suppressed_hysteresis:
                    reasons.append("hysteresis")
                if plan.suppressed_budget:
                    reasons.append("budget")
                jr.emit("rebalance.suppressed",
                        reason="+".join(reasons),
                        hysteresis=plan.suppressed_hysteresis,
                        budget=plan.suppressed_budget,
                        slo_hot=slo_hot, heat=snapshot)
        if plan.moves:
            c.inc("placement.rebalance.plans")
        if plan.suppressed_hysteresis:
            c.inc("placement.rebalance.suppressed_hysteresis",
                  plan.suppressed_hysteresis)
        if plan.suppressed_budget:
            c.inc("placement.rebalance.suppressed_budget",
                  plan.suppressed_budget)
        for mv in plan.moves:
            act_id = jr.emit("rebalance.actuate", cause=plan_id,
                             part=mv.k, src=mv.src, dst=mv.dst,
                             load=round(mv.load, 3))
            try:
                if self._actuate_fn is not None:
                    if self._actuate_cause_ok:
                        self._actuate_fn(mv.k, mv.dst_addr, cause=act_id)
                    else:
                        self._actuate_fn(mv.k, mv.dst_addr)
                else:
                    self.engine.migrate(mv.k, mv.dst_addr, cause=act_id)
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                break
            self.last_moved[mv.k] = now
            self._last_issued = now
            self.history.append((now, mv.k, mv.src, mv.dst))
            c.inc("placement.rebalance.migrations_issued")
        if (getattr(self.host, "draining", False)
                and not self.host.servers and not self._drained_marked):
            if table.core_state(self.host.owner_id) == CORE_DRAINING:
                table.set_core_state(self.host.owner_id, CORE_DRAINED)
            self._drained_marked = True
        return plan

    # ----------------------------------------------------------- status

    def flap_count(self) -> int:
        """Re-migrations of the same partition inside its dwell window —
        the bench's flap-free acceptance gate reads this."""
        last: dict = {}
        flaps = 0
        for (t, k, _src, _dst) in self.history:
            if k in last and t - last[k] < self.dwell_s:
                flaps += 1
            last[k] = t
        return flaps

    def status(self) -> dict:
        return {
            "armed": True,
            "owner": self.host.owner_id,
            "draining": bool(getattr(self.host, "draining", False)),
            "drained": self._drained_marked,
            "tick_s": self.tick_s,
            "dwell_s": self.dwell_s,
            "cooldown_s": self.cooldown_s,
            "budget": self.budget,
            "improvement": self.improvement,
            "flaps": self.flap_count(),
            "last_error": self.last_error,
            "last_plan": (self.last_plan.to_dict()
                          if self.last_plan is not None else None),
            "history": [{"t": round(t, 3), "k": k, "src": s, "dst": d}
                        for (t, k, s, d) in list(self.history)[-16:]],
        }
