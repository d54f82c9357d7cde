"""Streaming doctor: the bundle triage rules, evaluated live.

JAX counterpart: ``fluidframework_tpu/obs/health.py``; the port's copy,
imports rebased to this package. The rules come from the port's own
copy, ``obs/doctor_rules.py``, imported as a module of this package
(the JAX engine reaches ``tools/doctor_rules.py`` through ``sys.path``).

``tools/doctor.py`` answers "what went wrong" from a bundle AFTER an
incident. This engine answers "is this core healthy RIGHT NOW" by
running the SAME rule code (``obs/doctor_rules.py`` — shared
verbatim, never re-derived) continuously against the live process:
the registry's own Prometheus scrape, the journal tail, the placement
table, the SLO engine's status rows, the boot surface, and the canary
prober's door verdicts (obs/probe.py). A gray failure — a component
that drops no tenant request but fails its own doors (Huang et al.,
HotOS'17) — surfaces here minutes before a user hits it, and the
rolling-upgrade loop's ``Fleet.wait_healthy`` gate keys on the verdict.

Per-component state machine, SloEngine-shaped:

- ``ok`` (0) → ``degraded`` (1) on the first tick a component's rules
  return anomalies — one bad tick is a fact worth a gauge, not yet an
  incident;
- ``degraded`` → ``critical`` (2) after ``critical_ticks`` consecutive
  anomalous ticks, or immediately on a HARD signal (a canary door past
  ``probe_fail_critical`` consecutive failures, an unreachable host
  group);
- transitions set ``health.engine.state{component=...}`` gauges and
  journal a ``health.state`` entry; entering ``critical`` arms a
  flight-recorder
  dump first and links the transition to it (the SLO engine's
  evidence-chain pattern).

``evaluate(now)`` is callable under a frozen clock for tests; the
ticker thread drives it in production. All sources are injected
callables returning bundle-shaped artifacts, so the offline/live
equivalence test can feed one fixture through BOTH consumers.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from . import doctor_rules as rules
from .flight import get_recorder
from ..utils.affinity import ticker_thread
from .journal import get_journal, merge_entries
from .metrics import get_registry

STATE_OK = 0
STATE_DEGRADED = 1
STATE_CRITICAL = 2
_STATE_NAMES = {STATE_OK: "ok", STATE_DEGRADED: "degraded",
                STATE_CRITICAL: "critical"}


class HealthEngine:
    """Continuous triage over injected live sources (see module doc).

    Every source is optional — a component with no source contributes
    no rules (an in-proc test fleet without a boot surface just has no
    ``boot`` component). Sources return the same artifact shapes the
    doctor reads out of a bundle:

    ``scrape_fn``     () -> Prometheus text (the registry's scrape)
    ``journal_fn``    () -> journal entry list (the live tail)
    ``placement_fn``  () -> admin_placement-shaped dict (parts/cores)
    ``cores_fn``      () -> owner -> capture row (``error`` key read;
                      live: the prober's peer-reachability rows)
    ``slo_fn``        () -> {"slos": [rows]} (the SLO engine status)
    ``boot_fn``       () -> admin_boot_status-shaped dict
    ``lint_fn``       () -> fluidlint --json dict (offline fixtures)
    ``probe_fn``      () -> the prober's status() dict
    ``self_row_fn``   () -> this core's manifest-shaped row
    """

    def __init__(self, core: str = "",
                 scrape_fn: Optional[Callable] = None,
                 journal_fn: Optional[Callable] = None,
                 placement_fn: Optional[Callable] = None,
                 cores_fn: Optional[Callable] = None,
                 slo_fn: Optional[Callable] = None,
                 boot_fn: Optional[Callable] = None,
                 lint_fn: Optional[Callable] = None,
                 probe_fn: Optional[Callable] = None,
                 self_row_fn: Optional[Callable] = None,
                 registry=None, journal=None, recorder=None,
                 tick_s: float = 1.0, critical_ticks: int = 3,
                 probe_fail_critical: int = 3):
        self.core = core
        self.tick_s = tick_s
        self.critical_ticks = max(1, int(critical_ticks))
        self.probe_fail_critical = max(1, int(probe_fail_critical))
        self._scrape_fn = scrape_fn
        self._journal_fn = journal_fn
        self._placement_fn = placement_fn
        self._cores_fn = cores_fn
        self._slo_fn = slo_fn
        self._boot_fn = boot_fn
        self._lint_fn = lint_fn
        self._probe_fn = probe_fn
        self._self_row_fn = self_row_fn
        self._reg = registry or get_registry()
        self.journal = journal if journal is not None else get_journal()
        self._recorder = recorder
        self._state: dict = {}
        self._streak: dict = {}
        self._reasons: dict = {}
        self._probes: Optional[dict] = None
        self.slo_burn: list = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- rules

    def _collect(self) -> tuple:
        """One pass over every source → ({component: [reasons]},
        {component: hard_critical}). The rule calls are the doctor's,
        in the doctor's per-artifact grouping."""
        comp: dict = {}
        hard: dict = {}

        if self._lint_fn is not None:
            comp["build"] = rules.lint_anomalies(self._lint_fn())

        if self._scrape_fn is not None:
            comp["scrape"] = rules.scrape_anomalies(
                self.core, self._scrape_fn() or "")

        if self._journal_fn is not None:
            tail = merge_entries([list(self._journal_fn() or [])])
            row = (self._self_row_fn() or {}) if self._self_row_fn \
                else {}
            r = rules.journal_disarmed_anomalies(self.core, row, tail)
            r += rules.suppression_storm_anomalies(self.core, tail)
            r += rules.epoch_regression_anomalies(tail)
            r += rules.fence_without_commit_anomalies(tail)
            r += [rules.migration_fail_anomaly(e) for e in tail
                  if e.get("kind") == "migration.fail"]
            comp["journal"] = r
            # a regressed epoch is split-brain evidence, not a blip
            hard["journal"] = any("epoch regressed" in a for a in r)

        if self._boot_fn is not None:
            comp["boot"] = rules.boot_anomalies(
                self.core, self._boot_fn())

        if self._placement_fn is not None or self._cores_fn is not None:
            rows = dict(self._cores_fn() or {}) if self._cores_fn \
                else {}
            r = []
            for owner in sorted(rows):
                r += rules.capture_error_anomalies(owner, rows[owner])
            placement = self._placement_fn() if self._placement_fn \
                else None
            r += rules.placement_anomalies(placement, rows)
            comp["placement"] = r
            hard["placement"] = any("unreachable" in a for a in r)

        if self._slo_fn is not None:
            self.slo_burn = rules.slo_burn_rows(
                self.core, self._slo_fn() or {})
            comp["slo"] = [
                f"slo {r['slo']} {r['state']}: p99 {r['p99_ms']}ms / "
                f"budget {r['budget_ms']}ms (burn {r['burn']}/"
                f"{r['burn_ticks']})" for r in self.slo_burn]

        if self._probe_fn is not None:
            status = self._probe_fn() or {}
            self._probes = status
            r = []
            hard_probe = False
            for door, d in sorted((status.get("doors") or {}).items()):
                n = d.get("consec_failures", 0)
                if n:
                    r.append(
                        f"canary probe {door} failing ({n} "
                        f"consecutive): {d.get('last_error')}")
                    if n >= self.probe_fail_critical:
                        hard_probe = True
            comp["probe"] = r
            hard["probe"] = hard_probe

        return comp, hard

    # ----------------------------------------------------------- ticking

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation tick; returns :meth:`status`. ``now`` is
        unused by the rules (they are clock-free over the artifacts)
        but kept for ticker-template symmetry with the SLO engine."""
        comp, hard = self._collect()
        for name in comp:
            reasons = comp[name]
            prev = self._state.get(name, STATE_OK)
            if reasons:
                self._streak[name] = self._streak.get(name, 0) + 1
                state = (STATE_CRITICAL
                         if (hard.get(name)
                             or self._streak[name] >= self.critical_ticks)
                         else STATE_DEGRADED)
            else:
                self._streak[name] = 0
                state = STATE_OK
            self._reasons[name] = reasons
            if state == prev and name in self._state:
                continue
            self._state[name] = state
            self._reg.set_gauge("health.engine.state", state,
                                component=name)
            if state == prev:
                continue  # first tick of a fresh component, still ok
            dump_id = None
            if state == STATE_CRITICAL:
                # evidence first, verdict second: the ring holds the
                # frames that led here — dump, journal the dump, then
                # link the transition to it (the SLO engine's pattern)
                try:
                    rec = self._recorder or get_recorder()
                    path = rec.dump(
                        "health_critical", component=name,
                        reasons=reasons[:3])
                    dump_id = self.journal.emit(
                        "flight.dump", reason="health_critical",
                        path=path, component=name)
                except Exception:
                    pass
            self.journal.emit(
                "health.state", cause=dump_id, component=name,
                state=_STATE_NAMES[state], prev=_STATE_NAMES[prev],
                reason=reasons[0] if reasons else None,
                n_reasons=len(reasons))
        return self.status()

    def anomalies(self) -> list:
        """Every rule-derived anomaly string, all components, in the
        doctor's grouping order (SLO burn stays separate, exactly as
        ``diagnose`` keeps ``slo_burn`` out of ``anomalies``)."""
        out = []
        for name in ("build", "scrape", "journal", "boot",
                     "placement", "probe"):
            out.extend(self._reasons.get(name, []))
        return out

    def verdict(self) -> str:
        worst = max(self._state.values(), default=STATE_OK)
        return _STATE_NAMES[worst]

    def status(self) -> dict:
        """The ``admin_health`` payload: one verdict, per-component
        states with their reasons, and the prober's door stats."""
        return {
            "core": self.core,
            "verdict": self.verdict(),
            "components": {
                name: {"state": _STATE_NAMES[state],
                       "streak": self._streak.get(name, 0),
                       "reasons": list(self._reasons.get(name, []))}
                for name, state in sorted(self._state.items())},
            "slo_burn": list(self.slo_burn),
            "probes": self._probes,
        }

    # ------------------------------------------------------------ thread

    def start(self) -> "HealthEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fluid-health-ticker",
                daemon=True)
            self._thread.start()
        return self

    @ticker_thread("health")
    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.evaluate()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
