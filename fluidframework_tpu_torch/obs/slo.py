"""Windowed SLO engine: declarative p99 budgets over the hop taxonomy.

JAX counterpart: ``fluidframework_tpu/obs/slo.py``; the port's copy,
imports rebased to this package (the port's own registry, flight
recorder and journal).

The registry keeps windowed per-hop observations; this module reads
them. An :class:`SloSpec` names a hop pair (and optionally a tenant)
and a p99 budget in milliseconds; the :class:`SloEngine` evaluates
every spec against the registry's windowed series
(``obs.hop.window_ms``) on a ticker thread — or via direct
``evaluate(now)`` calls under a frozen clock in tests — and drives:

- ``obs.slo.state{slo=...}`` gauges (0=ok, 1=warn, 2=violated): a spec
  goes ``warn`` the first over-budget tick and ``violated`` after
  ``burn_ticks`` consecutive over-budget ticks (one hot sample is
  noise; a sustained burn is an incident);
- ``obs.slo.violations{slo=...}`` counting ok→violated transitions,
  with a flight-recorder dump on each (the ring holds the frames that
  led up to the burn);
- ``shed_signal`` / ``violated_pairs``, read lock-free by the front
  end's admission controller to arm SLO-burn shedding (see
  service/admission.py). The useful pair under ingress overload is
  ``submit_to_admit``: admit→deli happens inside one event-loop
  iteration and stays flat, while the submit→admit leg carries the
  kernel/loop queueing that overload actually inflates.

Spec string form (CLI ``--slo``)::

    name=pair:budget_ms[:window_s[:burn_ticks]]
    ingest=submit_to_admit:25:5:2
    tenant scoping: name=pair@tenant:budget_ms[...]
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .flight import get_recorder
from ..utils.affinity import ticker_thread
from .journal import get_journal
from .metrics import get_registry

STATE_OK = 0
STATE_WARN = 1
STATE_VIOLATED = 2
_STATE_NAMES = {STATE_OK: "ok", STATE_WARN: "warn",
                STATE_VIOLATED: "violated"}

#: The windowed twin of ``obs.hop.ms`` the engine evaluates against.
WINDOWED_HOP_METRIC = "obs.hop.window_ms"


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective: pair (± tenant) → p99 budget."""

    name: str
    pair: str
    p99_budget_ms: float
    tenant: Optional[str] = None
    #: evaluation window in seconds (clamped to the registry ring span)
    window_s: float = 10.0
    #: consecutive over-budget ticks before ``violated``
    burn_ticks: int = 2
    #: below this many windowed samples the spec reads ok — a single
    #: hot sample in an idle window is noise, not an incident
    min_count: int = 8


def parse_slo_spec(text: str) -> SloSpec:
    """``name=pair[@tenant]:budget_ms[:window_s[:burn_ticks]]`` → spec."""
    try:
        name, rest = text.split("=", 1)
        parts = rest.split(":")
        pair, tenant = parts[0], None
        if "@" in pair:
            pair, tenant = pair.split("@", 1)
        budget = float(parts[1])
        window_s = float(parts[2]) if len(parts) > 2 else 10.0
        burn = int(parts[3]) if len(parts) > 3 else 2
    except (ValueError, IndexError):
        raise ValueError(
            f"bad --slo spec {text!r} "
            "(want name=pair[@tenant]:budget_ms[:window_s[:burn_ticks]])")
    return SloSpec(name=name, pair=pair, p99_budget_ms=budget,
                   tenant=tenant, window_s=window_s, burn_ticks=burn)


class SloEngine:
    """Evaluates specs against the windowed registry; see module doc.

    ``evaluate`` runs on the ticker thread (or a test caller); the
    front end's event loop only ever reads ``shed_signal`` and
    ``violated_pairs``, both swapped atomically."""

    def __init__(self, specs, registry=None, tick_s: float = 0.5,
                 recorder=None, journal=None):
        self.specs = list(specs)
        self.tick_s = tick_s
        self._reg = registry or get_registry()
        self._recorder = recorder
        self.journal = journal if journal is not None else get_journal()
        self._burn = {s.name: 0 for s in self.specs}
        self._state = {s.name: STATE_OK for s in self.specs}
        self._last: dict[str, tuple[int, float]] = {}
        self.violated_pairs: frozenset = frozenset()
        self.shed_signal = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for s in self.specs:
            self._reg.set_gauge("obs.slo.state", STATE_OK, slo=s.name)

    # --------------------------------------------------------------- ticking

    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """One evaluation tick; returns :meth:`status`.

        ``now`` must be on the same monotonic clock the windowed
        observations were stamped with (tests inject both)."""
        violated = set()
        for s in self.specs:
            labels = {"pair": s.pair}
            if s.tenant is not None:
                labels["tenant"] = s.tenant
            count, q = self._reg.window_stats(
                WINDOWED_HOP_METRIC, now=now, window_s=s.window_s,
                **labels)
            p99 = q.get(0.99, 0.0)
            self._last[s.name] = (count, p99)
            over = count >= s.min_count and p99 > s.p99_budget_ms
            prev = self._state[s.name]
            if over:
                self._burn[s.name] += 1
                state = (STATE_VIOLATED
                         if self._burn[s.name] >= s.burn_ticks
                         else STATE_WARN)
            else:
                self._burn[s.name] = 0
                state = STATE_OK
            dump_id = None
            if state == STATE_VIOLATED:
                violated.add(s.pair)
                if prev != STATE_VIOLATED:
                    self._reg.inc("obs.slo.violations", slo=s.name)
                    try:
                        rec = self._recorder or get_recorder()
                        path = rec.dump(
                            "slo_violation", slo=s.name, pair=s.pair,
                            tenant=s.tenant, p99_ms=round(p99, 3),
                            budget_ms=s.p99_budget_ms, count=count)
                        # the dump is the violation's evidence: journal
                        # it, then link the state transition to it so
                        # the bundle can join incident → frames
                        dump_id = self.journal.emit(
                            "flight.dump", reason="slo_violation",
                            path=path, slo=s.name)
                    except Exception:
                        pass
            if state != prev:
                self._state[s.name] = state
                self._reg.set_gauge("obs.slo.state", state, slo=s.name)
                self.journal.emit(
                    "slo.state", cause=dump_id, slo=s.name, pair=s.pair,
                    tenant=s.tenant, state=_STATE_NAMES[state],
                    prev=_STATE_NAMES[prev], p99_ms=round(p99, 3),
                    budget_ms=s.p99_budget_ms, count=count)
        self.violated_pairs = frozenset(violated)
        self.shed_signal = bool(violated)
        return self.status()

    def status(self) -> list[dict]:
        """Per-spec health rows (the ``admin slo`` payload)."""
        out = []
        for s in self.specs:
            count, p99 = self._last.get(s.name, (0, 0.0))
            out.append({
                "slo": s.name, "pair": s.pair, "tenant": s.tenant,
                "state": _STATE_NAMES[self._state[s.name]],
                "p99_ms": round(p99, 3), "budget_ms": s.p99_budget_ms,
                "window_s": s.window_s, "count": count,
                "burn": self._burn[s.name], "burn_ticks": s.burn_ticks,
            })
        return out

    # ---------------------------------------------------------------- thread

    def start(self) -> "SloEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fluid-slo-ticker", daemon=True)
            self._thread.start()
        return self

    @ticker_thread("slo")
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
