"""FaultPlane: seeded, schedulable fault injection behind named points.

JAX counterpart: ``fluidframework_tpu/chaos/plane.py``; the port's copy,
imports rebased to this package.

The seams (service/local_log.py appends, service/broadcaster.py fan-out,
service/stage_runner.py checkpoints, service/gpu_applier.py ingest,
dispatch and the stage/execute split, service/service_summarizer.py
uploads, service/history_plane.py forks) each hold a duck-typed
``fault_plane`` attribute, ``None`` by default. When armed, a seam calls

    directive = self.fault_plane("log.append", topic=topic, record=value)

and interprets the returned directive string (``None`` = no fault). A
directive starting with ``"crash"`` is raised out of the plane itself as
:class:`SimulatedCrash`, so service code never needs to know the
exception type — the kill just propagates out of the seam like a real
process death would.

Determinism: rules fire on *match counts* (``at`` / ``every``), not wall
time, and the PRNG (used only for ``p``-rules) is seeded — the same seed
against the same workload produces the same injections in the same
places. Every injection is recorded in the ledger and counted into the
telemetry counters (``chaos.injected.<point>.<directive>``) so the soak
can cross-check "faults injected" against "recoveries observed".
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Callable, Optional

from ..obs import tier_counters
from ..utils.telemetry import Counters

#: injection point → boundary class, for the per-class coverage check
#: (the soak requires ≥1 injected fault per class per run).
BOUNDARY_CLASSES = {
    "net": "network",
    "log": "log",
    "broadcast": "fanout",
    "relay": "fanout",
    "stage": "stage",
    "partition": "stage",
    "applier": "device",
    "snapshot": "snapshot",
    "placement": "placement",
    "history": "history",
}


class SimulatedCrash(Exception):
    """A scheduled kill raised out of an injection point (the in-process
    stand-in for kill -9 between consume and checkpoint, or between
    checkpoint and emit). Harnesses catch it and run the real recovery
    path; nothing else may swallow it."""


class FaultRule:
    """One scheduled fault: fire ``directive`` at ``point``.

    ``at`` fires on the Nth matching consult (1-based); ``every`` fires
    on every Nth; ``p`` fires with seeded probability; ``times`` caps the
    total number of firings (default 1 for ``at``, unlimited otherwise).
    ``when(ctx)`` restricts matching to consults whose context passes.
    """

    def __init__(self, point: str, directive: str,
                 at: Optional[int] = None, every: Optional[int] = None,
                 p: Optional[float] = None, times: Optional[int] = None,
                 when: Optional[Callable[[dict], bool]] = None):
        self.point = point
        self.directive = directive
        self.at = at
        self.every = every
        self.p = p
        self.when = when
        self.times = times if times is not None else (1 if at is not None
                                                      else None)
        self.seen = 0   # matching consults observed
        self.fired = 0  # injections performed

    def matches(self, point: str, ctx: dict) -> bool:
        return point == self.point and (self.when is None or
                                        bool(self.when(ctx)))

    def should_fire(self, rng: random.Random) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None and self.seen == self.at:
            return True
        if self.every is not None and self.seen % self.every == 0:
            return True
        if self.p is not None and rng.random() < self.p:
            return True
        return False


class FaultPlane:
    """Seeded registry of fault rules behind named injection points."""

    def __init__(self, seed: int = 0, counters: Optional[Counters] = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.counters = (counters if counters is not None
                         else tier_counters("chaos"))
        self.rules: list[FaultRule] = []
        self.armed = True
        self.calls: dict[str, int] = defaultdict(int)
        #: injection ledger: (point, directive, context summary)
        self.injected: list[tuple[str, str, dict]] = []

    def rule(self, point: str, directive: str, **kw: Any) -> FaultRule:
        r = FaultRule(point, directive, **kw)
        self.rules.append(r)
        return r

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def __call__(self, point: str, **ctx: Any) -> Optional[str]:
        """Consult the plane at an injection point. Returns a directive
        string (or None); raises SimulatedCrash for crash directives."""
        if not self.armed:
            return None
        self.calls[point] += 1
        for r in self.rules:
            if not r.matches(point, ctx):
                continue
            r.seen += 1
            if not r.should_fire(self.rng):
                continue
            r.fired += 1
            self._record(point, r.directive, ctx)
            if r.directive.startswith("crash"):
                raise SimulatedCrash(f"{point}:{r.directive}")
            return r.directive
        return None

    def _record(self, point: str, directive: str, ctx: dict) -> None:
        # keep only scalar context in the ledger (records/bodies are big
        # and often unpicklable)
        lite = {k: v for k, v in ctx.items()
                if isinstance(v, (str, int, float, bool)) or v is None}
        self.injected.append((point, directive, lite))
        self.counters.inc(f"chaos.injected.{point}.{directive}")
        self.counters.inc("chaos.faults.injected")

    # -------------------------------------------------------- introspection

    def injected_by_class(self) -> dict[str, int]:
        """Injection counts per boundary class (network / log / fanout /
        stage / device) — the soak's coverage assertion reads this."""
        out: dict[str, int] = defaultdict(int)
        for point, _, _ in self.injected:
            cls = BOUNDARY_CLASSES.get(point.split(".", 1)[0], point)
            out[cls] += 1
        return dict(out)

    def merge_ledger(self, other: "FaultPlane") -> None:
        """Fold another plane's ledger into this one (the soak runs one
        plane per phase but asserts coverage over the whole run)."""
        self.injected.extend(other.injected)
