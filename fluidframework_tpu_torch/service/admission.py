"""Per-tenant admission control: token buckets + SLO-burn shedding.

JAX counterpart: ``fluidframework_tpu/service/admission.py``; the port's
copy, imports rebased to this package. The token buckets' rates come from
the tenant registry and the burn signal from the SLO engine
(``obs/slo.py``); the front end builds the controller in
``enable_admission`` (``--tenant-rate``) and attaches the engine in
``attach_slo`` (``--slo``).

Ref: Routerlicious gets overload protection for free from Kafka
backpressure plus Alfred's per-tenant throttler
(server/routerlicious/packages/lambdas — throttling middleware); our
socket tier has no broker between the front door and deli, so the
admission decision lives here, right where boxcars enter the event
loop (service/front_end.py calls :meth:`AdmissionController.check`
once per submit boxcar, never per op).

Two independent signals gate a boxcar:

1. **Token bucket** (per tenant, from ``TenantManager.set_rate``;
   tenants without a configured rate are unlimited). A depleted bucket
   alone does NOT shed — while the SLOs are healthy the boxcar is
   admitted anyway and only ``net.admission.delayed`` counts it
   (accounting, not refusal), so a modest burst above budget costs
   nothing when the service has headroom.
2. **SLO burn** (``SloEngine.shed_signal``). Only when some SLO is
   ``violated`` do depleted tenants shed: every op of the boxcar is
   nacked through the shared nack door with ``retry_after_ms`` and
   ``net.admission.shed{tenant,reason="rate"}`` counts the ops.

Shedding is boxcar-granular and must preserve deli's clientSeq
continuity (deli nacks any cseq gap, deli.py): once a connection has
shed cseq N, every later boxcar whose first cseq is ABOVE the lowest
shed cseq is shed too (``reason="ordering"``) until the client rewinds
— the driver resubmits held ops first, so one round trip restores the
stream. The resume watermark rides the ServerConnection itself
(``_shed_resume``), dying with the connection.

All state mutates on the front end's event-loop thread only.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..obs import get_registry
from ..obs.probe import CANARY_TENANT
from ..utils.affinity import loop_only

#: Bounds for the retry_after_ms hint handed to shed clients.
RETRY_AFTER_MIN_MS = 25
RETRY_AFTER_MAX_MS = 1000


class TokenBucket:
    """Classic token bucket; ``now`` injected for frozen-clock tests."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = self.burst
        self.t_last: Optional[float] = None

    def take(self, n: float, now: float) -> float:
        """Refill to ``now`` and try to take ``n`` tokens.

        Returns 0.0 on success, else the seconds until ``n`` tokens
        would be affordable (tokens untouched on failure). A boxcar
        larger than ``burst`` is admitted once the bucket is FULL, with
        the balance going negative (the refill pays the debt) — the
        driver coalesces its whole shed backlog into one resubmit, and
        refusing any boxcar over ``burst`` outright would livelock that
        retry forever."""
        if self.t_last is not None and now > self.t_last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= n or self.tokens >= self.burst:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate

    def drain(self) -> None:
        """Empty the bucket (soft-admit accounting: the over-budget
        boxcar was let through, so its cost is still charged)."""
        self.tokens = 0.0


def retry_after_ms(wait_s: float) -> int:
    return max(RETRY_AFTER_MIN_MS,
               min(RETRY_AFTER_MAX_MS, int(wait_s * 1000.0)))


class AdmissionController:
    """The front end's per-tenant admission gate (see module doc)."""

    def __init__(self, rate_for: Callable, registry=None):
        #: tenant -> (ops_per_s, burst) | None; re-read per boxcar so
        #: runtime rate changes take effect without a restart
        self._rate_for = rate_for
        self._reg = registry if registry is not None else get_registry()
        self._buckets: dict[str, TokenBucket] = {}
        #: attached SloEngine (or anything with .shed_signal); None
        #: means token depletion can only ever soft-admit
        self.engine = None
        #: master switch for the control arm of the overload bench
        self.shedding = True

    # ------------------------------------------------------------------ gate

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        spec = self._rate_for(tenant)
        if spec is None:
            self._buckets.pop(tenant, None)
            return None
        b = self._buckets.get(tenant)
        if b is None or (b.rate, b.burst) != spec:
            b = TokenBucket(*spec)
            self._buckets[tenant] = b
        return b

    def shed_active(self) -> bool:
        eng = self.engine
        return (self.shedding and eng is not None
                and bool(eng.shed_signal))

    @loop_only("core")
    def check(self, conn, n: int, first_cseq: int,
              now: Optional[float] = None) -> float:
        """Admission verdict for a boxcar of ``n`` ops starting at
        ``first_cseq`` on ``conn``. Returns 0.0 to admit, else the
        retry-after in seconds — the caller sheds the WHOLE boxcar."""
        tenant = conn.tenant_id
        if tenant == CANARY_TENANT:
            # the canary prober (obs/probe.py) is synthetic blackbox
            # traffic: it must measure the door, never consume a
            # tenant's tokens nor be shed by someone else's burn —
            # defense in depth behind the front end's own skip
            return 0.0
        resume = getattr(conn, "_shed_resume", None)
        if resume is not None:
            if first_cseq > resume:
                # ops behind an outstanding shed: admitting them would
                # gap the clientSeq stream at deli, so they shed too —
                # and they ride the SAME backoff as the rate shed that
                # opened the watermark. A come-back-now hint here made
                # the driver fire subset retries mid-nack-wave; each
                # re-shed multiplied the nack traffic until the wire
                # backed up (the noisy-neighbor seed-7 wedge).
                self._reg.inc("net.admission.shed", n, tenant=tenant,
                              reason="ordering")
                return getattr(conn, "_shed_wait_s",
                               RETRY_AFTER_MIN_MS / 1000.0)
            conn._shed_resume = None
        b = self._bucket(tenant)
        if b is None:
            return 0.0
        now = time.monotonic() if now is None else now
        wait = b.take(n, now)
        if wait <= 0.0:
            return 0.0
        if not self.shed_active():
            # over budget but SLOs healthy: admit (headroom exists),
            # charge the bucket, and account the overage
            b.drain()
            self._reg.inc("net.admission.delayed", n, tenant=tenant)
            return 0.0
        conn._shed_resume = (first_cseq if resume is None
                             else min(resume, first_cseq))
        conn._shed_wait_s = wait
        self._reg.inc("net.admission.shed", n, tenant=tenant,
                      reason="rate")
        return wait
