"""Cold-start rehydration plane: bounded lazy doc boots for a cold core.

JAX counterpart: ``fluidframework_tpu/service/rehydrate.py``; the port's
copy, imports rebased to this package. ``LocalServer.lazy_boot`` and
``NetworkFrontEnd.enable_boot_admission`` arm it; ``ShardHost`` turns lazy
boot on for every partition server.

After a full-cluster crash a core inherits a partition space of maybe
10k docs. Two rules keep recovery O(what's asked for):

- **Lazy**: claiming a partition builds NO per-doc pipeline. The first
  route to a doc boots it from the latest acked summary + the durable
  log tail (local_orderer's lazy plan); docs nobody asks for cost
  nothing. ``boot.part.lazy`` / ``boot.part.full_replay`` witness that
  the whole-log-replay count is zero.
- **Bounded**: a boot *storm* (thousands of first-routes at once) must
  not hold connects hostage behind pipeline construction. The
  :class:`RehydrationExecutor` is a token bucket (the admission
  primitive) on boots per core: excess first-routes park with
  :class:`BootPending` — surfaced as a ``boot_pending`` nack the driver
  retries on the shed-retry lane — while warm docs' acks stay flat.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from ..obs.metrics import tier_counters
from .admission import TokenBucket, retry_after_ms

_counters = None


def boot_counters():
    """The boot-plane counter sheet. One frontend-tier instance per
    process (tier_snapshot("frontend") folds it into admin_boot_status
    next to the front end's own sheet)."""
    global _counters
    if _counters is None:
        _counters = tier_counters("frontend")
    return _counters


class BootPending(RuntimeError):
    """First route to a cold doc parked by the rehydration executor: the
    caller retries after ``retry_after_ms`` instead of timing out a
    connect held hostage by a boot storm."""

    def __init__(self, retry_after: int):
        super().__init__(
            f"doc boot parked by cold-start admission; retry in "
            f"{retry_after}ms")
        self.retry_after_ms = retry_after


class RehydrationExecutor:
    """Per-core cap on doc-boot admissions (rate + burst).

    Boots run ON the core's event loop (pipeline construction is
    single-threaded by design), so the bucket bounds how much of each
    loop interval the storm may consume: between admitted boots the
    loop keeps serving warm-doc submits and acks. Parked first-routes
    carry a jittered retry-after, the same contract as overload
    shedding.
    """

    def __init__(self, boots_per_s: float = 200.0, burst: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.bucket = TokenBucket(rate=boots_per_s, burst=burst)
        self._clock = clock
        self.booted = 0
        self.parked = 0
        # chaos seam: die (kill -9-shaped, no cleanup) after admitting N
        # boots — the drill's crash-mid-rehydration window. Env-armed so
        # subprocess cores can be told to crash from the outside.
        crash = os.environ.get("FLUID_CHAOS_BOOT_CRASH")
        self.crash_after = int(crash) if crash else None

    def admit(self, tenant_id: str, document_id: str) -> None:
        """Take a boot slot or raise :class:`BootPending`."""
        wait = self.bucket.take(1.0, self._clock())
        if wait > 0.0:
            self.parked += 1
            boot_counters().inc("boot.part.parked")
            raise BootPending(retry_after_ms(wait))
        self.booted += 1
        if self.crash_after is not None and self.booted >= self.crash_after:
            os._exit(9)  # the crash seam: mid-storm, boots in flight

    def status(self) -> dict:
        """Operator view (admin placement boot)."""
        return {
            "booted": self.booted,
            "parked": self.parked,
            "rate": self.bucket.rate,
            "burst": self.bucket.burst,
            "tokens": round(self.bucket.tokens, 3),
        }
