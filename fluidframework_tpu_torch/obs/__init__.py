"""Observability plane of the port (JAX counterpart:
``fluidframework_tpu/obs``): the labeled metrics registry with a
Prometheus scrape, and the crash flight recorder. The registry is the
port's own process-wide object, separate from the JAX package's.

The journal and the SLO engine are not ported yet (ROADMAP A9).
"""

from .flight import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    reset_recorder,
)
from .metrics import (  # noqa: F401
    MetricsRegistry,
    WindowedSeries,
    get_registry,
    parse_prometheus,
    reset_registry,
    tier_counters,
    tier_snapshot,
)
