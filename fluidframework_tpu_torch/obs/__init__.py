"""Observability plane of the port (JAX counterpart:
``fluidframework_tpu/obs``): the labeled metrics registry with a
Prometheus scrape, the crash flight recorder, the control-plane audit
journal, the SLO engine, the canary prober and the health engine. The
registry and the journal are the port's own process-wide objects,
separate from the JAX package's.
"""

from .flight import (  # noqa: F401
    FlightRecorder,
    get_recorder,
    reset_recorder,
)
from .journal import (  # noqa: F401
    KINDS as JOURNAL_KINDS,
    Journal,
    arm_journal,
    causal_chain,
    filter_entries,
    get_journal,
    merge_entries,
    read_journal,
    reset_journal,
)
from .metrics import (  # noqa: F401
    MetricsRegistry,
    WindowedSeries,
    get_registry,
    parse_prometheus,
    reset_registry,
    sum_counter_snapshots,
    tier_counters,
    tier_snapshot,
)
from .slo import (  # noqa: F401
    SloEngine,
    SloSpec,
    parse_slo_spec,
)
