"""Base utils of the port (JAX counterpart: ``fluidframework_tpu/utils``):
the telemetry logger, counters, trace-hop ids with the hop-pair
breakdown, and thread-affinity markers."""

from .telemetry import (  # noqa: F401
    HOP_ACK,
    HOP_ADMIT,
    HOP_DELI,
    HOP_EXECUTE,
    HOP_FANOUT,
    HOP_ORDER,
    HOP_PIPELINE,
    HOP_RELAY,
    HOP_SHED,
    HOP_STAGE,
    HOP_SUBMIT,
    HOPS,
    BufferSink,
    Counters,
    PerformanceEvent,
    TelemetryLogger,
    TraceAggregator,
    count_unknown_hops,
    hop_pair_name,
    hop_pairs,
    percentile,
)
