"""Base utils of the port (JAX counterpart: ``fluidframework_tpu/utils``):
the telemetry logger, counters, trace-hop ids and thread-affinity
markers."""

from .telemetry import (  # noqa: F401
    HOP_ACK,
    HOP_ADMIT,
    HOP_DELI,
    HOP_EXECUTE,
    HOP_FANOUT,
    HOP_RELAY,
    HOP_SHED,
    HOP_STAGE,
    HOP_SUBMIT,
    HOPS,
    Counters,
    PerformanceEvent,
    TelemetryLogger,
    percentile,
)
