"""Order statistics over every sample of a run."""

from __future__ import annotations


def percentile(samples, p: float) -> float:
    """The ``p`` quantile (0..1) of ``samples`` by nearest rank over all
    of them, as the program's ``utils/telemetry.percentile`` takes it.
    Raises on an empty sample: no reading is not a reading of 0."""
    vals = sorted(samples)
    if not vals:
        raise ValueError("percentile of no samples")
    k = min(len(vals) - 1, max(0, int(round(p * (len(vals) - 1)))))
    return vals[k]
