"""The program's own span recorder, read by the metrics of its layers.

``fluidframework_tpu_torch.utils.telemetry.SPANS`` records spans inside
the program (deli, the store, the fan-out, the sessions, the farm's
waves) while a ``torch.profiler`` session runs, which is the traced
window. A program without the recorder, or a run in which it recorded
nothing, reads as None, and those metrics stay silent.
"""

from __future__ import annotations

import importlib


def snapshot():
    """The recorder's totals (``SpanRecorder.snapshot()``), or None."""
    try:
        telemetry = importlib.import_module(
            "fluidframework_tpu_torch.utils.telemetry")
    except ImportError:
        return None
    spans = getattr(telemetry, "SPANS", None)
    if spans is None:
        return None
    snap = spans.snapshot()
    return snap if snap["spans"] else None


def us_per_op(run, *terms):
    """Host microseconds an acked op of the recorder's ``(span, key)``
    totals summed, ``key`` being ``seconds`` or ``self_seconds``; None
    when the recorder saw nothing."""
    snap = snapshot()
    ops = run.counts.get("acked_ops")
    if snap is None or not ops:
        return None
    seconds = sum(snap["spans"].get(name, {}).get(key, 0.0)
                  for name, key in terms)
    return seconds / ops * 1e6
