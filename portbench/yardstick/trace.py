"""The traced run: the profiler around the window, and the arithmetic
that turns its device intervals and the harness's host spans into busy
time, idle gaps and device time by kernel.

The busy-time union is a copy of the program's
``tools/profile_service.py::_busy_us``; the rest is the harness's own.
Host spans are the harness's ``time.perf_counter`` stamps around its
calls into the program. They are put on the profiler's time line by a
``record_function`` marker entered at a known ``perf_counter`` reading.
"""

from __future__ import annotations

import time

import numpy as np

MARKER = "portbench.window"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def short_name(name: str) -> str:
    """A device operation's name without its boilerplate, cut to 100
    characters (a kernel's template arguments run to thousands)."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:100]


def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_gaps(intervals, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that no interval covers, longest first,
    as ``(start, end)``."""
    gaps, t = [], w0
    for a, b in merged(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def covered(starts: np.ndarray, ends: np.ndarray, a: float,
            b: float) -> float:
    """How much of [a, b] the disjoint sorted spans ``starts``/``ends``
    cover."""
    if not len(starts) or b <= a:
        return 0.0
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])
    i = int(np.searchsorted(ends, a, side="right"))
    j = int(np.searchsorted(starts, b, side="left"))
    if j <= i:
        return 0.0
    total = cum[j] - cum[i]
    total -= max(0.0, a - starts[i])
    total -= max(0.0, ends[j - 1] - b)
    return float(total)


def label_gap(spans: dict, nested: dict, a: float, b: float) -> str:
    """What the host was doing through most of the gap [a, b]: the span
    label with the most exclusive time in it (a label's time less that of
    the labels ``nested`` in it), or ``other``."""
    cover = {k: covered(s, e, a, b) for k, (s, e) in spans.items()}
    excl = dict(cover)
    for parent, children in nested.items():
        if parent in excl:
            excl[parent] -= sum(cover.get(c, 0.0) for c in children)
    excl["other"] = (b - a) - sum(v for k, v in cover.items()
                                  if not any(k in c for c in nested.values()))
    return max(excl.items(), key=lambda kv: kv[1])[0]


class Profiled:
    """``torch.profiler`` (CPU and CUDA activities) around a window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.marker_perf = None

    def __enter__(self):
        import torch

        self._prof.__enter__()
        with torch.profiler.record_function(MARKER):
            self.marker_perf = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def device_events(self) -> tuple:
        """(device intervals in perf_counter seconds as ``(start, end,
        name)``, the marker's offset). Raises when the profiler saw no
        device activity."""
        import torch

        events = self._prof.events()
        marker = next((e for e in events if e.name == MARKER), None)
        if marker is None:
            raise RuntimeError("the profiler lost the window's marker")
        # profiler microseconds → perf_counter seconds
        shift = self.marker_perf - marker.time_range.start / 1e6
        cuda = torch.autograd.DeviceType.CUDA
        out = [(e.time_range.start / 1e6 + shift,
                e.time_range.end / 1e6 + shift, e.name)
               for e in events if e.device_type == cuda]
        if not out:
            raise RuntimeError("the profiler saw no device activity")
        return out


def analyse(device: list, w0: float, w1: float, spans: dict,
            nested: dict) -> dict:
    """Busy and idle time of the window [w0, w1] from the device
    intervals, device seconds by kernel name (copies apart), and the ten
    longest idle gaps named by what the host was doing."""
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    busy = union_length((a, b) for a, b, _ in inside)
    by_name: dict = {}
    for a, b, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    kernels = {n: s for n, s in by_name.items()
               if not n.startswith(COPY_PREFIXES)}
    gaps = idle_gaps([(a, b) for a, b, _ in inside], w0, w1)[:10]
    return {
        "busy_s": busy, "window_s": w1 - w0,
        "kernel_s": kernels,
        "idle_gaps": [[label_gap(spans, nested, a, b), b - a]
                      for a, b in gaps],
        "device_ops": sorted(([short_name(n), s]
                              for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
    }
