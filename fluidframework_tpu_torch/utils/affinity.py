"""Execution-context markers for the concurrency contract checker.

JAX counterpart: ``fluidframework_tpu/utils/affinity.py``; the port's copy
of the two markers its modules use, ``holds_lock`` and ``blocking``.

Thread-discipline violations (staging refills racing in-flight
executions, counters read from a ticker thread) are the bugs these
markers make visible: a static checker reads them from the AST and
propagates contexts along the call graph. They are pure markers — at
runtime each costs ONE attribute assignment at import time and nothing
per call (the function object is returned unwrapped).
"""

from __future__ import annotations

__all__ = ["holds_lock", "blocking"]


def holds_lock(lock_name: str):
    """The function acquires and holds the named lock for its body."""
    def mark(fn):
        held = list(getattr(fn, "__holds_locks__", ()))
        held.append(lock_name)
        fn.__holds_locks__ = tuple(held)
        return fn
    return mark


def blocking(why: str):
    """The function blocks (a device fence, socket round-trip, flock);
    ``why`` names the operation."""
    def mark(fn):
        fn.__blocking__ = why
        return fn
    return mark
