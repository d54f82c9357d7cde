"""Execution-context markers for the concurrency contract checker.

JAX counterpart: ``fluidframework_tpu/utils/affinity.py``; the port's copy
of the markers its modules use: ``loop_only``, ``ticker_thread``,
``any_thread``, ``holds_lock`` and ``blocking``.

Thread-discipline violations (staging refills racing in-flight
executions, counters read from a ticker thread) are the bugs these
markers make visible: a static checker reads them from the AST and
propagates contexts along the call graph. They are pure markers — at
runtime each costs ONE attribute assignment at import time and nothing
per call (the function object is returned unwrapped).
"""

from __future__ import annotations

__all__ = ["loop_only", "ticker_thread", "any_thread", "holds_lock",
           "blocking"]


def loop_only(loop_name: str = "core"):
    """This function must only run on the named event-loop thread."""
    def mark(fn):
        fn.__affinity__ = ("loop", loop_name)
        return fn
    return mark


def ticker_thread(ticker_name: str):
    """This function runs on (or is a callback for) the named daemon
    ticker thread."""
    def mark(fn):
        fn.__affinity__ = ("ticker", ticker_name)
        return fn
    return mark


def any_thread(fn):
    """Safe from any context — the function synchronizes internally."""
    fn.__affinity__ = ("any", "")
    return fn


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
