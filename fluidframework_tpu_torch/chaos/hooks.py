"""Seam installers: arm/disarm a FaultPlane across the service seams.

JAX counterpart: ``fluidframework_tpu/chaos/hooks.py``; the port's copy,
imports rebased to this package, without the socket transport's frame
hook (``transports=True``) and the front end's snapshot seam, which
come with soak phase B (ROADMAP A8). The sharded core's partitions
(``partitions=``) arm as in the JAX package.

Every seam is a duck-typed ``fault_plane`` attribute (``None`` when
disarmed — one predictable branch on the hot path). The service never
imports chaos; chaos reaches down and installs itself (``chaos`` may
import service/driver/utils; nothing outside tests may import
``chaos``).

Use :func:`armed` as a context manager in tests; the soak uses
:func:`install`/the returned uninstaller directly.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable

from ..service.broadcaster import BroadcasterLambda
from ..service.history_plane import HistoryPlane
from .plane import FaultPlane


def install(plane: FaultPlane, *, server=None, appliers: Iterable = (),
            stages: Iterable = (), partitions: Iterable = (),
            summarizers: Iterable = ()) -> Callable[[], None]:
    """Arm ``plane`` at the requested seams; returns an uninstaller.

    - ``server``: a LocalServer — arms its ordered log (append faults)
      and, class-wide, the broadcaster fan-out and the history plane
      (both are built lazily, so the hook must be on the class).
    - ``appliers`` / ``stages`` / ``partitions``: ``GpuDocumentApplier``,
      ``stage_runner`` stage and ``partitions.Partition`` instances to
      arm.
    - ``summarizers``: ServiceSummarizer instances — arms the
      mid-upload crash window (``snapshot.upload``).
    """
    undo: list[Callable[[], None]] = []

    def _set(obj, attr: str, value) -> None:
        had = attr in vars(obj) if not isinstance(obj, type) else True
        prev = getattr(obj, attr, None)
        setattr(obj, attr, value)
        if isinstance(obj, type) or had:
            undo.append(lambda: setattr(obj, attr, prev))
        else:
            undo.append(lambda: delattr(obj, attr))

    if server is not None:
        _set(server.log, "fault_plane", plane)
        _set(BroadcasterLambda, "fault_plane", plane)
        # the history plane is built lazily (server.history property), so
        # the hook must sit on the class like the broadcaster's
        _set(HistoryPlane, "fault_plane", plane)
    for applier in appliers:
        _set(applier, "fault_plane", plane)
    for stage in stages:
        _set(stage, "fault_plane", plane)
    for part in partitions:
        _set(part, "fault_plane", plane)
    for summ in summarizers:
        _set(summ, "fault_plane", plane)

    def uninstall() -> None:
        while undo:
            undo.pop()()

    return uninstall


@contextlib.contextmanager
def armed(plane: FaultPlane, **seams):
    """``with armed(plane, server=s): ...`` — install, then always
    uninstall (tests must not leak class-level hooks)."""
    uninstall = install(plane, **seams)
    try:
        yield plane
    finally:
        uninstall()
