"""Point-in-time container boot over the history plane.

JAX counterpart: ``fluidframework_tpu/loader/history_boot.py``; the port's copy,
imports rebased to this package.

The loader half of the replay driver (ref: packages/drivers/
replay-driver ReplayController): ``driver.history.HistoryClient``
resolves the commit and binds a pinned :class:`DocumentService`
(``replay_service``); :func:`open_at` here boots a read-only container
from it and pumps the bounded tail ``(base, seq]`` through
``DeltaManager.advance_to``. Split across the two layers because
drivers may not import the loader — the driver supplies services, the
loader builds containers from them, same as the live path.
"""

from __future__ import annotations

from .container import Container


def open_at(history, seq: int, runtime_factory=None) -> Container:
    """Boot a read-only container of ``history``'s doc as of ``seq``.

    Snapshot-nearest-below plus bounded tail backfill; the returned
    container is offline and force-readonly — inspect its channels,
    never edit them. ``history`` is a ``DocumentService.history()``
    client (local or network)."""
    container = Container(history.replay_service(seq),
                          runtime_factory).load(connect=False)
    container.delta_manager.advance_to(seq)
    container.force_readonly(True)
    return container
