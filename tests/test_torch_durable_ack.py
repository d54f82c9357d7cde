"""ROADMAP C12: a core over a durable log acks an op only once the op is in
the log.

The front end handles a socket's buffered frames as one batch and then
flushes the logs the batch dirtied. The JAX core writes each broadcast
(the submitter's ack among them) to the socket while it handles the
frame, so an ack can reach its client before the flush; a core killed in
between loses an op its client saw acknowledged (the port's fleet test
saw a takeover owner's stream without such an op). The port's core holds
the batch's writes until its flush. The window is widened here by a
flush that waits 0.3 s; the client's ack must not arrive before it ends.
"""

from __future__ import annotations

import threading
import time
from importlib import import_module

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _acked_before_flush(root: str, tmp_path) -> tuple:
    """One client's op through a core over a ``DurableLog`` whose batch
    flush is slowed: (whether the ack arrived before the flush ended,
    the number of slowed flushes)."""
    DurableLog = import_module(f"{root}.service.durable_log").DurableLog
    LocalServer = import_module(f"{root}.service.local_server").LocalServer
    NetworkFrontEnd = import_module(
        f"{root}.service.front_end").NetworkFrontEnd
    Factory = import_module(
        f"{root}.driver.network").NetworkDocumentServiceFactory
    Loader = import_module(f"{root}.loader").Loader

    log = DurableLog(str(tmp_path / root))
    front = NetworkFrontEnd(server=LocalServer(log=log)).start_background()
    try:
        c = Loader(Factory("127.0.0.1", front.port)).resolve("t", "ack")
        text = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        deadline = time.time() + 10
        while c.runtime.pending.count and time.time() < deadline:
            time.sleep(0.01)
        assert c.runtime.pending.count == 0

        flushed = threading.Event()
        slowed = []
        flush = front._flush_dirty

        def slow_flush():
            if front._dirty_servers:
                slowed.append(1)
                flushed.clear()
                time.sleep(0.3)
            flush()
            flushed.set()

        front._flush_dirty = slow_flush
        text.insert_text(0, "durable")
        deadline = time.time() + 10
        while c.runtime.pending.count and time.time() < deadline:
            time.sleep(0.001)
        assert c.runtime.pending.count == 0
        early = not flushed.is_set()
        c.close()
        return early, len(slowed)
    finally:
        front.stop()
        log.close()


def test_jax_core_acks_before_the_flush(tmp_path):
    """The fault, in the JAX package's core."""
    early, slowed = _acked_before_flush(ROOTS["jax"], tmp_path)
    assert slowed >= 1 and early


def test_port_core_acks_after_the_flush(tmp_path):
    """The repair: the ack leaves after the batch's flush."""
    early, slowed = _acked_before_flush(ROOTS["torch"], tmp_path)
    assert slowed >= 1 and not early

