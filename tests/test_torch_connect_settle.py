"""ROADMAP C14 in the client stack: a client behind a gateway must come
out of ``resolve`` connected, as it does in the JAX package.

Through a gateway the client's own join arrives just after the
``connected`` reply, while the delta manager's connect-time catch-up is
still fetching history. The JAX delta manager lets the reader thread
process the join during that fetch, so the connection is active when
``connect`` returns. The port's catch-up holds the connection's dispatch
lock (ROADMAP C2), so the reader thread waited with the join in hand and
the container came back still connecting: a signal sent at once failed
with "cannot signal while disconnected" (``test_torch_read_fanout.py::
test_signals_traverse_the_tree``, 13 of 30 scripted resolves through a
leaf gateway). The port's ``connect`` now lets the reader thread handle
what it read during the catch-up before returning (``settle``).

Deterministic here: the reader thread holds the join until the catch-up
has begun, the catch-up waits until the reader thread has let it go,
and a long switch interval keeps the reader thread from running except
while the app thread blocks. One fleet: the
port's core and its Python relay, as processes; either package's client
talks to them.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

ROOT = Path(__file__).resolve().parent.parent


def _spawn(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=str(ROOT))
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING"), line
    return proc, int(line.rsplit(":", 1)[1])


@pytest.fixture(scope="module")
def relay():
    """The port's core and a Python gateway in front of it: the
    gateway's port."""
    core, core_port = _spawn(
        ["fluidframework_tpu_torch.service.front_end", "--port", "0"])
    try:
        gw, port = _spawn(["fluidframework_tpu_torch.service.gateway",
                           "--core-port", str(core_port), "--python"])
        try:
            yield port
        finally:
            gw.terminate()
            gw.wait(timeout=10)
    finally:
        core.terminate()
        core.wait(timeout=10)


def _join_during_catch_up(pkg, monkeypatch) -> None:
    """Make the client's join reach the delta manager during its
    connect-time catch-up: the reader thread holds the first ops frame
    after the handshake (the join) until the catch-up
    (``_fetch_missing`` while the connection is pending) has begun, and
    the catch-up goes on 50 ms after the reader thread let it go."""
    net = module(pkg, "driver.network")
    manager = module(pkg, "loader.delta_manager").DeltaManager
    entered, decoded = threading.Event(), threading.Event()
    decode, fetch = net.binwire.decode_ops, manager._fetch_missing

    def decode_ops(body):
        out = decode(body)
        if not decoded.is_set():
            entered.wait(5.0)
            decoded.set()
        return out

    def held(self, upto):
        if self.pending_connection is not None and not entered.is_set():
            entered.set()
            assert decoded.wait(5.0)
            time.sleep(0.05)
        return fetch(self, upto)

    monkeypatch.setattr(net.binwire, "decode_ops", decode_ops)
    monkeypatch.setattr(manager, "_fetch_missing", held)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resolve_behind_a_gateway_returns_connected(relay, pkg,
                                                    monkeypatch):
    net = module(pkg, "driver.network")
    loader = module(pkg, "loader").Loader
    doc = f"settle-{pkg}"
    first = loader(net.NetworkDocumentServiceFactory(
        "127.0.0.1", relay)).resolve("t", doc)
    first.close()  # history to catch up on, and no other reader thread
    _join_during_catch_up(pkg, monkeypatch)
    # the reader thread runs only when the app thread blocks, never by
    # preemption between connect's return and the check
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        second = loader(net.NetworkDocumentServiceFactory(
            "127.0.0.1", relay)).resolve("t", doc)
        connected = second.connected
    finally:
        sys.setswitchinterval(interval)
        monkeypatch.undo()
    try:
        assert connected
        second.submit_signal({"ready": True})
    finally:
        second.close()
