"""The port's ordered log drain (``service/local_log.py::OrderedLogBase``)
against the JAX package's, on both storages (``LocalLog`` and
``DurableLog``).

Each scenario runs on each package's log and records every delivery as
(subscriber, offset, topic, partition, value); the two packages' records
are equal exactly, so a delivery keeps its offset, its value and its
place in the order. Scenarios: a handler that appends during the drain
(to its own topic and to another), handlers that subscribe and
unsubscribe mid-drain, a handler that raises (its topic stays dirty and
the next drain resumes), and the chaos plane's ``dup``, ``rewind`` and
``torn`` directives on ``log.append``. Tolerance: exact.
"""

from __future__ import annotations

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

PKGS = ("jax", "torch")
STORAGES = ("local", "durable")


def make_log(pkg: str, storage: str, tmp_path):
    if storage == "local":
        return module(pkg, "service.local_log").LocalLog()
    directory = tmp_path / pkg
    directory.mkdir()
    return module(pkg, "service.durable_log").DurableLog(
        str(directory / "log"))


class Recorder:
    """Named subscribers that write every delivery into one list."""

    def __init__(self):
        self.seen = []

    def sub(self, name: str, then=None):
        def handler(msg):
            self.seen.append((name, msg.offset, msg.topic, msg.partition,
                              msg.value))
            if then is not None:
                then(msg)
        return handler


def _append_during_drain(log):
    rec = Recorder()

    def echo(msg):
        v = msg.value["v"]
        log.append("b", {"v": v * 10})
        if v < 3:
            log.append("a", {"v": v + 1})

    log.subscribe("a", rec.sub("a1", echo))
    log.subscribe("a", rec.sub("a2"))
    log.subscribe("b", rec.sub("b1"))
    log.append("a", {"v": 0})
    log.append("a", {"v": 5})
    delivered = log.drain()
    log.append("b", {"v": -1})
    delivered += log.drain()
    assert log.drain() == 0
    return [rec.seen, delivered]


def _subscribe_mid_drain(log):
    rec = Recorder()
    late = rec.sub("late")
    gone = rec.sub("gone")

    def churn(msg):
        v = msg.value["v"]
        if v == 1:
            log.subscribe("a", late, from_offset=0)
        if v == 2:
            log.unsubscribe("a", gone)
        if v == 3:
            log.subscribe("b", rec.sub("b_late"), from_offset=1)
            log.append("b", {"v": 30})

    log.subscribe("a", rec.sub("first", churn))
    log.subscribe("a", gone)
    log.subscribe("b", rec.sub("b1"))
    for v in range(5):
        log.append("a", {"v": v})
        log.append("b", {"v": 100 + v})
    delivered = log.drain()
    log.append("a", {"v": 9})
    delivered += log.drain()
    return [rec.seen, delivered]


def _a_raising_handler(log):
    rec = Recorder()
    raised = []

    def boom(msg):
        if msg.value["v"] == 2 and not raised:
            raised.append(msg.offset)
            raise RuntimeError("handler failed")

    log.subscribe("a", rec.sub("before"))
    log.subscribe("a", rec.sub("boom", boom))
    log.subscribe("a", rec.sub("after"))
    log.subscribe("b", rec.sub("b1"))
    for v in range(5):
        log.append("a", {"v": v})
    log.append("b", {"v": 7})
    with pytest.raises(RuntimeError, match="handler failed"):
        log.drain()
    assert "a" in log._dirty  # re-dirtied: the next drain resumes
    delivered = log.drain()
    assert log.drain() == 0
    return [rec.seen, raised, delivered]


def _chaos_directives(log):
    rec = Recorder()
    script = iter(["dup", None, "rewind", "torn", None, "dup", "rewind",
                   None, "torn", None, "rewind", None, "dup", None, "torn",
                   "rewind", None, None])

    def plane(point, **ctx):
        assert point == "log.append"
        return next(script, None)

    def forward(msg):
        v = msg.value["v"]
        if v < 10:
            # an append to the topic being delivered: a rewind here
            # drags back the handler that is running
            log.append("a", {"v": v + 100})
        if v % 2 == 0:
            log.append("b", {"v": v + 1000})

    log.subscribe("a", rec.sub("a1", forward))
    log.subscribe("a", rec.sub("a2"))
    log.subscribe("b", rec.sub("b1"))
    log.fault_plane = plane
    delivered = 0
    for v in range(6):
        log.append("a", {"v": v})
        if v % 2:
            delivered += log.drain()
    log.fault_plane = None
    delivered += log.drain()
    return [rec.seen, delivered, log.length("a"), log.length("b")]


SCENARIOS = {
    "append_during_drain": _append_during_drain,
    "subscribe_mid_drain": _subscribe_mid_drain,
    "a_raising_handler": _a_raising_handler,
    "chaos_dup_rewind_torn": _chaos_directives,
}


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_drain_deliveries_match_the_reference(scenario, storage, tmp_path):
    shown = {pkg: SCENARIOS[scenario](make_log(pkg, storage, tmp_path))
             for pkg in PKGS}
    assert shown["torch"] == shown["jax"]
    assert shown["torch"][0]  # something was delivered


def test_handlers_at_one_record_see_the_same_delivery():
    """Handlers at the same record get equal (offset, topic, value); the
    value is what the storage's ``_load`` returns."""
    log = module("torch", "service.local_log").LocalLog()
    got = []
    log.subscribe("t", got.append)
    log.subscribe("t", got.append)
    value = {"v": 1}
    log.append("t", value)
    assert log.drain() == 2
    assert [(m.offset, m.topic, m.partition) for m in got] == [
        (0, "t", 0)] * 2
    assert got[0].value is value and got[1].value is value
