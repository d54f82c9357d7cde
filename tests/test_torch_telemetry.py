"""The port's telemetry (``utils/telemetry.py``: logger namespacing and
sinks, perf events, counters, the wire-trace consumer) against
``tests/test_telemetry.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package with the JAX test's assertions, and what each side shows
is equal exactly: every event a sink received (category, event,
namespace, fields) but for its wall-clock ``ts`` and the measured
``duration_ms``, every counter snapshot, every aggregator report. The two
end-to-end tests drive each package's ``LocalServer``; their hop
timings are wall-clock, so those reports compare by keys and counts.
Tolerance: exact.
"""

import time

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

PKGS = ("jax", "torch")
WALL_CLOCK = ("ts", "duration_ms")


def _u(pkg):
    return module(pkg, "utils")


def _events(sink) -> list:
    return [{k: v for k, v in r.items() if k not in WALL_CLOCK}
            for r in sink.records]


def _both(scenario) -> None:
    shown = {pkg: scenario(pkg) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _namespacing(pkg):
    u = _u(pkg)
    sink = u.BufferSink()
    root = u.TelemetryLogger("service", sinks=[sink])
    deli = root.child("deli")
    deli.info("nack", code=400)
    root.error("boom")
    assert sink.records[0]["namespace"] == "service:deli"
    assert sink.records[0]["code"] == 400
    assert sink.records[1]["category"] == "error"
    late = u.BufferSink()
    root.add_sink(late)
    deli.info("again")
    assert late.of("again")
    return [_events(sink), _events(late)]


def test_child_logger_namespacing_and_shared_sinks():
    _both(_namespacing)


def _sinkless(pkg):
    log = _u(pkg).TelemetryLogger("x")
    log.info("anything", heavy=object())
    return [log.namespace]


def test_sinkless_logger_is_free_and_silent():
    _both(_sinkless)


def _perf_event(pkg):
    u = _u(pkg)
    sink = u.BufferSink()
    log = u.TelemetryLogger("perf", sinks=[sink])
    with log.perf("step"):
        time.sleep(0.01)
    (end,) = sink.of("step_end")
    assert end["duration_ms"] >= 8
    try:
        with log.perf("bad"):
            raise ValueError("nope")
    except ValueError:
        pass
    (cancel,) = sink.of("bad_cancel")
    assert "nope" in cancel["error"]
    return _events(sink)


def test_performance_event_duration_and_cancel():
    _both(_perf_event)


def _percentiles(pkg):
    c = _u(pkg).Counters()
    c.inc("ops", 3)
    for v in range(100):
        c.observe("lat", float(v))
    snap = c.snapshot()
    assert snap["ops"] == 3
    assert snap["lat"]["count"] == 100
    assert 45 <= snap["lat"]["p50"] <= 55
    return snap


def test_counters_snapshot_percentiles():
    _both(_percentiles)


def _collision(pkg):
    c = _u(pkg).Counters()
    c.inc("chaos.injected", 2)
    c.observe("chaos.injected", 1.5)
    c.observe("chaos.injected", 2.5)
    snap = c.snapshot()
    assert snap["chaos.injected"]["count"] == 2
    assert snap["chaos.injected"]["counter"] == 2
    assert snap["chaos.injected"]["p50"] in (1.5, 2.5)
    return snap


def test_counters_name_collision_surfaces_both():
    _both(_collision)


def _reservoir(pkg):
    counters = _u(pkg).Counters
    c = counters(max_samples=64)
    for v in range(10_000):
        c.observe("lat", float(v))
    assert len(c._values["lat"]) == 64
    snap = c.snapshot()
    assert snap["lat"]["count"] == 10_000
    assert 2_000 <= snap["lat"]["p50"] <= 8_000
    c2 = counters(max_samples=64)
    for v in range(10_000):
        c2.observe("lat", float(v))
    assert c2.snapshot() == snap
    return [snap, list(c._values["lat"])]


def test_counters_reservoir_is_bounded_and_deterministic():
    _both(_reservoir)


def _msg(pkg, traces):
    m = module(pkg, "protocol.messages")
    return m.SequencedDocumentMessage(
        client_id="c", sequence_number=1, minimum_sequence_number=0,
        client_sequence_number=1, reference_sequence_number=0,
        type=m.MessageType.OPERATION, traces=traces)


def _hop(pkg, *args):
    return module(pkg, "protocol.messages").TraceHop(*args)


def _per_hop_split(pkg):
    agg = _u(pkg).TraceAggregator()
    t0 = 1000.0
    agg.record(_msg(pkg, [_hop(pkg, "client", "submit", t0),
                          _hop(pkg, "deli", "sequence", t0 + 0.004)]),
               ack_time=t0 + 0.010)
    rep = agg.report()
    assert abs(rep["submit_to_deli"]["p50_ms"] - 4.0) < 0.01
    assert abs(rep["deli_to_ack"]["p50_ms"] - 6.0) < 0.01
    return rep


def test_trace_aggregator_per_hop_split():
    _both(_per_hop_split)


def _missing_hops(pkg):
    agg = _u(pkg).TraceAggregator()
    agg.record(_msg(pkg, [_hop(pkg, "client", "submit", 1000.0)]),
               ack_time=1000.5)
    assert agg.report() == {}
    agg.record(_msg(pkg, [_hop(pkg, "deli", "sequence", 1000.0)]),
               ack_time=1000.002)
    rep = agg.report()
    assert "submit_to_deli" not in rep
    assert rep["deli_to_ack"]["count"] == 1
    agg.record(_msg(pkg, []), ack_time=1001.0)
    assert agg.report()["deli_to_ack"]["count"] == 1
    return [rep, agg.report()]


def test_trace_aggregator_missing_hops():
    _both(_missing_hops)


def _merge_raw(pkg):
    aggregator = _u(pkg).TraceAggregator
    a, b = aggregator(), aggregator()
    t0 = 2000.0
    for i in range(10):
        a.record(_msg(pkg, [_hop(pkg, "client", "submit", t0),
                            _hop(pkg, "deli", "sequence",
                                 t0 + 0.001 * (i + 1))]),
                 ack_time=t0 + 0.05)
    b.merge_raw(a.raw)
    b.merge_raw({"submit_to_deli": [100.0], "custom_hop": [7.0]})
    rep = b.report()
    assert rep["submit_to_deli"]["count"] == 11
    assert rep["custom_hop"] == {"count": 1, "p50_ms": 7.0, "p99_ms": 7.0}
    assert 4.0 <= rep["submit_to_deli"]["p50_ms"] <= 7.0
    assert rep["submit_to_deli"]["p99_ms"] == 100.0
    return [rep, b.raw]


def test_trace_aggregator_merge_raw_and_percentiles():
    _both(_merge_raw)


def _deli_stamps(pkg):
    m = module(pkg, "protocol.messages")
    server = module(pkg, "service").LocalServer()
    agg = _u(pkg).TraceAggregator()
    conn = server.connect("t", "doc")
    acked = []
    conn.on_ops = lambda batch: [
        (agg.record(msg), acked.append(msg))
        for msg in batch if msg.client_id == conn.client_id]
    conn.submit([m.DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=m.MessageType.OPERATION, contents={"x": 1},
        traces=[m.TraceHop("client", "submit", time.time())])])
    assert acked
    rep = agg.report()
    assert rep["submit_to_deli"]["count"] == 1
    assert rep["deli_to_fanout"]["count"] == 1
    assert rep["fanout_to_ack"]["count"] == 1
    return [{k: v["count"] for k, v in rep.items()},
            [[(h.service, h.action) for h in msg.traces] for msg in acked]]


def test_deli_stamps_ride_to_clients_and_aggregate():
    _both(_deli_stamps)


def _nacks_and_evictions(pkg):
    u = _u(pkg)
    m = module(pkg, "protocol.messages")
    sink = u.BufferSink()
    now = [0.0]
    server = module(pkg, "service").LocalServer(
        clock=lambda: now[0], client_timeout=10.0,
        logger=u.TelemetryLogger("svc", sinks=[sink]))
    server._client_epoch = "e0"
    conn = server.connect("t", "doc")
    conn.submit([m.DocumentMessage(
        client_sequence_number=5, reference_sequence_number=0,
        type=m.MessageType.OPERATION, contents={})])
    (nack,) = sink.of("nack")
    assert "gap" in nack["reason"] and nack["namespace"].endswith("deli")
    now[0] = 100.0
    server.expire_idle_clients()
    assert sink.of("idle_client_evicted")
    return _events(sink)


def test_deli_nacks_and_evictions_are_logged():
    _both(_nacks_and_evictions)
