"""The port's observability plane (``obs/``: the hoptail codec, the
labeled metrics registry, the flight recorder; the hop path through the
front end) against ``tests/test_obs.py``.

Each codec, registry and recorder test is the twin of the JAX test of
the same name: it runs on each package with the JAX test's assertions,
and the stamped frames, the Prometheus scrapes and the parsed series,
and the recorder's dump lines but for their wall-clock fields are equal
between the packages exactly. The two hop-path tests need sockets: they
run the JAX test's assertions on the port's ``NetworkFrontEnd`` alone (in
process, as the JAX test runs its own), with the socket helpers of
``test_torch_columnar.py``. Tolerance: exact.
"""

import json
import random
import struct
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.test_torch_columnar import bin_client, next_cols, rand_cols_ops
from tests.torch_stack_fixtures import module

from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.obs import get_registry, parse_prometheus
from fluidframework_tpu_torch.protocol import binwire
from fluidframework_tpu_torch.protocol.messages import (
    DocumentMessage,
    MessageType,
    TraceHop,
)
from fluidframework_tpu_torch.service.front_end import NetworkFrontEnd
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.utils.telemetry import (
    HOP_ADMIT,
    HOP_DELI,
    HOP_FANOUT,
    HOP_SUBMIT,
    TraceAggregator,
    hop_pairs,
)

PKGS = ("jax", "torch")


def wait_for(pred, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


def _both(scenario, *args) -> None:
    shown = {pkg: scenario(pkg, *args) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _tel(pkg):
    return module(pkg, "utils.telemetry")


def _append_read(pkg):
    bw = module(pkg, "protocol.binwire")
    tel = _tel(pkg)
    body = bw.encode_submit_columns(rand_cols_ops(random.Random(1), 3,
                                                  pkg=pkg))
    assert body[-1] == 0
    assert bw.read_hoptail(body) == []
    t0, t1 = 1754400000.125, 1754400000.875
    stamped = bw.append_hop(body, tel.HOP_SUBMIT, t0)
    stamped = bw.append_hop(stamped, tel.HOP_ADMIT, t1)
    assert bw.read_hoptail(stamped) == [(tel.HOP_SUBMIT, t0),
                                        (tel.HOP_ADMIT, t1)]
    assert stamped[:len(body) - 1] == body[:-1]
    end = len(body) - 1
    assert bw.read_hoptail(stamped, end=end) == [(tel.HOP_SUBMIT, t0),
                                                 (tel.HOP_ADMIT, t1)]
    assert bw.read_hoptail(stamped, end=end - 1) == []
    assert bw.read_hoptail(b"\x01\xff") == []
    assert bw.read_hoptail(b"") == []
    return [body, stamped]


def test_hoptail_append_and_read_roundtrip():
    _both(_append_read)


def _full_tail(pkg):
    bw = module(pkg, "protocol.binwire")
    tel = _tel(pkg)
    body = bw.encode_submit_columns(rand_cols_ops(random.Random(2), 2,
                                                  pkg=pkg))
    for i in range(0xFF):
        body = bw.append_hop(body, tel.HOP_SUBMIT, float(i))
    assert body[-1] == 0xFF
    assert bw.append_hop(body, tel.HOP_ADMIT, 1.0) == body
    assert len(bw.read_hoptail(body)) == 0xFF
    return [body]


def test_hoptail_full_tail_drops_stamp_not_frame():
    _both(_full_tail)


def _labels(pkg):
    obs = module(pkg, "obs")
    reg = obs.MetricsRegistry()
    reg.inc("net.ingress.frames", 3, tier="frontend")
    reg.inc("net.ingress.frames", 2, tier="gateway")
    reg.set_gauge("deli.queue.depth", 7, doc="d1")
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.observe("obs.hop.ms", v, pair="submit_to_admit")
    scrape = reg.scrape()
    series = obs.parse_prometheus(scrape)
    frames = series["fluid_net_ingress_frames"]
    assert frames[(("tier", "frontend"),)] == 3
    assert frames[(("tier", "gateway"),)] == 2
    assert series["fluid_deli_queue_depth"][(("doc", "d1"),)] == 7
    cnt = series["fluid_obs_hop_ms_count"]
    assert cnt[(("pair", "submit_to_admit"),)] == 4
    assert series["fluid_obs_hop_ms_sum"][(("pair", "submit_to_admit"),)] \
        == 10.0
    assert series["fluid_obs_series_dropped"][()] == 0
    with pytest.raises(ValueError) as err:
        obs.parse_prometheus("not a metric line at all")
    return [scrape, series, str(err.value)]


def test_registry_labels_and_prometheus_roundtrip():
    _both(_labels)


def _cardinality(pkg):
    obs = module(pkg, "obs")
    reg = obs.MetricsRegistry(max_series=4)
    for i in range(10):
        reg.inc("front.conns.opened", tenant=f"t{i}")
    scrape = reg.scrape()
    series = obs.parse_prometheus(scrape)
    conns = series["fluid_front_conns_opened"]
    assert len(conns) == 5
    assert conns[(("overflow", "true"),)] == 6
    assert series["fluid_obs_series_dropped"][()] == 6
    return [scrape, series]


def test_registry_cardinality_is_bounded():
    _both(_cardinality)


def _tier_counters(pkg):
    obs = module(pkg, "obs")
    reg = obs.MetricsRegistry()
    a, b = _tel(pkg).Counters(), _tel(pkg).Counters()
    reg.register_tier("deli", a)
    reg.register_tier("deli", b)
    a.inc("deli.boxcars.ticketed", 5)
    b.inc("deli.boxcars.ticketed", 7)
    a.observe("deli.ticket.ms", 2.0)
    scrape = reg.scrape()
    series = obs.parse_prometheus(scrape)
    assert series["fluid_deli_boxcars_ticketed"][(("tier", "deli"),)] == 12
    assert series["fluid_deli_ticket_ms_count"][(("tier", "deli"),)] == 1
    return [scrape, series]


def test_tier_counters_aggregate_into_scrape():
    _both(_tier_counters)


WALL_CLOCK = ("ts",)


def _flight(pkg, tmp_path):
    obs = module(pkg, "obs")
    dump_dir = tmp_path / pkg
    dump_dir.mkdir()
    rec = obs.FlightRecorder(dump_dir=str(dump_dir), event_ring=8,
                             frame_ring=4, max_conns=2)
    for i in range(20):
        rec.event("deli", "ticket", seq=i)
    for i in range(10):
        rec.frame("conn-a", "in", b"\x01\x05" + bytes([i]) * 20)
    rec.frame("conn-b", "out", b"\x01\x07")
    rec.frame("conn-c", "in", b"\x01\x05")
    path = rec.dump("unit_test", detail="why")
    assert rec.last_dump == path
    lines = [json.loads(x) for x in open(path, encoding="utf-8")]
    header, rest = lines[0], lines[1:]
    assert header["flight"] == "unit_test" and header["detail"] == "why"
    events = [x for x in rest if x["kind"] == "event"]
    frames = [x for x in rest if x["kind"] == "frame"]
    assert [e["seq"] for e in events] == list(range(12, 20))
    conns = {f["conn"] for f in frames}
    assert conns == {"conn-b", "conn-c"}
    assert all(len(f["head"]) <= 24 for f in frames)
    assert rec.dump("again") != path
    return [{k: v for k, v in line.items() if k not in WALL_CLOCK}
            for line in lines]


def test_flight_recorder_rings_and_dump(tmp_path):
    _both(_flight, tmp_path)


@pytest.fixture
def front_end():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    yield fe
    fe.stop()


def test_sampled_hops_survive_fanout_cache_verbatim(front_end):
    ops = rand_cols_ops(random.Random(27), 6)
    body = binwire.encode_submit_columns(ops)
    t_submit = time.time()
    body = binwire.append_hop(body, HOP_SUBMIT, t_submit)
    s1, read1 = bin_client(front_end.port, "doc-hops")
    s2, read2 = bin_client(front_end.port, "doc-hops")
    s1.sendall(binwire.frame(body))
    b1, b2 = next_cols(read1), next_cols(read2)
    assert b1 == b2
    assert struct.pack(">Bd", HOP_SUBMIT, t_submit) in b1
    hops = binwire.read_hoptail(b1)
    assert [h for h, _ in hops] == [HOP_SUBMIT, HOP_ADMIT, HOP_DELI,
                                    HOP_FANOUT]
    assert hops[0][1] == t_submit
    ts = [t for _, t in hops]
    assert ts == sorted(ts)
    series = parse_prometheus(get_registry().scrape())
    pairs = {dict(k).get("pair")
             for k in series.get("fluid_obs_hop_ms_count", {})}
    assert {"submit_to_admit", "admit_to_deli",
            "deli_to_fanout"} <= pairs
    snap = front_end.counters.snapshot
    assert wait_for(lambda: snap().get("net.fanout.cache_hits", 0) >= 1)
    s1.close()
    s2.close()


def test_aggregator_breakdown_identical_rec_vs_cols(front_end):
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    conn = factory.create_document_service(
        "t", "doc-rec").connect_to_delta_stream()
    acked = []
    conn.on_op = lambda m: (m.client_id == conn.client_id
                            and acked.append(m))
    conn.submit([DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=MessageType.OPERATION, contents={"free": "form"},
        traces=[TraceHop("client", "submit", time.time())])])
    assert wait_for(lambda: acked)
    agg_rec = TraceAggregator()
    agg_rec.record(acked[0], ack_time=time.time())
    conn.close()
    body = binwire.encode_submit_columns(rand_cols_ops(random.Random(3), 4))
    body = binwire.append_hop(body, HOP_SUBMIT, time.time())
    s, read = bin_client(front_end.port, "doc-cols2")
    s.sendall(binwire.frame(body))
    f = next_cols(read)
    s.close()
    agg_cols = TraceAggregator()
    agg_cols.record_hops(binwire.read_hoptail(f), ack_time=time.time())
    rep_rec, rep_cols = agg_rec.report(), agg_cols.report()
    assert set(rep_rec) == set(rep_cols) == {
        "submit_to_admit", "admit_to_deli", "deli_to_fanout",
        "fanout_to_ack"}
    assert all(rep_rec[k]["count"] == rep_cols[k]["count"] == 1
               for k in rep_rec)


def _repeat(pkg):
    tel = _tel(pkg)
    pairs = dict(tel.hop_pairs([(tel.HOP_SUBMIT, 1.0),
                                (tel.HOP_SUBMIT, 2.0),
                                (tel.HOP_DELI, 5.0)]))
    assert pairs == {"submit_to_deli": 3000.0}
    return pairs


def test_hop_pairs_keeps_last_ts_on_repeat():
    _both(_repeat)
    assert dict(hop_pairs([(HOP_SUBMIT, 1.0), (HOP_DELI, 2.0)])) == \
        {"submit_to_deli": 1000.0}
