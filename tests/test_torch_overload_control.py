"""Overload-control twin: the port's windowed series, SLO engine
(``obs/slo.py``), admission gate (``service/admission.py``) and the
driver's shed-retry lane against the JAX package's, on the CPU.

Each case of ``tests/test_overload_control.py`` runs the same inputs
through both packages: the case's own assertions hold on the port, and
every value it reads (window counts and samples, quantiles, SLO states
and status rows under a frozen clock, bucket waits and debts, shed
counters) must equal the JAX package's exactly. The end-to-end shed
case drives each package's front end on a background thread with its
own driver, on both wire lanes.
"""

import time
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]
    return SimpleNamespace(
        metrics=import_module(f"{root}.obs.metrics"),
        slo=import_module(f"{root}.obs.slo"),
        obs=import_module(f"{root}.obs"),
        adm=import_module(f"{root}.service.admission"))


PKGS = {name: _pkg(name) for name in ROOTS}
PORT, JAX = PKGS["torch"], PKGS["jax"]


def _both(case):
    """Run ``case(P)`` on both packages; the port's result must equal
    the JAX package's. Returns the port's."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


def wait_for(pred, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


# ------------------------------------------------------ windowed series


def test_windowed_series_rotation_and_expiry():
    def case(P):
        ws = P.metrics.WindowedSeries(window_s=10.0, buckets=10)
        ws.observe(1.0, now=100.0)
        ws.observe(2.0, now=100.5)
        ws.observe(3.0, now=105.0)
        out = [ws.stats(now=105.0), ws.stats(now=111.0)]
        ws.observe(9.0, now=110.0)  # epoch 110 -> slot 0, was epoch 100
        out += [ws.stats(now=110.9), ws.stats(now=110.9, window_s=1.0)]
        return [(c, sorted(m)) for c, m in out]

    assert _both(case) == [(3, [1.0, 2.0, 3.0]), (1, [3.0]),
                           (2, [3.0, 9.0]), (1, [9.0])]


def test_windowed_series_reservoir_keeps_true_count():
    def case(P):
        ws = P.metrics.WindowedSeries(window_s=10.0, buckets=10,
                                      max_per_bucket=16)
        for i in range(1000):
            ws.observe(float(i), now=200.0)
        return ws.stats(now=200.0)

    count, merged = _both(case)
    assert count == 1000 and len(merged) == 16
    assert max(merged) > 15.0


def test_windowed_quantile_empty_is_zero():
    assert _both(lambda P: P.metrics.WindowedSeries().quantile(
        0.99, now=5.0)) == 0.0


def test_window_stats_label_subset_merges_tenants():
    def case(P):
        reg = P.metrics.MetricsRegistry()
        for v, labels in ((5.0, {"tenant": "a"}), (7.0, {"tenant": "b"})):
            reg.observe_windowed("obs.hop.window_ms", v, now=50.0,
                                 pair="submit_to_admit", **labels)
        reg.observe_windowed("obs.hop.window_ms", 9.0, now=50.0,
                             pair="admit_to_deli")
        pair = reg.window_stats("obs.hop.window_ms", now=50.0,
                                pair="submit_to_admit")
        one = reg.window_stats("obs.hop.window_ms", now=50.0,
                               pair="submit_to_admit", tenant="a")
        series = P.metrics.parse_prometheus(reg.scrape())
        return pair, one, series["fluid_obs_hop_window_ms_count"], \
            reg.scrape()

    (count, q), (count_a, q_a), counts, _ = _both(case)
    assert count == 2 and q[0.99] == 7.0
    assert count_a == 1 and q_a[0.99] == 5.0
    assert (("pair", "submit_to_admit"), ("tenant", "a")) in counts


def test_series_reservoir_admits_late_samples():
    def case(P):
        s = P.metrics._Series()
        for _ in range(4096):
            s.add(0.0)
        for _ in range(4096):
            s.add(1.0)
        return s.count, list(s.samples)

    count, samples = _both(case)
    assert count == 8192 and len(samples) == 4096
    assert 1000 < sum(1 for v in samples if v == 1.0) < 3000


# -------------------------------------------------- prometheus escaping


def test_prometheus_hostile_label_roundtrip():
    evil = 'ten"ant\\with\nnewline'

    def case(P):
        reg = P.metrics.MetricsRegistry()
        reg.inc("net.admission.shed", 4, tenant=evil, reason="rate")
        text = reg.scrape()
        return text, P.metrics.parse_prometheus(text)

    text, series = _both(case)
    assert "\n\n" not in text
    key = (("reason", "rate"), ("tenant", evil))
    assert series["fluid_net_admission_shed"][key] == 4


# ------------------------------------------------------------ slo specs


def test_parse_slo_spec_forms():
    def case(P):
        s = P.slo.parse_slo_spec("ingest=submit_to_admit:25:5:3")
        t = P.slo.parse_slo_spec("vip=submit_to_admit@acme:10")
        errors = []
        for bad in ("noequals", "a=pair", "a=pair:NaNish:x"):
            with pytest.raises(ValueError) as err:
                P.slo.parse_slo_spec(bad)
            errors.append(str(err.value))
        fields = ("name", "pair", "p99_budget_ms", "tenant", "window_s",
                  "burn_ticks", "min_count")
        return ([getattr(s, f) for f in fields],
                [getattr(t, f) for f in fields], errors)

    s, t, _ = _both(case)
    assert s[:3] + s[4:6] == ["ingest", "submit_to_admit", 25.0, 5.0, 3]
    assert s[3] is None
    assert t[3] == "acme" and t[4] == 10.0 and t[5] == 2


def test_slo_state_machine_frozen_clock(tmp_path):
    """ok -> warn -> violated -> ok under one frozen clock: every state,
    status row, gauge, violation count and the dump's header equal the
    JAX engine's tick by tick."""
    import json

    def case(P):
        reg = P.metrics.MetricsRegistry()
        rec = P.obs.FlightRecorder(dump_dir=str(tmp_path / P.slo.__name__))
        spec = P.slo.SloSpec(name="ingest", pair="submit_to_admit",
                             p99_budget_ms=10.0, window_s=10.0,
                             burn_ticks=2, min_count=2)
        eng = P.slo.SloEngine([spec], registry=reg, recorder=rec)
        ticks = []

        def tick(now):
            status = eng.evaluate(now=now)
            ticks.append((eng._state["ingest"], eng.shed_signal,
                          sorted(eng.violated_pairs), status))

        reg.observe_windowed("obs.hop.window_ms", 500.0, now=100.0,
                             pair="submit_to_admit")
        tick(100.0)
        reg.observe_windowed("obs.hop.window_ms", 400.0, now=100.2,
                             pair="submit_to_admit")
        for now in (100.5, 101.0, 101.5):
            tick(now)
        series = P.metrics.parse_prometheus(reg.scrape())
        with open(rec.last_dump, encoding="utf-8") as f:
            header = json.loads(f.readline())
        header.pop("ts", None)
        header.pop("pid", None)
        tick(112.0)
        return (ticks, series["fluid_obs_slo_violations"],
                series["fluid_obs_slo_state"], header["flight"])

    ticks, violations, gauge, flight = _both(case)
    states = [t[0] for t in ticks]
    assert states == [PORT.slo.STATE_OK, PORT.slo.STATE_WARN,
                      PORT.slo.STATE_VIOLATED, PORT.slo.STATE_VIOLATED,
                      PORT.slo.STATE_OK]
    assert [t[1] for t in ticks] == [False, False, True, True, False]
    assert ticks[2][2] == ["submit_to_admit"]
    assert violations[(("slo", "ingest"),)] == 1
    assert flight == "slo_violation"
    row = ticks[-1][3][0]
    assert row["state"] == "ok" and row["burn"] == 0
    # the gauge was read while violated
    assert gauge[(("slo", "ingest"),)] == 2


# --------------------------------------------------------- token bucket


def test_token_bucket_deterministic_refill():
    def case(P):
        b = P.adm.TokenBucket(rate=10.0, burst=20.0)
        out = [b.take(20, now=0.0), b.take(5, now=0.0), b.tokens,
               b.take(5, now=0.5), b.take(1, now=0.5)]
        b2 = P.adm.TokenBucket(rate=10.0, burst=20.0)
        return out + [b2.take(20, now=1000.0), b2.take(3, now=1000.2)]

    out = _both(case)
    assert out[:4] == [0.0, 0.5, 0.0, 0.0]
    assert out[4] == pytest.approx(0.1)
    assert out[5] == 0.0 and out[6] == pytest.approx(0.1)


def test_token_bucket_oversize_admits_when_full():
    def case(P):
        b = P.adm.TokenBucket(rate=100.0, burst=50.0)
        out = [b.take(500, now=0.0), b.tokens, b.take(1, now=1.0),
               b.take(1, now=5.0)]
        b3 = P.adm.TokenBucket(rate=100.0, burst=50.0)
        b3.take(20, now=0.0)
        return out + [b3.take(500, now=0.0)]

    out = _both(case)
    assert out[0] == 0.0 and out[1] == -450.0
    assert out[2] > 0.0 and out[3] == 0.0
    assert out[4] == pytest.approx(470 / 100.0)


def test_retry_after_clamp():
    def case(P):
        return ([P.adm.retry_after_ms(s) for s in (0.001, 0.4, 99.0)],
                P.adm.RETRY_AFTER_MIN_MS, P.adm.RETRY_AFTER_MAX_MS)

    got, lo, hi = _both(case)
    assert got == [lo, 400, hi]


# ------------------------------------------------- admission controller


def _conn(tenant):
    return SimpleNamespace(tenant_id=tenant)


def test_admission_soft_admit_vs_shed():
    def case(P):
        reg = P.metrics.MetricsRegistry()
        eng = SimpleNamespace(shed_signal=False)
        adm = P.adm.AdmissionController(lambda t: (100.0, 10.0),
                                        registry=reg)
        adm.engine = eng
        conn = _conn("acme")
        out = [adm.check(conn, 10, 1, now=0.0),
               adm.check(conn, 10, 11, now=0.0)]
        delayed = P.metrics.parse_prometheus(reg.scrape())[
            "fluid_net_admission_delayed"]
        eng.shed_signal = True
        out.append(adm.check(conn, 10, 21, now=0.0))
        shed = P.metrics.parse_prometheus(reg.scrape())[
            "fluid_net_admission_shed"]
        adm.shedding = False
        out.append(adm.check(_conn("acme"), 999, 1, now=100.0))
        return out, delayed, shed

    out, delayed, shed = _both(case)
    assert out[:2] == [0.0, 0.0] and out[2] > 0.0 and out[3] == 0.0
    assert delayed[(("tenant", "acme"),)] == 10
    assert shed[(("reason", "rate"), ("tenant", "acme"))] == 10


def test_admission_unlimited_tenant_never_gated():
    def case(P):
        adm = P.adm.AdmissionController(
            lambda t: None, registry=P.metrics.MetricsRegistry())
        adm.engine = SimpleNamespace(shed_signal=True)
        return adm.check(_conn("free"), 10 ** 6, 1, now=0.0)

    assert _both(case) == 0.0


def test_admission_ordering_watermark():
    def case(P):
        reg = P.metrics.MetricsRegistry()
        adm = P.adm.AdmissionController(lambda t: (100.0, 10.0),
                                        registry=reg)
        adm.engine = SimpleNamespace(shed_signal=True)
        conn = _conn("acme")
        out = [adm.check(conn, 10, 1, now=0.0),
               adm.check(conn, 5, 11, now=0.0), conn._shed_resume,
               adm.check(conn, 5, 16, now=50.0)]
        shed = P.metrics.parse_prometheus(reg.scrape())[
            "fluid_net_admission_shed"]
        out += [adm.check(conn, 10, 11, now=50.0), conn._shed_resume]
        return out, shed

    out, shed = _both(case)
    assert out[0] == 0.0 and out[1] > 0.0 and out[2] == 11
    assert out[3] > 0.0
    assert shed[(("reason", "ordering"), ("tenant", "acme"))] == 5
    assert out[4] == 0.0 and out[5] is None


# --------------------------------------------- shed/backoff end to end


def _shed_run(root: str, lane: str) -> dict:
    """One package's front end with a rated tenant, a hair-trigger SLO
    and that package's driver: prime, arm, overrun by 100 ops, and
    report what the client saw."""
    net = import_module(f"{root}.driver.network")
    msgs = import_module(f"{root}.protocol.messages")
    P = PKGS["torch" if root.endswith("_torch") else "jax"]
    NetworkFrontEnd = import_module(f"{root}.service.front_end") \
        .NetworkFrontEnd
    LocalServer = import_module(f"{root}.service.local_server").LocalServer
    tm = import_module(f"{root}.service.tenants").TenantManager()
    tm.set_rate("t", 50.0, burst=50.0)
    front = NetworkFrontEnd(LocalServer(tenants=tm)).start_background()
    engine = P.slo.SloEngine([P.slo.SloSpec(
        name="trigger", pair="submit_to_admit", p99_budget_ms=0.0,
        burn_ticks=1, min_count=1)])
    front.attach_slo(engine)
    assert front.admission.engine is engine and front.admission.shedding
    factory = net.NetworkDocumentServiceFactory("127.0.0.1", front.port)
    try:
        conn = factory.create_document_service(
            "t", f"shed-{lane}").connect_to_delta_stream()
        conn.trace_sample_n = 1
        acked, hard = {}, []
        conn.on_op = lambda m: (
            m.client_id == conn.client_id
            and acked.__setitem__(m.client_sequence_number, m))
        conn.on_nack = lambda m: hard.append(m)

        def op(cseq):
            if lane == "columnar":
                contents = {"kind": "chanop", "address": "default",
                            "contents": {"address": "text",
                                         "contents": {"type": 0, "pos": 0,
                                                      "text": "x"}}}
                traces = []
            else:
                contents = {"free": "form", "cseq": cseq}
                traces = [msgs.TraceHop("client", "submit", time.time())]
            return msgs.DocumentMessage(
                client_sequence_number=cseq, reference_sequence_number=0,
                type=msgs.MessageType.OPERATION, contents=contents,
                traces=traces)

        conn.submit([op(c) for c in (1, 2)])
        primed = wait_for(lambda: len(acked) == 2)
        engine.evaluate()
        armed = engine.shed_signal
        conn.submit([op(c) for c in range(3, 103)])
        snap = factory.counters.snapshot
        retried = wait_for(
            lambda: snap().get("driver.submit.shed_retries", 0) > 0)
        drained = wait_for(lambda: len(acked) == 102, timeout=30.0)
        shed = P.metrics.parse_prometheus(P.obs.get_registry().scrape()) \
            .get("fluid_net_admission_shed", {})
        conn.close()
        return {"primed": primed, "armed": armed, "retried": retried,
                "drained": drained, "hard": len(hard),
                "acked": sorted(acked), "op50": acked[50].contents,
                "shed": sum(v for k, v in shed.items()
                            if dict(k)["tenant"] == "t") > 0}
    finally:
        engine.stop()
        front.stop()


@pytest.mark.parametrize("lane", ["columnar", "rec"])
def test_shed_retry_contract_end_to_end(lane):
    """A rated tenant overruns its bucket during an armed SLO burn: the
    port's front end sheds, the port's driver backs off and resubmits,
    and every op is acked with its payload intact, as in the JAX
    package on the same script."""
    got = _shed_run(ROOTS["torch"], lane)
    assert got["primed"] and got["armed"] and got["retried"]
    assert got["drained"] and got["hard"] == 0 and got["shed"]
    assert got["acked"] == list(range(1, 103))
    if lane == "rec":
        assert got["op50"] == {"free": "form", "cseq": 50}
    else:
        assert got["op50"]["contents"]["address"] == "text"
    assert got == _shed_run(ROOTS["jax"], lane)


def _lane_conn(root: str):
    """One package's driver connection with its shed lane's state and no
    socket: ``sent`` records what a flush would put on the wire."""
    import threading

    net = import_module(f"{root}.driver.network")
    telemetry = import_module(f"{root}.utils.telemetry")
    conn = net.NetworkDeltaConnection.__new__(net.NetworkDeltaConnection)
    conn._coal_cv = threading.Condition()
    conn._coal_closed = conn._send_inflight = False
    conn._shed_ops, conn._pending_ops, conn._unresolved = [], [], set()
    conn._shed_deadline = conn._flush_deadline = None
    conn._shed_park_wall = conn._pending_shed_wall = None
    conn._stragglers = set()
    conn._t = SimpleNamespace(_pending_cv=threading.Condition())
    conn._disc_fired, conn.on_disconnect = False, None
    conn._ensure_flusher = lambda: None
    conn.counters = telemetry.Counters()
    conn.sent = []
    conn._send_ops = lambda ops: conn.sent.append(
        [op.client_sequence_number for op in ops])
    return conn


def _ops(root: str, cseqs) -> list:
    msgs = import_module(f"{root}.protocol.messages")
    return [msgs.DocumentMessage(
        client_sequence_number=c, reference_sequence_number=0,
        type=msgs.MessageType.OPERATION, contents=None) for c in cseqs]


def _parked_order(root: str, arrivals: list) -> list:
    """The clientSeqs one package's driver holds in its shed lane after
    shed nacks arrive in ``arrivals`` order."""
    conn = _lane_conn(root)
    for op in _ops(root, arrivals):
        conn._queue_shed_retry(op, 50)
    assert conn.counters.snapshot()["driver.submit.shed_retries"] \
        == len(arrivals)
    return [op.client_sequence_number for op in conn._shed_ops]


def test_shed_lane_keeps_clientseq_order():
    """A resubmitted prefix shed again lands its nacks after the tail of
    the first nack wave (801..820 parked, then 781..800 re-shed): the
    port's driver keeps the lane in clientSeq order, so the next
    resubmit leads with the server's resume watermark. The JAX driver
    appends in arrival order, and its next resubmit, led by 801, is
    shed for ordering on every retry (the noisy scenario's wedge)."""
    arrivals = list(range(801, 821)) + list(range(781, 801))
    assert _parked_order(ROOTS["torch"], arrivals) == list(range(781, 821))
    assert _parked_order(ROOTS["jax"], arrivals) == arrivals


def _resubmits(root: str, lane, unresolved, pending) -> list:
    """What one flush of a package's driver sends, from a shed lane with
    its backoff run out, ``unresolved`` ops still on the wire and newer
    ``pending`` ones."""
    conn = _lane_conn(root)
    conn._shed_ops, conn._pending_ops = _ops(root, lane), _ops(root, pending)
    conn._unresolved = set(unresolved)
    conn._send_inflight = True
    conn._drain_and_send()
    return conn.sent


def test_shed_resubmit_never_skips_an_unresolved_op():
    """The backoff ran out mid-nack-wave: 801..820's shed nacks are still
    on the way. The port's driver resubmits only the run without a gap
    (781..800) and holds the rest; the JAX driver sends one boxcar with
    the gap, and deli nacks every op past it for good (the card's
    overload phase lost 360 ops of one flood client to it). A lane whose
    first op is past an unresolved one waits."""
    lane = list(range(781, 801)) + list(range(821, 841))
    unresolved, pending = range(801, 821), range(841, 851)
    assert _resubmits(ROOTS["torch"], lane, unresolved, pending) \
        == [list(range(781, 801))]
    assert _resubmits(ROOTS["jax"], lane, unresolved, pending) \
        == [lane + list(pending)]
    assert _resubmits(ROOTS["torch"], range(821, 841), range(781, 801),
                      pending) == []
    # once the gap is parked, the whole run and the pending ops go
    assert _resubmits(ROOTS["torch"], range(781, 841), (), pending) \
        == [list(range(781, 851))]


def test_new_ops_wait_for_a_resubmits_stragglers():
    """The resubmit of 361..420 went out while 421..440's shed nacks were
    on the way; if the server admits it, its resume watermark is gone,
    and a newer boxcar sent now would reach deli before 421 (the card's
    second loss). The port's driver holds the newer ops until 421..440
    are resolved; the JAX driver sends them."""
    got = {}
    for pkg, root in ROOTS.items():
        conn = _lane_conn(root)
        conn._shed_ops = _ops(root, range(361, 421))
        conn._unresolved = set(range(421, 441))
        conn._send_inflight = True
        conn._drain_and_send()
        conn._pending_ops = _ops(root, range(441, 501))
        conn._send_inflight = True
        conn._drain_and_send()
        got[pkg] = conn.sent
        if pkg == "torch":
            # the resubmit is acked and the stragglers come back shed:
            # then one run, in order
            conn._unresolved -= set(range(361, 421))
            for op in _ops(root, range(421, 441)):
                conn._queue_shed_retry(op, 50)
            conn._shed_deadline = None
            conn._send_inflight = True
            conn._drain_and_send()
    assert got["torch"] == [list(range(361, 421)), list(range(421, 501))]
    assert got["jax"] == [list(range(361, 421)), list(range(441, 501))]



def test_shed_lane_holds_until_resolved_or_disconnected(monkeypatch):
    """The port's lane has no time limit on its hold: an hour on, a lane
    behind an unresolved op still sends nothing, and newer ops still wait
    for a resubmit's stragglers (resubmitting past them is the loss the
    hold repairs). A dropped connection resolves every op, since no ack
    or nack comes on it and the reconnect resubmits: the lane then goes
    out in one run."""
    root = ROOTS["torch"]
    net = import_module(f"{root}.driver.network")
    clock = [time.monotonic()]
    monkeypatch.setattr(net.time, "monotonic", lambda: clock[0])

    conn = _lane_conn(root)
    conn._shed_ops = _ops(root, range(821, 841))
    conn._unresolved = set(range(801, 821))
    for _ in range(2):
        conn._send_inflight = True
        conn._drain_and_send()
        clock[0] += 3600.0
    assert conn.sent == []
    conn._fire_disconnect("connection lost")
    assert conn._unresolved == set()
    conn._send_inflight = True
    conn._drain_and_send()
    assert conn.sent == [list(range(821, 841))]

    conn = _lane_conn(root)
    conn._shed_ops = _ops(root, range(361, 421))
    conn._unresolved = set(range(421, 441))
    conn._send_inflight = True
    conn._drain_and_send()
    conn._pending_ops = _ops(root, range(441, 461))
    for _ in range(2):
        clock[0] += 3600.0
        conn._send_inflight = True
        conn._drain_and_send()
    assert conn.sent == [list(range(361, 421))]
    conn._fire_disconnect("connection lost")
    conn._send_inflight = True
    conn._drain_and_send()
    assert conn.sent == [list(range(361, 421)), list(range(441, 461))]
