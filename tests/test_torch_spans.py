"""The port's in-process span recorder (``utils/telemetry.SPANS``): off it
records nothing and reads no clock; on (while a profiler runs) it names
every layer of the ordering pipeline and the replica farm's waves, one
request id a boxcar, on the clock the profiler's trace is shifted onto;
and the benchmark's readers of it."""

from __future__ import annotations

import json
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from fluidframework_tpu_torch.service import gpu_applier
from fluidframework_tpu_torch.service.array_batch import ArrayBoxcar
from fluidframework_tpu_torch.service.broadcaster import PubSub
from fluidframework_tpu_torch.service.gpu_applier import GpuDocumentApplier
from fluidframework_tpu_torch.service.load_gen import wire_applier
from fluidframework_tpu_torch.service.local_log import LocalLog
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.scriptorium import channel_stream
from fluidframework_tpu_torch.service.synthetic import (
    CHANNEL_ID,
    DS_ID,
    SyntheticEditor,
)
from fluidframework_tpu_torch.utils import telemetry
from fluidframework_tpu_torch.utils.telemetry import SPANS, SpanRecorder

TENANT = "t"
DOCS = ["d0", "d1", "d2"]
CLIENTS = 3
ROUNDS = 4
BOXCAR = 6
PIPELINE = ("server.submit", "deli", "scriptorium", "scribe",
            "broadcaster", "session")


@pytest.fixture
def recorder():
    SPANS.reset()
    yield SPANS
    SPANS.reset()


def traced():
    """Tracing on: a CPU profiler session."""
    return profile(activities=[ProfilerActivity.CPU])


class Service:
    """A LocalServer, a CPU farm on every doc's broadcast and
    ``CLIENTS`` sessions a doc, each with a synthetic editor."""

    def __init__(self):
        self.server = server = LocalServer()
        self.app = app = GpuDocumentApplier(
            device="cpu", max_docs=4, max_slots=1024, ops_per_dispatch=8)
        app.set_replay_source(lambda t, d: channel_stream(
            server, t, d, DS_ID, CHANNEL_ID))
        wire_applier(server, app, TENANT, DOCS)
        rng = random.Random(7)
        self.sessions = []
        for doc in DOCS:
            for _ in range(CLIENTS):
                conn = server.connect(TENANT, doc)
                editor = SyntheticEditor(rng)

                def on_abatch(batch, editor=editor, me=conn.client_id):
                    if batch.boxcar.client_id == me:
                        editor.ref_seq = batch.last_seq
                    else:
                        editor.observe_abatch(batch)
                conn.on_abatch = on_abatch
                self.sessions.append((conn, editor))

    def run(self, rounds: int = ROUNDS) -> int:
        """Submit ``rounds`` boxcars a session, flush and drain the
        farm; returns the boxcars submitted."""
        boxcars = 0
        for _ in range(rounds):
            for conn, editor in self.sessions:
                conn.submit_array(editor.next_boxcar(
                    BOXCAR, TENANT, conn.document_id, conn.client_id))
                boxcars += 1
        self.app.flush()
        self.app.finalize()
        return boxcars


def _calls(snap: dict, name: str) -> int:
    return snap["spans"].get(name, {}).get("calls", 0)


def _seconds(snap: dict, *names: str) -> float:
    return sum(snap["spans"].get(n, {}).get("seconds", 0.0) for n in names)


def test_off_records_nothing_and_reads_no_clock(recorder, monkeypatch):
    svc = Service()

    class NoClock:
        def perf_counter(self):
            raise AssertionError("a span site read the clock while off")

    def no_frame(*args):
        raise AssertionError("a span site began a span while off")

    monkeypatch.setattr(telemetry, "time", NoClock())
    monkeypatch.setattr(telemetry.SPANS, "begin", no_frame)
    assert not telemetry.tracing()
    assert svc.run() == len(DOCS) * CLIENTS * ROUNDS
    snap = recorder.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["rows"] == 0


@pytest.mark.parametrize("switch", ["profiler", "autograd_profiler"])
def test_on_through_an_active_profiler(recorder, switch):
    svc = Service()
    session = (traced() if switch == "profiler"
               else autograd_profiler.profile())
    with session:
        assert telemetry.tracing()
        boxcars = svc.run(1)
    assert not telemetry.tracing()
    snap = recorder.snapshot()
    assert _calls(snap, "server.submit") == boxcars
    assert {"deli", "applier.take", "applier.stage",
            "applier.execute"} <= set(snap["spans"])
    # nothing more once it is off again
    svc.run(1)
    assert recorder.snapshot() == snap


def test_the_drain_seam_names_each_lambda(recorder):
    server = LocalServer()
    server.connect(TENANT, "d0")
    orderer = server._orderers[f"{TENANT}/d0"]
    names = {recorder._names[span]
             for subs in (server.log._subs[orderer.raw_topic],
                          server.log._subs[orderer.deltas_topic])
             for _handler, _pos, span in subs}
    assert names == {"deli", "scriptorium", "scribe", "broadcaster"}
    # any other subscriber runs without a span
    log = LocalLog()
    seen = []
    log.subscribe("topic", seen.append)
    assert log._subs["topic"][0][2] is None
    log.append("topic", 1)
    log.append("topic", 2)
    with traced():
        log.drain()
        log.append("topic", 3)
        assert log.step("topic")
    assert [m.value for m in seen] == [1, 2, 3]
    assert recorder.snapshot()["rows"] == 0


def test_a_publish_keeps_one_session_row(recorder):
    """The sessions' callbacks of a publish share one ``session`` row,
    paused around the other callbacks: a span those begin is not the
    session's child."""
    other = recorder.name_id("test.other")

    class Session:
        SPAN = "session"

        def __init__(self):
            self.got = []

        def deliver(self, value):
            self.got.append(value)

    def plain(value):
        recorder.end(recorder.begin(other))

    sessions = [Session() for _ in range(3)]
    pubsub = PubSub()
    pubsub.subscribe("topic", sessions[0].deliver)
    pubsub.subscribe("topic", plain)
    pubsub.subscribe("topic", sessions[1].deliver)
    pubsub.subscribe("topic", sessions[2].deliver)
    with traced():
        pubsub.publish("topic", 1)
    pubsub.unsubscribe("topic", plain)
    with traced():
        pubsub.publish("topic", 2)
    assert [s.got for s in sessions] == [[1, 2]] * 3
    snap = recorder.snapshot()
    assert _calls(snap, "session") == 6 and _calls(snap, "test.other") == 1
    rows = recorder.rows()
    names = [rows["names"][n] for n in rows["name"]]
    assert names.count("session") == 2
    assert rows["parent"][names.index("test.other")] == 0


def test_a_traced_server_and_farm(recorder):
    svc = Service()
    with traced():
        boxcars = svc.run()
    snap = recorder.snapshot()
    for name in ("server.submit", "deli", "scriptorium", "scribe",
                 "broadcaster", "applier.ingest"):
        assert _calls(snap, name) == boxcars, name
    assert _calls(snap, "session") == CLIENTS * boxcars
    # children's totals are at most their parent's, and the pipeline's
    # parts add up to the submit
    submit = _seconds(snap, "server.submit")
    assert _seconds(snap, "deli", "scriptorium", "scribe",
                    "broadcaster") <= submit
    assert _seconds(snap, "session", "applier.ingest") <= _seconds(
        snap, "broadcaster")
    parts = (snap["spans"]["server.submit"]["self_seconds"]
             + _seconds(snap, "deli", "scriptorium", "scribe", "session",
                        "applier.ingest")
             + snap["spans"]["broadcaster"]["self_seconds"])
    assert parts == pytest.approx(submit, rel=1e-9)
    # every span a boxcar causes carries the boxcar's request id
    rows = recorder.rows()
    names = rows["names"]
    by_id = {int(i): k for k, i in enumerate(rows["id"])}

    def root(k):
        while rows["parent"][k]:
            k = by_id[int(rows["parent"][k])]
        return k

    submits = set()
    for k in range(len(rows["id"])):
        top = root(k)
        if names[rows["name"][top]] == "server.submit":
            assert rows["request"][k] == rows["request"][top]
            submits.add(int(rows["request"][top]))
    assert len(submits) == boxcars
    # a wave's take, stage and execute share a request id of their own
    waves = {}
    for k in range(len(rows["id"])):
        name = names[rows["name"][k]]
        if name in ("applier.take", "applier.stage", "applier.execute"):
            waves.setdefault(int(rows["request"][k]), []).append(name)
    assert waves and not set(waves) & submits
    assert all(sorted(v) == ["applier.execute", "applier.stage",
                             "applier.take"] for v in waves.values())
    # the farm's wave counters; the stage and execute spans are the
    # intervals of the farm's own timers
    counters = snap["counters"]
    assert set(counters) == {"applier.wave.rows", "applier.wave.slots",
                             "applier.ingest.deferred",
                             "applier.ingest.packed_rows",
                             "deli.array.fast"}
    # every boxcar was recorded by reference for the flush's pack
    assert counters["applier.ingest.deferred"] == boxcars
    # every boxcar was ticketed on deli's array fast lane
    assert counters["deli.array.fast"] == boxcars == sum(
        o.deli.boxcars_fast for o in svc.server._orderers.values())
    assert 0 < counters["applier.wave.rows"] <= counters["applier.wave.slots"]
    # every op of the array lane took the flush's columnar pack
    assert counters["applier.ingest.packed_rows"] == svc.app.ops_applied
    assert counters["applier.wave.slots"] == len(waves) * 4 * 8
    assert counters["applier.wave.rows"] == svc.app.ops_applied
    assert _seconds(snap, "applier.stage") == pytest.approx(
        svc.app.stage_seconds, rel=1e-9)
    assert _seconds(snap, "applier.execute") == pytest.approx(
        svc.app.exec_seconds, rel=1e-9)


def test_a_boxcar_keeps_its_pipeline_spans(recorder):
    """Traced, each flood-shaped boxcar records the pipeline's spans and
    the farm's ingest once, the sessions' one row standing for a call a
    session of its doc: seven rows a boxcar."""
    svc = Service()
    per_boxcar = dict.fromkeys(PIPELINE + ("applier.ingest",), 1)
    per_boxcar["session"] = CLIENTS
    with traced():
        for conn, editor in svc.sessions:
            before = recorder.snapshot()
            conn.submit_array(editor.next_boxcar(
                BOXCAR, TENANT, conn.document_id, conn.client_id))
            after = recorder.snapshot()
            assert set(after["spans"]) == set(per_boxcar)
            assert {name: _calls(after, name) - _calls(before, name)
                    for name in after["spans"]} == per_boxcar
            assert after["rows"] - before["rows"] == len(per_boxcar)
            assert after["counters"]["deli.array.fast"] - before[
                "counters"].get("deli.array.fast", 0) == 1
    svc.app.finalize()


def _two_key_boxcar(conn, editor) -> ArrayBoxcar:
    """An insert and an annotate with two keys: the farm hands the
    boxcar to the dict lane, which stages its rows op by op."""
    base = editor.client_seq
    editor.client_seq = base + 2
    return ArrayBoxcar(
        tenant_id=TENANT, document_id=conn.document_id,
        client_id=conn.client_id, ds_id=DS_ID, channel_id=CHANNEL_ID,
        kind=np.array([0, 2], np.int8), a=np.array([0, 0], np.int32),
        b=np.array([0, 1], np.int32),
        cseq=np.arange(base + 1, base + 3, dtype=np.int32),
        rseq=np.full(2, editor.ref_seq, np.int32), text="ab",
        text_off=np.array([0, 2, 2], np.int32),
        props=[None, {"a": 1, "b": 2}])


class _Run:
    """What a metric reader reads of a run here: the acked ops."""

    def __init__(self, acked: int):
        self.counts = {"acked_ops": acked}


def _reader(name: str):
    from portbench import spec
    from portbench.tests.conftest import REPO

    return spec.reader(REPO, name)


@pytest.mark.parametrize("mixed", [False, True])
def test_the_pack_span_and_ingest_counters(recorder, mixed):
    """``applier.pack`` and the ingest counters are recorded only while
    tracing; ``packed_share`` reads 100 on a flood stream and below 100
    once a boxcar takes the dict lane. Every array boxcar, the two-key
    one included, is recorded by reference (``applier.ingest.deferred``)
    and leaves the record at the flush."""
    svc = Service()
    conn, editor = svc.sessions[0]

    def run():
        """A boxcar a session, then (mixed) the two-key boxcar, whose
        doc has boxcars recorded; flush and drain."""
        boxcars = 0
        for conn_, editor_ in svc.sessions:
            conn_.submit_array(editor_.next_boxcar(
                BOXCAR, TENANT, conn_.document_id, conn_.client_id))
            boxcars += 1
        if mixed:
            conn.submit_array(_two_key_boxcar(conn, editor))
        svc.app.flush()
        svc.app.finalize()
        return boxcars

    run()
    assert recorder.snapshot()["spans"] == {}
    assert recorder.snapshot()["counters"] == {}
    assert _reader("packed_share.flood").read(_Run(1)) is None
    assert _reader("pack_us_per_op.flood").read(_Run(1)) is None
    applied = svc.app.ops_applied
    with traced():
        boxcars = run()
    snap = recorder.snapshot()
    counters = snap["counters"]
    rows = svc.app.ops_applied - applied
    # one pass, at the flush; the two-key boxcar takes the dict lane
    # there, at its place in its doc's order
    assert _calls(snap, "applier.pack") == 1
    assert counters["applier.ingest.deferred"] == boxcars + mixed
    assert counters["applier.ingest.packed_rows"] + counters.get(
        "applier.ingest.direct_rows", 0) == rows
    assert counters["applier.ingest.packed_rows"] == BOXCAR * boxcars
    share = _reader("packed_share.flood").read(_Run(rows))
    pack_us = _reader("pack_us_per_op.flood").read(_Run(rows))
    assert pack_us > 0
    if mixed:
        # the insert, and the annotate once a key
        assert counters["applier.ingest.direct_rows"] == 3
        assert share == pytest.approx(100.0 * (rows - 3) / rows)
        assert share < 100
    else:
        assert "applier.ingest.direct_rows" not in counters
        assert share == 100.0


def test_off_the_pack_costs_one_tracing_check_a_flush(recorder,
                                                      monkeypatch):
    """Off, the pass reads ``tracing()`` once a flush; ingest reads it
    once a boxcar, as before."""
    svc = Service()
    checks = []

    def counted():
        checks.append(1)
        return False

    packs = []
    pack = svc.app._pack

    def counted_pack():
        packs.append(len(checks))
        pack()
        packs.append(len(checks))

    monkeypatch.setattr(svc.app, "_pack", counted_pack)
    monkeypatch.setattr(gpu_applier, "tracing", counted)
    boxcars = 0
    for conn, editor in svc.sessions:
        conn.submit_array(editor.next_boxcar(
            BOXCAR, TENANT, conn.document_id, conn.client_id))
        boxcars += 1
    assert len(checks) == boxcars  # the ingest span's check
    svc.app.flush()
    assert len(packs) == 2 and packs[1] - packs[0] == 1
    svc.app.finalize()
    assert len(packs) == 2  # nothing left recorded: no second pass
    assert recorder.snapshot()["rows"] == 0


def test_the_spans_share_the_profilers_clock(recorder):
    """A wave's ``applier.execute`` profiler event, put on perf_counter by
    a marker as the benchmark's trace reader does, starts where the
    recorder's span does."""
    svc = Service()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the first scope a profiler opens pays its set-up after the
        # event's stamp: open one before the marker
        with record_function("spans.warm"):
            pass
        with record_function("spans.marker"):
            marker_perf = time.perf_counter()
        svc.run(1)
    events = prof.events()
    marker = next(e for e in events if e.name == "spans.marker")
    shift = marker_perf - marker.time_range.start / 1e6
    executes = sorted(e.time_range.start / 1e6 + shift for e in events
                      if e.name == "applier.execute")
    starts, _ends = recorder.arrays()["applier.execute"]
    assert len(executes) == len(starts) > 0
    for got, want in zip(executes, starts):
        assert abs(got - want) < 1e-3
    names = {e.name for e in events}
    assert {"applier.unpack", "applier.apply", "applier.compact"} <= names


def test_export_chrome_trace(recorder, tmp_path):
    svc = Service()
    with traced():
        svc.run(1)
    path = tmp_path / "spans.json"
    n = recorder.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert n == len(events) == recorder.snapshot()["rows"] > 0
    assert {e["ph"] for e in events} == {"X"}
    assert {e["name"] for e in events} >= set(PIPELINE)
    assert all(e["dur"] >= 0 for e in events)


def test_rows_are_bounded_and_totals_go_on():
    rec = SpanRecorder(capacity=2)
    name = rec.name_id("x")
    for _ in range(5):
        rec.end(rec.begin(name))
    snap = rec.snapshot()
    assert snap["rows"] == 2 and snap["dropped"] == 3
    assert snap["spans"]["x"]["calls"] == 5
    # a span begun directly inside one of the same name is folded in
    outer = rec.begin(name)
    assert rec.begin(name) is None
    rec.end(outer)
    assert rec.snapshot()["spans"]["x"]["calls"] == 6


def test_threads_keep_their_own_totals():
    """Many threads record one name while new names are registered: no
    call is lost (each thread's totals are its own)."""
    rec = SpanRecorder()
    shared = rec.name_id("shared")
    threads, pairs = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            own = rec.name_id(f"own{k}")
            for _ in range(pairs):
                rec.end(rec.begin(shared))
                rec.end(rec.begin(own))
        workers = [threading.Thread(target=work, args=(k,))
                   for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    snap = rec.snapshot()
    assert snap["spans"]["shared"]["calls"] == threads * pairs
    assert all(snap["spans"][f"own{k}"]["calls"] == pairs
               for k in range(threads))
    assert snap["rows"] == 2 * threads * pairs == len(rec.rows()["id"])
    assert len(set(rec.rows()["tid"])) == threads


# ------------------------------------------------ the benchmark's readers

READERS = ("entry_us_per_op.flood", "deli_us_per_op.flood",
           "store_us_per_op.flood", "fanout_us_per_op.flood",
           "sessions_us_per_op.flood", "assemble_us_per_op.flood",
           "launch_us_per_op.flood", "card_wait_us_per_op.flood",
           "wave_fill.flood", "pack_us_per_op.flood",
           "packed_share.flood", "deli_fast_share.flood")


@pytest.fixture
def tiny_bench(tmp_path):
    from portbench.tests.conftest import copy_benchmark, shrink

    root = copy_benchmark(tmp_path)
    shrink(root)
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield root
    torch.set_num_threads(before)


@pytest.mark.parametrize("profiled", [True, False])
def test_the_benchmarks_span_readers(recorder, tiny_bench, profiled,
                                     monkeypatch):
    """A traced run of the flood on the CPU, with a CPU profiler around
    its window as a traced run on the card has: the nine readers read
    numbers, and the pipeline's parts add up to ``server.submit``. With
    no profiler the recorder stays off and every reader is silent."""
    from portbench import run, spec

    # this test process has JAX loaded (tests/conftest.py); the run's own
    # check that the program loads none is the benchmark's tests' to make
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    if profiled:
        load_driver = spec.driver

        def driver(root, name):
            base = load_driver(root, name).Driver

            class Driver(base):
                def window(self, seconds):
                    with profile(activities=[ProfilerActivity.CPU]):
                        super().window(seconds)
            return type("Module", (), {"Driver": Driver})

        monkeypatch.setattr(spec, "driver", driver)
    out = run.run_cell(tiny_bench, "loadtest_1k.flood", 2**33 + 5, 1.0,
                       True, device="cpu")
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if not profiled:
        assert not set(READERS) & set(got)
        return
    assert set(READERS) <= set(got)
    assert all(isinstance(got[k], float) for k in READERS)
    assert 0 < got["wave_fill.flood"] <= 100
    assert got["packed_share.flood"] == 100.0
    assert got["deli_fast_share.flood"] == 100.0
    snap = recorder.snapshot()
    acked = out["attempted"] - out["failed"]
    parts = sum(got[k] for k in READERS[:5]) * acked / 1e6 + _seconds(
        snap, "applier.ingest")
    assert parts == pytest.approx(_seconds(snap, "server.submit"), rel=0.01)
