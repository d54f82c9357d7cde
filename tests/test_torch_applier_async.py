"""The async, overlap-staged GpuDocumentApplier(device="cpu") against the
JAX TpuDocumentApplier on the CPU backend.

Both appliers take the same seeded streams: opgen-derived wire streams
over several docs, and the two-client sessions of
test_pallas_apply.py::_fuzz_session. Texts, properties, ``ops_applied``,
``dispatches`` and ``host_escalations`` must agree, for the worker thread
with ``min_wave_ops``, for overlap on and off, and under fault planes that
force the wide lane and the host escalation (each applier gets its own
instance of the same plane, and both must consult it at the same seams in
the same order). The CPU cannot show the CUDA fences at work; the card
phase of ``chip_smoke.py`` compares overlap on and off there.
"""

from dataclasses import replace

import numpy as np
import pytest

from fluidframework_tpu.service.tpu_applier import (
    TpuDocumentApplier,
    channel_stream,
)
from fluidframework_tpu_torch.obs import get_registry, parse_prometheus
from fluidframework_tpu_torch.ops.opgen import generate_doc_ops
from fluidframework_tpu_torch.service.gpu_applier import GpuDocumentApplier
from fluidframework_tpu_torch.testing.streams import wire_pairs
from tests.test_pallas_apply import _fuzz_session
from tests.test_torch_applier import _to_port

GEOMETRY = dict(max_docs=16, max_slots=64, ops_per_dispatch=8)
N_DOCS = 10


def _streams(seed: int) -> dict:
    """{doc: [(message, wire op)]} for N_DOCS opgen docs."""
    rng = np.random.default_rng(seed)
    texts = np.random.default_rng(seed + 100)
    out = {}
    for d in range(N_DOCS):
        rows, _, _ = generate_doc_ops(rng, 30 + 4 * d, remove_fraction=0.35,
                                      annotate_fraction=0.15, max_insert=6)
        out[f"doc{d}"] = wire_pairs(rows, texts)
    return out


def _feed(app, streams: dict, flush_each_doc: bool = False):
    app.set_replay_source(
        lambda t, d: [replace(m, contents=w) for m, w in streams[d]])
    for doc, pairs in streams.items():
        for i in range(0, len(pairs), 6):
            app.ingest_batch("t", doc, pairs[i:i + 6])
        if flush_each_doc:
            app.flush()
    app.finalize()
    return app


class _Plane:
    """A deterministic fault plane: records every consultation and
    answers ``directive`` at the first consultation of ``seam`` that
    matches ``when``."""

    def __init__(self, seam=None, directive=None, when=lambda info: True):
        self.seam, self.directive, self.when = seam, directive, when
        self.calls = []
        self.fired = False

    def __call__(self, seam, **info):
        self.calls.append((seam, info))
        if not self.fired and seam == self.seam and self.when(info):
            self.fired = True
            return self.directive
        return None


def _assert_same(port, jax_app, streams):
    for doc in streams:
        text = port.get_text("t", doc)
        assert text == jax_app.get_text("t", doc), doc
        for pos in range(0, len(text), 2):
            assert port.get_properties_at("t", doc, pos) == \
                jax_app.get_properties_at("t", doc, pos), (doc, pos)
    assert port.ops_applied == jax_app.ops_applied
    assert port.dispatches == jax_app.dispatches > 0
    assert port.host_escalations == jax_app.host_escalations


@pytest.fixture
def appliers():
    """Constructs appliers and closes every async one at teardown."""
    made = []

    def make(kind, **kw):
        if kind == "port":
            app = GpuDocumentApplier(device="cpu", **{**GEOMETRY, **kw})
        else:
            app = TpuDocumentApplier(kernel="xla", **{**GEOMETRY, **kw})
        made.append(app)
        return app

    yield make
    for app in made:
        if getattr(app, "_async", False):
            try:
                app.close()
            except Exception:  # noqa: BLE001 — a test may have raised it
                pass


@pytest.mark.parametrize("seed", [0, 3])
def test_async_min_wave_holds_off_like_jax(appliers, seed):
    """min_wave_ops above everything staged: the worker dispatches
    nothing on flush() and the whole stream drains at finalize — the same
    waves as the JAX worker and as a synchronous applier."""
    streams = _streams(seed)
    total = sum(len(p) for p in streams.values())
    kw = dict(async_dispatch=True, min_wave_ops=10 * total)
    port = _feed(appliers("port", **kw), streams, flush_each_doc=True)
    jax_app = _feed(appliers("jax", **kw), streams, flush_each_doc=True)
    sync = _feed(appliers("port"), streams)
    _assert_same(port, jax_app, streams)
    assert port.dispatches == sync.dispatches
    assert port.ops_applied == sync.ops_applied == total
    for doc in streams:
        assert port.get_text("t", doc) == sync.get_text("t", doc)


def test_async_small_waves_match_jax(appliers):
    """A low min_wave_ops and a flush per doc: the worker dispatches
    while ingest goes on. Wave counts depend on thread timing, so texts,
    properties and counts of ops are compared."""
    streams = _streams(5)
    kw = dict(async_dispatch=True, min_wave_ops=16)
    port = _feed(appliers("port", **kw), streams, flush_each_doc=True)
    jax_app = _feed(appliers("jax", **kw), streams, flush_each_doc=True)
    for doc in streams:
        assert port.get_text("t", doc) == jax_app.get_text("t", doc)
    assert port.ops_applied == jax_app.ops_applied \
        == sum(len(p) for p in streams.values())
    assert port.host_escalations == jax_app.host_escalations == 0
    assert port.dispatches > 0 and port.waves_staged == port.dispatches


@pytest.fixture(scope="module")
def sessions():
    """seed -> (JAX messages, port messages, converged text)."""
    out = {}
    for seed in (0, 7):
        server, want = _fuzz_session(seed, f"mx{seed}")
        jmsgs = list(channel_stream(server, "t", f"mx{seed}", "default",
                                    "text"))
        out[seed] = (jmsgs, [_to_port(m) for m in jmsgs], want)
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_overlap_on_off_equivalence(sessions, seed):
    """The overlap-staged pipeline is a pure perf change: overlap on and
    off converge identically (the JAX test of the same name at
    shards=0), and every wave went through the stage/execute split."""
    jmsgs, pmsgs, want = sessions[seed]
    doc = f"mx{seed}"
    geo = dict(max_docs=16, max_slots=256, ops_per_dispatch=8)
    apps = []
    for overlap in (True, False):
        port = GpuDocumentApplier(device="cpu", overlap=overlap, **geo)
        jax_app = TpuDocumentApplier(kernel="xla", overlap=overlap, **geo)
        for app, msgs in ((port, pmsgs), (jax_app, jmsgs)):
            app.set_replay_source(lambda t, d: [])
            for m in msgs:
                app.ingest("t", doc, m, m.contents)
            app.finalize()
        assert port.get_text("t", doc) == jax_app.get_text("t", doc) == want
        assert port.dispatches == jax_app.dispatches
        assert port.host_escalations == jax_app.host_escalations == 0
        apps.append(port)
    for app in apps:
        assert app.waves_staged == app.dispatches > 0
        assert app.stage_seconds > 0
        assert app.stage_bytes > 0
        assert app.stage_overlap_ratio() == 0.0  # the CPU step is eager


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_force_wide_plane_matches_jax(appliers, async_dispatch):
    """A plane that forces the int32 lane on the second dispatch: both
    appliers drain, ship that wave wide and end on the same docs."""
    streams = _streams(1)
    planes = []
    apps = []
    for kind in ("port", "jax"):
        plane = _Plane("applier.dispatch", "force_wide")
        plane.when = lambda info, p=plane: sum(
            c[0] == "applier.dispatch" for c in p.calls) == 2
        app = appliers(kind, async_dispatch=async_dispatch)
        app.fault_plane = plane
        apps.append(_feed(app, streams))
        planes.append(plane)
    port, jax_app = apps
    _assert_same(port, jax_app, streams)
    assert port.wide_dispatches == 1
    assert planes[0].fired and planes[1].fired
    assert planes[0].calls == planes[1].calls
    assert {c[0] for c in planes[0].calls} == {
        "applier.ingest", "applier.dispatch", "applier.stage.staged",
        "applier.stage.inflight"}


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_escalate_host_plane_matches_jax(appliers, async_dispatch):
    """A plane that flips doc3 to the host at its first ingest: both
    appliers replay it from the log and agree on every doc."""
    streams = _streams(2)
    apps, planes = [], []
    for kind in ("port", "jax"):
        app = appliers(kind, async_dispatch=async_dispatch)
        target = app.slot_of("t", "doc3")
        plane = _Plane("applier.ingest", "escalate_host",
                       when=lambda info, s=target: info["slot"] == s)
        app.fault_plane = plane
        apps.append(_feed(app, streams))
        planes.append(plane)
    port, jax_app = apps
    _assert_same(port, jax_app, streams)
    assert port.host_escalations == 1
    assert port._doc_keys[next(iter(port._host_docs))] == ("t", "doc3")
    assert planes[0].calls == planes[1].calls


def test_anchoring_answers_match_jax(appliers):
    streams = _streams(4)
    port = _feed(appliers("port"), streams)
    jax_app = _feed(appliers("jax"), streams)
    for app in (port, jax_app):
        app.mark_anchored("t", "doc1")
    for doc in ("doc0", "doc1", "doc2"):
        assert port.is_anchored("t", doc) == jax_app.is_anchored("t", doc)
        assert port.restore_gap("t", doc) == jax_app.restore_gap("t", doc) \
            is None
        assert port.applied_seq("t", doc) == jax_app.applied_seq("t", doc)
        assert port.first_seq("t", doc) == jax_app.first_seq("t", doc)
    assert port.is_anchored("t", "doc1") and \
        not port.is_anchored("t", "doc0")
    # an escalation discards the anchor in both
    for app in (port, jax_app):
        app._escalate(app.slot_of("t", "doc1"), None, None)
        assert not app.is_anchored("t", "doc1")
    assert port.get_text("t", "doc1") == jax_app.get_text("t", "doc1")


def test_worker_exception_surfaces_at_finalize(appliers):
    """A fault on the worker is stored and re-raised by finalize; after
    that the dead worker is refused instead of waited on."""
    streams = _streams(6)

    def boom(seam, **info):
        if seam == "applier.stage.staged":
            raise ValueError("injected worker fault")

    app = appliers("port", async_dispatch=True)
    app.fault_plane = boom
    with pytest.raises(ValueError, match="injected worker fault"):
        _feed(app, streams)
    with pytest.raises(RuntimeError, match="not running"):
        app.finalize()
    with pytest.raises(RuntimeError, match="not running"):
        app.flush()
    app.close()  # the error was raised once already: close is quiet
    assert app._worker is None
    # closed, the applier dispatches on the caller's thread (docs whose
    # lost wave left them inconsistent escalate through the replay source)
    app.fault_plane = None
    streams["again"] = streams["doc0"]
    for i in range(0, len(streams["again"]), 6):
        app.ingest_batch("t", "again", streams["again"][i:i + 6])
    app.finalize()
    assert app.get_text("t", "again") == _feed(
        appliers("port"), streams).get_text("t", "doc0")


def test_worker_exception_surfaces_at_close(appliers):
    app = appliers("port", async_dispatch=True, min_wave_ops=1)

    def boom(seam, **info):
        if seam == "applier.stage.inflight":
            raise KeyError("inflight fault")

    app.fault_plane = boom
    pairs = _streams(8)["doc0"]
    app.ingest_batch("t", "doc0", pairs)
    app.flush()
    app._worker.join(timeout=30)
    assert not app._worker.is_alive()
    with pytest.raises(KeyError, match="inflight fault"):
        app.close()


def test_stage_metrics_reach_the_registry(appliers):
    """The applier's series land in the port's own registry (the JAX
    package's registry is another object and stays untouched)."""
    from fluidframework_tpu.obs import get_registry as jax_registry

    jax_before = jax_registry().scrape()
    before = parse_prometheus(get_registry().scrape())
    app = _feed(appliers("port"), _streams(9))
    after = parse_prometheus(get_registry().scrape())
    assert app.last_wave_hops is not None
    assert app.last_wave_hops[0] <= app.last_wave_hops[1]

    def value(scrape, name, **labels):
        return scrape.get(name, {}).get(tuple(sorted(labels.items())), 0)

    lane = {"lane": "dense"}
    assert value(after, "fluid_applier_stage_bytes", **lane) - value(
        before, "fluid_applier_stage_bytes", **lane) == app.stage_bytes
    assert value(after, "fluid_applier_stage_seconds", **lane) > value(
        before, "fluid_applier_stage_seconds", **lane)
    assert value(after, "fluid_applier_exec_seconds", **lane) > 0
    assert value(after, "fluid_applier_stage_overlap_ratio", **lane) == 0
    hops = ("fluid_obs_hop_ms_count", {"pair": "stage_to_execute"})
    assert value(after, hops[0], **hops[1]) - value(
        before, hops[0], **hops[1]) == app.dispatches
    assert jax_registry().scrape() == jax_before
