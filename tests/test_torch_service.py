"""The port's in-process ordering pipeline against the JAX package's.

``service/load_gen.run_inproc`` of both packages, on the same seeds and
lanes at a small size (16 docs, 2 clients a doc, 24 ops a client, boxcars
of 8), each with its own applier riding the broadcast (the port's on the
CPU, the JAX one on JAX's CPU backend): the load counts must be equal,
every doc's sequenced stream (read back from the run's log) must be equal
field by field, and every doc's text must be equal. Client ids carry a
random epoch, so they are compared through a map built by first
appearance; timestamps are wall-clock and not compared.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.load_gen import run_inproc as jax_run_inproc
from fluidframework_tpu.service.local_log import LocalLog as JaxLocalLog
from fluidframework_tpu.service.tpu_applier import TpuDocumentApplier
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    channel_stream,
)
from fluidframework_tpu_torch.service.load_gen import run_inproc
from fluidframework_tpu_torch.service.local_log import LocalLog
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.synthetic import SyntheticEditor

RUN = dict(n_docs=16, clients_per_doc=2, ops_per_client=24, batch_size=8,
           flush_every=64)
GEOMETRY = dict(max_docs=16, max_slots=256, ops_per_dispatch=8)


def _stream(log, doc: str) -> list:
    """Every sequenced message of ``doc`` in the run's deltas topic."""
    topic = f"deltas/bench/{doc}"
    out = []
    for i in range(log.length(topic)):
        rec = log.read(topic, i)
        if "abatch" in rec:
            out += rec["abatch"].messages()
        elif "boxcar" in rec:
            out += rec["boxcar"]
        else:
            out.append(rec["message"])
    return out


def _normalized(msgs: list, ids: dict) -> list:
    """Fields of each message, client ids (also those inside join/leave
    contents) replaced by their order of first appearance."""

    def cid(c):
        return None if c is None else ids.setdefault(c, len(ids))

    out = []
    for m in msgs:
        contents = m.contents
        if m.type in (MessageType.CLIENT_JOIN, MessageType.CLIENT_LEAVE):
            contents = dict(contents, clientId=cid(contents["clientId"]))
        out.append((cid(m.client_id), m.sequence_number,
                    m.minimum_sequence_number, m.client_sequence_number,
                    m.reference_sequence_number, str(m.type.value),
                    contents))
    return out


def _runs(seed: int, array_lane: bool, **port_applier):
    port_log, jax_log = LocalLog(), JaxLocalLog()
    port_app = GpuDocumentApplier(device="cpu", **GEOMETRY, **port_applier)
    jax_app = TpuDocumentApplier(kernel="xla", **GEOMETRY)
    try:
        port = run_inproc(seed=seed, array_lane=array_lane, log=port_log,
                          applier=port_app, **RUN)
    finally:
        if port_applier.get("async_dispatch"):
            port_app.close()
    jax = jax_run_inproc(seed=seed, array_lane=array_lane, log=jax_log,
                         applier=jax_app, **RUN)
    return (port, port_log, port_app), (jax, jax_log, jax_app)


@pytest.mark.parametrize("array_lane", [False, True])
@pytest.mark.parametrize("seed", [0, 7])
def test_pipeline_matches_jax(seed, array_lane):
    (port, port_log, port_app), (jax, jax_log, jax_app) = _runs(
        seed, array_lane)
    total = RUN["n_docs"] * RUN["clients_per_doc"] * RUN["ops_per_client"]
    for key in ("ops", "acked"):
        assert port.summary()[key] == jax.summary()[key] == total
    assert len(port.ack_latencies_ms) == len(jax.ack_latencies_ms)
    assert port.applier_ops == jax.applier_ops == total
    assert port.applier_escalations == jax.applier_escalations == 0
    for d in range(RUN["n_docs"]):
        doc = f"doc{d}"
        want = _normalized(_stream(jax_log, doc), {})
        got = _normalized(_stream(port_log, doc), {})
        assert len(got) == len(want) > RUN["ops_per_client"]
        assert got == want, doc
        assert port_app.get_text("bench", doc) == \
            jax_app.get_text("bench", doc), doc


def test_async_applier_rides_the_pipeline():
    """The async applier with a min-wave threshold, on the array lane:
    the same texts as the JAX applier, every op applied."""
    (port, _, port_app), (jax, _, jax_app) = _runs(
        3, True, async_dispatch=True, min_wave_ops=96)
    assert port.applier_ops == jax.applier_ops == port.ops_submitted
    assert port.applier_escalations == 0
    for d in range(RUN["n_docs"]):
        doc = f"doc{d}"
        assert port_app.get_text("bench", doc) == \
            jax_app.get_text("bench", doc)


def test_channel_stream_replays_the_doc():
    """channel_stream reads a doc's merge-tree ops back out of
    scriptorium; an applier fed them reaches the live applier's text."""
    server = LocalServer()
    live = GpuDocumentApplier(device="cpu", **GEOMETRY)
    from fluidframework_tpu_torch.service.load_gen import wire_applier

    wire_applier(server, live, "bench", ["doc0"])
    import random

    rng = random.Random(1)
    conns = [(server.connect("bench", "doc0"), SyntheticEditor(rng))
             for _ in range(2)]
    for conn, editor in conns:
        # an editor tracks its own ops at submit, the others' here
        conn.on_ops = lambda batch, e=editor, me=conn.client_id: [
            e.observe(m) for m in batch if m.client_id != me]
    for _ in range(5):
        for conn, editor in conns:
            conn.submit(editor.next_ops(4))
    live.finalize()
    replayed = GpuDocumentApplier(device="cpu", **GEOMETRY)
    msgs = list(channel_stream(server, "bench", "doc0", "default", "text"))
    assert len(msgs) == 40
    for m in msgs:
        replayed.ingest("bench", "doc0", m, m.contents)
    replayed.finalize()
    assert replayed.get_text("bench", "doc0") == \
        live.get_text("bench", "doc0") != ""


@pytest.mark.parametrize("kwargs, item", [(dict(tenants=True), "tenants")])
def test_unported_server_options_refuse(kwargs, item):
    """``tenants`` is ported: with a registry, connect validates tokens
    riddler-style before touching any document state."""
    from fluidframework_tpu_torch.service.tenants import (
        AuthError,
        TenantManager,
        sign_token,
    )

    tm = TenantManager()
    tm.register("acme", "s3cret")
    server = LocalServer(**{item: tm if kwargs[item] else None})
    with pytest.raises(AuthError):
        server.connect("acme", "doc")
    assert not server._orderers
    conn = server.connect("acme", "doc",
                          token=sign_token("acme", "doc", "s3cret"))
    assert conn.mode == "write"


def test_unported_server_planes_refuse():
    """The sharded core's hooks are the JAX package's: lazy boot (a first
    route of a doc with no log counts ``fresh``), the rehydrator (asked
    to admit each cold first route) and the epoch fence (consulted on
    every record); the history plane is built on first use."""
    from fluidframework_tpu_torch.service.history_plane import HistoryPlane
    from fluidframework_tpu_torch.service.rehydrate import (
        RehydrationExecutor,
    )

    server = LocalServer()
    assert isinstance(server.history, HistoryPlane)
    assert server.history is server.history
    fenced = []
    server.lazy_boot = True
    server.rehydrator = RehydrationExecutor(100.0, 4)
    server.epoch_fence = lambda: fenced.append(1)
    conn = server.connect("t", "d")
    assert server._orderers["t/d"].boot_mode == "fresh"
    assert server.rehydrator.booted == 1
    assert fenced and conn.client_id
    server.seal()
    with pytest.raises(RuntimeError, match="sealed"):
        server.connect("t", "d")
    server.unseal()
    server.revoke()
    with pytest.raises(RuntimeError, match="lease lost"):
        server.connect("t", "d")


def _unreadable_log(log_cls, prefix: str):
    """A log whose ``length`` raises ``OSError`` for topics under
    ``prefix`` (a damaged checkpoints or versions topic)."""
    class Unreadable(log_cls):
        def length(self, topic):
            if topic.startswith(prefix):
                raise OSError(f"unreadable topic {topic}")
            return super().length(topic)

    return Unreadable()


@pytest.mark.parametrize("prefix", ["checkpoints/", "versions/"])
def test_orderer_boots_over_an_unreadable_topic_like_jax(prefix):
    """An unreadable checkpoints or versions topic boots the doc without
    those records, in both packages: ``connect``, the storage binding
    (which restores version records first) and the doc's stream."""
    from fluidframework_tpu.service.local_server import (
        LocalServer as JaxLocalServer,
    )

    streams = []
    for server_cls, log_cls in ((LocalServer, LocalLog),
                                (JaxLocalServer, JaxLocalLog)):
        server = server_cls(log=_unreadable_log(log_cls, prefix),
                            clock=lambda: 0.0)
        server._client_epoch = "e0"
        conn = server.connect("t", "d")
        assert server.storage("t", "d").get_versions(1) == []
        server.checkpoint_all()
        server.restart_orderer("t", "d")
        conn.disconnect()
        streams.append(_normalized(server.get_deltas("t", "d", 0, 10**9),
                                   {}))
    # the join, the leave and deli's noClient once the doc is empty
    assert streams[0] == streams[1] and len(streams[0]) == 3


def test_orderer_restart_matches_jax():
    """Checkpoint, tear down and rebuild one doc's pipeline mid-session
    (deli resumes from its checkpoint, scribe from its own): both
    packages go on sequencing the same stream."""
    import random as _random

    from fluidframework_tpu.service.local_server import (
        LocalServer as JaxLocalServer,
    )
    from fluidframework_tpu.service.synthetic import (
        SyntheticEditor as JaxEditor,
    )

    streams = []
    for server_cls, editor_cls in ((LocalServer, SyntheticEditor),
                                   (JaxLocalServer, JaxEditor)):
        server = server_cls()
        rng = _random.Random(11)
        conns = [(server.connect("t", "d"), editor_cls(rng))
                 for _ in range(2)]
        for conn, editor in conns:
            conn.on_ops = lambda batch, e=editor, me=conn.client_id: [
                e.observe(m) for m in batch if m.client_id != me]
        for round_ in range(6):
            if round_ == 3:
                server.checkpoint_all()
                server.restart_orderer("t", "d")
            for conn, editor in conns:
                conn.submit(editor.next_ops(3))
        streams.append(_normalized(server.get_deltas("t", "d", 0, 10**9),
                                   {}))
    assert len(streams[0]) == 2 + 36
    assert streams[0] == streams[1]


def _copier_archive(root: str) -> tuple:
    """One package's copier on a doc's raw topic: a good boxcar, then a
    clientSeq gap deli refuses. Returns the archive's kinds and
    clientSeqs, the copied count and whether deli nacked."""
    from importlib import import_module

    msgs = import_module(f"{root}.protocol.messages")
    server = import_module(f"{root}.service.local_server").LocalServer()
    copier = import_module(f"{root}.service.copier").CopierLambda(server.db)
    conn = server.connect("t", "doc")
    orderer = server._get_orderer("t", "doc")
    server.log.subscribe(orderer.raw_topic, copier.handler, from_offset=0)

    def submit(cseq, contents):
        conn.submit([msgs.DocumentMessage(
            client_sequence_number=cseq, reference_sequence_number=0,
            type=msgs.MessageType.OPERATION, contents=contents)])

    submit(1, {"good": 1})
    nacks = []
    conn.on_nack = nacks.append
    submit(9, {"bad": 1})  # a clientSeq gap
    rows = copier.archive("t", "doc")
    kinds = [(r["kind"], r.get("clientSeq") or
              (r["ops"][0]["clientSeq"] if r.get("ops") else None))
             for r in rows]
    return kinds, copier.copied == len(rows), bool(nacks)


def test_copier_archives_raw_traffic_including_rejected():
    """The port's copier (``service/copier.py``) keeps what deli nacked
    too, and archives the same records as the JAX package's copier."""
    kinds, counted, nacked = _copier_archive("fluidframework_tpu_torch")
    assert nacked and counted
    assert ("raw", -1) in kinds
    assert ("boxcar", 1) in kinds
    assert ("boxcar", 9) in kinds
    assert (kinds, counted, nacked) == _copier_archive("fluidframework_tpu")
