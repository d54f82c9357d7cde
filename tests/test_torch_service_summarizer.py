"""The port's service summarizer, from the replica farm's state on the
CPU, and against the JAX package's.

Every test of ``tests/test_service_summarizer.py`` but the one that needs
``storage_dir`` (the native chunk store, not ported yet), run on the
port with ``GpuDocumentApplier(device="cpu")``; then the same streams
through both packages' summarizers (the JAX one over ``TpuDocumentApplier``
on JAX's CPU backend): the same chunk bytes, root records, version
records, refusal messages and chunk reuse, and everything the two servers
store equal but the JAX history plane's commit records, which the port
does not write.
"""

import pytest

from tests.torch_stack_fixtures import stack, stored
from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.service.gpu_applier import (
    GpuDocumentApplier,
    channel_stream,
)
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.service_summarizer import (
    ServiceSummarizer,
)


def cpu_applier(**geo):
    return GpuDocumentApplier(device="cpu", **geo)


@pytest.fixture
def server():
    return LocalServer()


@pytest.fixture
def loader(server):
    return Loader(LocalDocumentServiceFactory(server))


def feed(applier, server, tenant, doc):
    for m in channel_stream(server, tenant, doc, "default", "text"):
        applier.ingest(tenant, doc, m, m.contents)


def test_boot_from_service_summary_without_client_summarizer(server, loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "server-side summaries ")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(0, ">> ")
    s1.annotate_range(0, 2, {"bold": True})
    assert s1.get_text() == s2.get_text()

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "doc")
    svc = ServiceSummarizer(server, applier)
    version = svc.summarize_doc("t", "doc")
    assert version is not None and svc.summaries_written == 1

    # NO client ever summarized — yet a fresh client boots from the
    # service summary + tail and stays live
    c3 = loader.resolve("t", "doc")
    assert c3._base_snapshot is not None
    s3 = c3.runtime.get_data_store("default").get_channel("text")
    assert s3.get_text() == s1.get_text()
    assert s3.client.get_properties_at(0).get("bold") is True
    s3.insert_text(0, "live! ")
    assert s1.get_text() == s3.get_text() == s2.get_text()


def test_batch_service_summaries(server, loader):
    docs = [f"d{i}" for i in range(6)]
    strings = {}
    applier = cpu_applier(max_docs=8, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    for d in docs:
        c = loader.resolve("t", d)
        s = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s.insert_text(0, f"content of {d}")
        strings[d] = s
        feed(applier, server, "t", d)

    svc = ServiceSummarizer(server, applier)
    assert svc.summarize_all("t", docs) == len(docs)

    for d in docs:
        c = loader.resolve("t", d)
        assert c._base_snapshot is not None
        assert (c.runtime.get_data_store("default").get_channel("text")
                .get_text() == strings[d].get_text())


def test_summarize_refuses_lagging_applier(server, loader):
    """Code-review r4: a service summary written from device state that
    LAGS the stream would claim coverage it doesn't have and let
    retention truncate the missing ops — the summarizer must refuse."""
    c1 = loader.resolve("t", "lagdoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "abc")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "lagdoc")
    svc = ServiceSummarizer(server, applier)

    # more ops AFTER the feed: the applier now lags the stream
    s1.insert_text(3, "def")
    with pytest.raises(RuntimeError, match="lags"):
        svc.summarize_doc("t", "lagdoc")

    # catching up makes it summarizable again
    feed(applier, server, "t", "lagdoc")
    assert svc.summarize_doc("t", "lagdoc") is not None


def test_summarize_refuses_non_modeled_content(server, loader):
    """The module-docstring contract: a doc holding channels the device
    does not model must keep client summaries — a service summary would
    drop them while retention truncates their ops."""
    c1 = loader.resolve("t", "mixdoc")
    ds = c1.runtime.create_data_store("default")
    s = ds.create_channel("text", "shared-string")
    s.insert_text(0, "text part")
    kv = ds.create_channel("kv", "shared-map")
    kv.set("k", "v")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "mixdoc")
    svc = ServiceSummarizer(server, applier)
    with pytest.raises(RuntimeError, match="not model"):
        svc.summarize_doc("t", "mixdoc")

    # a second data store is refused just the same
    c2 = loader.resolve("t", "dsdoc")
    c2.runtime.create_data_store("default").create_channel(
        "text", "shared-string").insert_text(0, "x")
    c2.runtime.create_data_store("other").create_channel(
        "text", "shared-string")
    applier2 = cpu_applier(max_docs=4, max_slots=64,
                                  ops_per_dispatch=8)
    applier2.set_replay_source(lambda t, d: [])
    feed(applier2, server, "t", "dsdoc")
    with pytest.raises(RuntimeError, match="data store"):
        ServiceSummarizer(server, applier2).summarize_doc("t", "dsdoc")


def test_summarize_refuses_unproven_prefix_coverage(tmp_path):
    """Code-review r4 round 2: an applier fed only the post-truncation
    TAIL passes a max-seq check but must still be refused — its state
    does not provably contain the truncated prefix."""
    from fluidframework_tpu_torch.config import Config
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    cfg = Config().with_overrides(log_retention_ops=0)
    server = LocalServer(config=cfg)
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "precious prefix ")
    SummaryManager(c1, max_ops=10**9).summarize_now()  # truncates the log
    s1.insert_text(0, "tail ")
    orderer = server._get_orderer("t", "doc")
    base = orderer.scriptorium.retained_base("t", "doc")
    assert base > 0

    # a FRESH applier that ingests only the retained tail
    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    for m in channel_stream(server, "t", "doc", "default", "text",
                            from_seq=base):
        applier.ingest("t", "doc", m, m.contents)
    svc = ServiceSummarizer(server, applier)
    with pytest.raises(RuntimeError, match="not\\b.*anchored|anchored"):
        svc.summarize_doc("t", "doc")
    # and a batch pass SKIPS it instead of aborting
    assert svc.summarize_all("t", ["doc"]) == 0
    assert len(svc.refusals) == 1


def test_summarize_refuses_gapped_genesis_feed(server, loader):
    """Untruncated log, but the applier missed the doc's first channel
    op: first-seq accounting must refuse."""
    c1 = loader.resolve("t", "gapdoc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "first")
    s1.insert_text(5, " second")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    msgs = list(channel_stream(server, "t", "gapdoc", "default", "text"))
    for m in msgs[1:]:  # skip the doc's first channel op
        applier.ingest("t", "gapdoc", m, m.contents)
    with pytest.raises(RuntimeError, match="incomplete"):
        ServiceSummarizer(server, applier).summarize_doc("t", "gapdoc")


def test_anchored_applier_survives_own_truncation(tmp_path):
    """The happy path across retention: a genesis-fed applier writes a
    summary (gate pass anchors it), retention truncates, and a SECOND
    service summary still commits."""
    from fluidframework_tpu_torch.config import Config

    cfg = Config().with_overrides(log_retention_ops=0)
    server = LocalServer(config=cfg)
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "one ")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "doc")
    svc = ServiceSummarizer(server, applier)
    v1 = svc.summarize_doc("t", "doc")  # anchors + truncates
    assert server._get_orderer("t", "doc") \
        .scriptorium.retained_base("t", "doc") > 0

    s1.insert_text(0, "two ")
    orderer = server._get_orderer("t", "doc")
    base = orderer.scriptorium.retained_base("t", "doc")
    for m in channel_stream(server, "t", "doc", "default", "text",
                            from_seq=base):
        applier.ingest("t", "doc", m, m.contents)
    v2 = svc.summarize_doc("t", "doc")
    assert v2 != v1
    c2 = loader.resolve("t", "doc")
    assert (c2.runtime.get_data_store("default").get_channel("text")
            .get_text() == "two one ")


def test_summarize_refuses_restart_window_gap(tmp_path):
    """Code-review r4 round 3: a checkpoint-restored anchor is only
    trustworthy if no channel op was sequenced while the process was
    down — ops in the restart window are in the log but not in the
    restored device state."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
        save_applier_checkpoint,
    )

    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "before ")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "doc")
    svc = ServiceSummarizer(server, applier)
    svc.summarize_doc("t", "doc")  # anchors the slot
    ckpt = str(tmp_path / "ck")
    save_applier_checkpoint(applier, ckpt)

    # "process death": ops sequenced while the applier is down
    s1.insert_text(0, "downtime ")
    applier2 = load_applier_checkpoint(ckpt, ops_per_dispatch=8, device="cpu")
    applier2.set_replay_source(lambda t, d: [])
    # the feed resumes LATE — only ops after another edit
    s1.insert_text(0, "late ")
    late_seq = max(m.sequence_number for m in channel_stream(
        server, "t", "doc", "default", "text"))
    for m in channel_stream(server, "t", "doc", "default", "text"):
        if m.sequence_number >= late_seq:
            applier2.ingest("t", "doc", m, m.contents)
    svc2 = ServiceSummarizer(server, applier2)
    with pytest.raises(RuntimeError, match="restart window"):
        svc2.summarize_doc("t", "doc")

    # a restore whose feed resumes cleanly (no window ops) is accepted
    applier3 = load_applier_checkpoint(ckpt, ops_per_dispatch=8, device="cpu")
    applier3.set_replay_source(lambda t, d: [])
    ck_seq = applier3.applied_seq("t", "doc")
    for m in channel_stream(server, "t", "doc", "default", "text"):
        if m.sequence_number > ck_seq:
            applier3.ingest("t", "doc", m, m.contents)
    v = ServiceSummarizer(server, applier3).summarize_doc("t", "doc")
    assert v is not None
    c2 = loader.resolve("t", "doc")
    assert (c2.runtime.get_data_store("default").get_channel("text")
            .get_text() == "late downtime before ")


def test_restart_window_survives_checkpoint_cycle(tmp_path):
    """A save/load cycle must NOT discharge a pending (unverified)
    restart window: checkpoint B saved while A's window is open keeps
    A's low bound, so downtime ops still trip the summarizer gate."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
        save_applier_checkpoint,
    )

    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "before ")

    applier = cpu_applier(max_docs=4, max_slots=64,
                                 ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "doc")
    svc = ServiceSummarizer(server, applier)
    svc.summarize_doc("t", "doc")  # anchors the slot
    ck_a = str(tmp_path / "a")
    save_applier_checkpoint(applier, ck_a)

    # downtime ops → restore from A with an OPEN window, feed resumes late
    s1.insert_text(0, "downtime ")
    applier2 = load_applier_checkpoint(ck_a, ops_per_dispatch=8, device="cpu")
    applier2.set_replay_source(lambda t, d: [])
    s1.insert_text(0, "late ")
    late_seq = max(m.sequence_number for m in channel_stream(
        server, "t", "doc", "default", "text"))
    for m in channel_stream(server, "t", "doc", "default", "text"):
        if m.sequence_number >= late_seq:
            applier2.ingest("t", "doc", m, m.contents)
    # BEFORE any summarize (which would refuse), a routine save runs
    ck_b = str(tmp_path / "b")
    save_applier_checkpoint(applier2, ck_b)

    applier3 = load_applier_checkpoint(ck_b, ops_per_dispatch=8, device="cpu")
    applier3.set_replay_source(lambda t, d: [])
    # feed resumes cleanly from B's applied seq — but A's window is
    # still unverified and must still be enforced
    ck_seq = applier3.applied_seq("t", "doc")
    for m in channel_stream(server, "t", "doc", "default", "text"):
        if m.sequence_number > ck_seq:
            applier3.ingest("t", "doc", m, m.contents)
    with pytest.raises(RuntimeError, match="restart window"):
        ServiceSummarizer(server, applier3).summarize_doc("t", "doc")


# ---------------------------------------------------------------------
# the port's summarizer against the JAX package's
# ---------------------------------------------------------------------

GEO = dict(max_docs=8, max_slots=128, ops_per_dispatch=8)
DOCS = ["long", "edit", "mix", "lag"]


def _feed_new(st, applier, server, doc, upto=None):
    """Ingest the doc's channel ops the applier has not seen (those
    sequenced at or below ``upto`` only, when given)."""
    have = applier.applied_seq("t", doc)
    for m in st.channel_stream(server, "t", doc, "default", "text"):
        if m.sequence_number > have and (upto is None
                                         or m.sequence_number <= upto):
            applier.ingest("t", doc, m, m.contents)


def _fleet(pkg: str) -> dict:
    """Four docs through one package: a long single-writer doc, a doc two
    containers edit, a doc with a map (refused) and a doc whose applier
    lags (refused); a summary pass, an append to the long doc and a
    second pass. Returns what the passes report and what the server
    stores."""
    st = stack(pkg)
    server = st.server()
    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    strings = {}
    for d in DOCS:
        c = loader.resolve("t", d)
        ds = c.runtime.create_data_store("default")
        strings[d] = ds.create_channel("text", "shared-string")
        if d == "mix":
            ds.create_channel("kv", "shared-map").set("k", "v")
    for i in range(90):
        strings["long"].insert_text(len(strings["long"].get_text()),
                                    f"w{i} ")
    other = loader.resolve("t", "edit").runtime.get_data_store(
        "default").get_channel("text")
    strings["edit"].insert_text(0, "shared text of the edit doc")
    other.insert_text(7, "[two]", {"bold": True})
    strings["edit"].remove_text(0, 3)
    other.annotate_range(2, 9, {"color": "red"})
    strings["mix"].insert_text(0, "mixed")
    strings["lag"].insert_text(0, "lagging")
    lag_seq = server.get_deltas("t", "lag", 0, 10**9)[-1].sequence_number
    strings["lag"].insert_text(0, "unfed ")

    applier = st.applier(**GEO)
    applier.set_replay_source(lambda t, d: [])
    for d in DOCS:
        _feed_new(st, applier, server, d,
                  upto=lag_seq if d == "lag" else None)
    svc = st.ServiceSummarizer(server, applier, segs_per_chunk=4,
                               text_split=64)
    out = {"first": svc.summarize_all("t", DOCS),
           "first_refusals": list(svc.refusals),
           "first_counts": dict(svc.counters.snapshot())}
    strings["long"].insert_text(len(strings["long"].get_text()), "tail ")
    _feed_new(st, applier, server, "long")
    out["second"] = svc.summarize_all("t", DOCS)
    out["second_refusals"] = list(svc.refusals)
    out["counts"] = dict(svc.counters.snapshot())
    out["heads"] = {d: server._get_orderer("t", d).scribe.last_summary_head
                    for d in DOCS}
    out["roots"] = {}
    for d in ("long", "edit"):
        storage = server.storage("t", d)
        versions = server.db.collection(st.summary_versions_collection(
            "t", d))
        out["roots"][d] = [storage.read_blob(v["tree_id"])
                           for v in versions.values()]
    out["storage_stats"] = dict(server.storage_stats)
    out["stored"] = stored(server)
    out["server"] = server
    return out


def test_summaries_equal_jax():
    want, got = _fleet("jax"), _fleet("torch")
    assert got["first"] == want["first"] == 2
    assert got["second"] == want["second"] == 2
    # the same refusals, message for message
    assert got["first_refusals"] == want["first_refusals"]
    assert got["second_refusals"] == want["second_refusals"]
    assert {d for _t, d, _m in got["first_refusals"]} == {"mix", "lag"}
    # the same chunks written and reused on both passes
    assert got["first_counts"] == want["first_counts"]
    assert got["counts"] == want["counts"]
    reused = got["counts"]["storage.snapshot.chunks_reused"]
    assert reused > 0
    assert got["heads"] == want["heads"]
    assert got["roots"] == want["roots"] and len(got["roots"]["long"]) == 2
    assert got["storage_stats"] == want["storage_stats"]
    # every db collection and log topic (blobs, version records, deltas,
    # checkpoints) equal, once the JAX history plane's records are left
    # out: the port does not write them
    assert got["stored"] == want["stored"]
    assert not any(k.startswith("db:history-records/")
                   for k in stored(got["server"], skip=()))
    assert any(k.startswith("db:history-records/")
               for k in stored(want["server"], skip=()))


def test_summarize_doc_records_no_history_commit(server, loader):
    """The history plane is not ported: ``summarize_doc`` commits the
    version through scribe and writes no commit node, and the plane
    itself still refuses."""
    c1 = loader.resolve("t", "doc")
    c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string").insert_text(0, "no history yet")
    applier = cpu_applier(max_docs=4, max_slots=64, ops_per_dispatch=8)
    applier.set_replay_source(lambda t, d: [])
    feed(applier, server, "t", "doc")
    version = ServiceSummarizer(server, applier).summarize_doc("t", "doc")
    assert server._get_orderer("t", "doc").scribe.last_summary_head \
        == version
    assert server.storage("t", "doc").get_versions(1)[0]["id"] == version
    assert not [n for n in server.db.collections
                if n.startswith("history-records/")]
    with pytest.raises(NotImplementedError, match="history plane"):
        server.history


def _host_replica_summary(pkg: str):
    from importlib import import_module

    st = stack(pkg)
    mod = import_module({"jax": "fluidframework_tpu",
                         "torch": "fluidframework_tpu_torch"}[pkg]
                        + ".service.service_summarizer")
    server = st.server()
    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    s1 = loader.resolve("t", "doc").runtime.create_data_store(
        "default").create_channel("text", "shared-string")
    s1.insert_text(0, "host replicas and the farm")
    s1.annotate_range(0, 4, {"bold": True})
    s1.remove_text(5, 14)
    version = mod.ServiceSummarizer(
        server, mod.HostReplicaSource(server)).summarize_doc("t", "doc")
    storage = server.storage("t", "doc")
    root = storage.read_blob(storage.get_versions(1)[0]["tree_id"])
    booted = loader.resolve("t", "doc", connect=False)
    return version, root, booted.runtime.get_data_store(
        "default").get_channel("text").get_text()


def test_host_replica_source_equals_jax():
    """``HostReplicaSource`` (host replicas fed from the log, for a
    service without a farm) writes the JAX package's root record, and a
    container boots from it."""
    got, want = _host_replica_summary("torch"), _host_replica_summary("jax")
    assert got == want
    assert got[2] == "host and the farm"
