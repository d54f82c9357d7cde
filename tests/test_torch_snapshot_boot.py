"""The port's snapshot fast-boot plane against ``tests/test_snapshot_boot.py``:
columnar snapcols summaries served encode-once over FT_COLS_SNAP, the
snapshot-plus-tail boot, the client chunk cache, the verified fallback
and the retention clamp (``protocol/snapcols.py``,
``service/service_summarizer.py``, ``service/front_end.py``,
``driver/network.py``, ``driver/snapshot_cache.py``, ``loader/``).

The codec's two cases are held by ``test_torch_snapcols.py``
(``test_chunks_equal_jax_and_round_trip``,
``test_prefix_stable_under_append_as_jax``). Each test here is the twin
of the JAX test of the same name. The in-process cases run on each
package (``torch_stack_fixtures.both``: a fixed client-id epoch and a
clock at 0) with the JAX test's assertions, and the fingerprints, the
summarizer's counters, the retained bases and seqs and everything the
server stored (``torch_stack_fixtures.stored``) are equal between the
packages. The socket cases run the JAX test's assertions on the port
alone, its front end in process as in the JAX test. Tolerance: exact.
"""

from __future__ import annotations

import json
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored

from fluidframework_tpu_torch.chaos import doc_fingerprint
from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.protocol import binwire
from fluidframework_tpu_torch.service import LocalServer, NetworkFrontEnd
from fluidframework_tpu_torch.service.service_summarizer import (
    HostReplicaSource,
    ServiceSummarizer,
)


def wait_for(pred, timeout=10.0, interval=0.005):
    t0 = time.time()
    while time.time() - t0 < timeout:
        try:
            if pred():
                return True
        except (KeyError, IndexError):
            pass
        time.sleep(interval)
    return False


def string_fingerprint(s, fingerprint=doc_fingerprint) -> str:
    text = s.get_text()
    props = [s.client.get_properties_at(i) or {} for i in range(len(text))]
    return fingerprint(text, props)


def make_doc(loader, tenant, doc, n_ops=40):
    c = loader.resolve(tenant, doc)
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for i in range(n_ops):
        s.insert_text(0, f"w{i} ")
    s.annotate_range(0, 3, {"bold": True})
    return c, s


def summarize(server, tenant, doc, summarizer=None):
    """One service summary of ``doc`` by ``summarizer`` (a package's
    ``service_summarizer`` module; the port's by default)."""
    if summarizer is None:
        svc = ServiceSummarizer(server, HostReplicaSource(server))
    else:
        svc = summarizer.ServiceSummarizer(
            server, summarizer.HostReplicaSource(server))
    version = svc.summarize_doc(tenant, doc)
    assert version is not None
    return svc, version


def _local_boot_equivalence(s):
    summarizer = s.mod("service.service_summarizer")
    replay = s.loader.resolve("t", "doc")
    c1, s1 = make_doc(s.loader, "t", "doc")
    svc, version = summarize(s.server, "t", "doc", summarizer)
    assert svc.summaries_written == 1
    s1.insert_text(0, "post-summary ")
    booted = s.loader.resolve("t", "doc")
    assert booted._base_snapshot is not None
    assert replay._base_snapshot is None
    sb = booted.runtime.get_data_store("default").get_channel("text")
    sr = replay.runtime.get_data_store("default").get_channel("text")
    fp = s.mod("chaos").doc_fingerprint
    assert string_fingerprint(sb, fp) == string_fingerprint(sr, fp) \
        == string_fingerprint(s1, fp)
    sb.insert_text(0, "live ")
    assert s1.get_text() == sb.get_text()
    s.note([version, string_fingerprint(sb, fp), stored(s.server)])


def test_local_boot_equivalence_snapshot_vs_replay():
    both(_local_boot_equivalence)


def _dedupes(s):
    summarizer = s.mod("service.service_summarizer")
    fp = s.mod("chaos").doc_fingerprint
    c1 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for i in range(120):
        s1.insert_text(len(s1.get_text()), f"w{i} ")
    svc = summarizer.ServiceSummarizer(
        s.server, summarizer.HostReplicaSource(s.server),
        segs_per_chunk=4, text_split=64)
    assert svc.summarize_doc("t", "doc") is not None
    written1 = svc.counters.snapshot().get("storage.snapshot.chunks_written")
    assert written1 >= 2
    s1.insert_text(len(s1.get_text()), "tail ")
    assert svc.summarize_doc("t", "doc") is not None
    assert svc.counters.snapshot() \
        .get("storage.snapshot.chunks_reused", 0) >= 1
    c2 = s.loader.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert string_fingerprint(s2, fp) == string_fingerprint(s1, fp)
    s.note([{k: v for k, v in svc.counters.snapshot().items()
             if k.startswith("storage.snapshot.chunks")},
            string_fingerprint(s2, fp), stored(s.server)])


def test_incremental_summarizer_dedupes_unchanged_chunks():
    both(_dedupes)


@pytest.fixture
def front_end():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    yield fe
    fe.stop()


def test_network_snapshot_boot_counters_and_equivalence(front_end):
    server = front_end.server
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1, s1 = make_doc(loader, "t", "doc", n_ops=60)
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    summarize(server, "t", "doc")
    s1.insert_text(0, "tail ")
    assert wait_for(lambda: c1.runtime.pending.count == 0)

    # fresh factory = cold client cache: the boot must ride FT_COLS_SNAP
    f2 = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    c2 = Loader(f2).resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert wait_for(lambda: s2.get_text() == s1.get_text())
    assert string_fingerprint(s2) == string_fingerprint(s1)
    got = f2.counters.snapshot()
    assert got.get("boot.snapshot.used") == 1
    assert got.get("boot.chunks.fetched", 0) >= 1
    # booted at the summary seq → the delta catch-up was the BOUNDED tail
    assert got.get("boot.backfill.bounded") == 1
    assert not got.get("boot.snapshot.fallback")

    srv = front_end.counters.snapshot()
    assert srv.get("storage.snapshot.encodes") == 1
    assert srv.get("storage.snapshot.served", 0) >= 1


def admin_rpc(port, frame, timeout=30.0):
    import socket

    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        body = json.dumps(dict(frame, rid=1)).encode()
        s.sendall(len(body).to_bytes(4, "big") + body)
        buf = b""
        while True:
            while len(buf) < 4:
                buf += s.recv(4096)
            n = int.from_bytes(buf[:4], "big")
            while len(buf) < 4 + n:
                buf += s.recv(4096)
            reply, buf = json.loads(buf[4:4 + n].decode()), buf[4 + n:]
            if reply.get("rid") == 1:
                return reply


def test_admin_summarize_rpc_commits_a_bootable_summary(front_end):
    """The operator door onto the summarizer: one RPC commits a snapcols
    summary a cold joiner then boots through — and an unknown doc is
    refused, not born as an empty summary."""
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    c1, s1 = make_doc(Loader(factory), "t", "doc", n_ops=40)
    assert wait_for(lambda: c1.runtime.pending.count == 0)

    reply = admin_rpc(front_end.port,
                      {"t": "admin_summarize", "tenant": "t", "doc": "doc"})
    assert reply.get("version")
    # the reply only lands after commit: a joiner can boot immediately
    f2 = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    c2 = Loader(f2).resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert wait_for(lambda: s2.get_text() == s1.get_text())
    assert f2.counters.snapshot().get("boot.snapshot.used") == 1

    err = admin_rpc(front_end.port,
                    {"t": "admin_summarize", "tenant": "t", "doc": "nope"})
    assert err.get("t") == "error" and "unknown doc" in err["message"]
    # the refusal must not have created the doc server-side
    assert "t/nope" not in front_end.server._orderers


def test_encode_once_across_joiner_burst(front_end):
    """N joiners from N cold caches: the server frames each chunk exactly
    once per summary version — byte-identical splices for everyone."""
    server = front_end.server
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1, s1 = make_doc(loader, "t", "burst", n_ops=80)
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    summarize(server, "t", "burst")

    joiners = []
    for _ in range(4):
        f = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
        joiners.append((f, Loader(f).resolve("t", "burst")))
    for f, c in joiners:
        s = c.runtime.get_data_store("default").get_channel("text")
        assert wait_for(lambda: s.get_text() == s1.get_text())
        assert f.counters.snapshot().get("boot.snapshot.used") == 1

    srv = front_end.counters.snapshot()
    assert srv.get("storage.snapshot.encodes") == 1, \
        "per-join re-encodes must be zero"
    assert srv.get("storage.snapshot.served") == 4
    assert srv.get("storage.snapshot.cache_hits") == 3
    # nobody fell back to the legacy whole-tree JSON shim
    assert not srv.get("storage.snapshot.legacy_tree")


def test_client_chunk_cache_skips_refetch(front_end):
    """A factory that already holds the chunks (content-addressed) boots
    a second container without refetching them — the ``have`` list lets
    the server skip the push entirely."""
    server = front_end.server
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1, s1 = make_doc(loader, "t", "doc", n_ops=50)
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    summarize(server, "t", "doc")

    c2 = loader.resolve("t", "doc")
    got = factory.counters.snapshot()
    fetched_once = got.get("boot.chunks.fetched", 0)
    assert got.get("boot.snapshot.used") == 1 and fetched_once >= 1

    # drop the version ENTRY but keep the chunks (invalidate's contract)
    factory.snapshot_cache.invalidate("t", "doc")
    c3 = loader.resolve("t", "doc")
    got = factory.counters.snapshot()
    assert got.get("boot.snapshot.used") == 2
    assert got.get("boot.chunks.cached", 0) >= 1
    assert got.get("boot.chunks.fetched") == fetched_once  # no refetch
    assert factory.snapshot_cache.chunk_stats["hits"] >= 1
    s3 = c3.runtime.get_data_store("default").get_channel("text")
    assert wait_for(lambda: s3.get_text() == s1.get_text())


def test_legacy_summary_at_head_uses_tree_shim(front_end):
    """A doc whose head summary predates snapcols boots through the
    legacy JSON tree RPC — counted on the deprecation counter, with the
    columnar attempt recorded as a fallback."""
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1, s1 = make_doc(loader, "t", "old", n_ops=20)
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    sm = SummaryManager(c1, max_ops=10**9)
    sm.summarize_now()
    assert wait_for(lambda: sm.summaries_acked == 1)

    f2 = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    c2 = Loader(f2).resolve("t", "old")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert wait_for(lambda: s2.get_text() == s1.get_text())
    got = f2.counters.snapshot()
    assert got.get("boot.snapshot.fallback") == 1
    assert not got.get("boot.snapshot.used")
    assert front_end.counters.snapshot().get(
        "storage.snapshot.legacy_tree", 0) >= 1


# =====================================================================
# torn / missing chunk → verified fallback (the chaos seam's unit twin)
# =====================================================================

def corrupt_cached_frame(front, tenant, doc, body_fn):
    vid, framed, root = front._snap_cache[(tenant, doc)]
    h0 = root["chunks"][0]
    framed = dict(framed)
    framed[h0] = binwire.frame(body_fn(h0))
    front._snap_cache[(tenant, doc)] = (vid, framed, root)


@pytest.mark.parametrize("mode", ["torn", "missing"])
def test_corrupt_chunk_falls_back_and_converges(front_end, mode):
    """A torn frame (bytes ≠ hash) or a frame for the wrong hash must be
    DETECTED client-side (sha256 verify) and heal through the legacy
    path — counted, never silently booted from garbage."""
    server = front_end.server
    factory = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    loader = Loader(factory)
    c1, s1 = make_doc(loader, "t", "doc", n_ops=50)
    assert wait_for(lambda: c1.runtime.pending.count == 0)
    summarize(server, "t", "doc")

    loader.resolve("t", "doc")  # primes the serving cache
    if mode == "torn":
        corrupt_cached_frame(
            front_end, "t", "doc",
            lambda h: binwire.snap_chunk_body(0, h, b"torn bytes"))
    else:
        corrupt_cached_frame(
            front_end, "t", "doc",
            lambda h: binwire.snap_chunk_body(0, "0" * 64, b"x"))

    f2 = NetworkDocumentServiceFactory("127.0.0.1", front_end.port)
    c2 = Loader(f2).resolve("t", "doc")
    got = f2.counters.snapshot()
    assert got.get("boot.snapshot.fallback") == 1
    assert not got.get("boot.snapshot.used")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert wait_for(lambda: s2.get_text() == s1.get_text())
    assert string_fingerprint(s2) == string_fingerprint(s1)


def _retention_clamped(s):
    truncated = s.mod("service.scriptorium").LogTruncatedError
    config = s.mod("config").Config
    server = s.st.server(config=config().with_overrides(log_retention_ops=0))
    loader = s.st.Loader(s.st.LocalDocumentServiceFactory(server))
    c1, s1 = make_doc(loader, "t", "doc", n_ops=30)
    orderer = server._get_orderer("t", "doc")
    orderer.apply_retention(orderer.deli.sequence_number)
    assert orderer.scriptorium.retained_base("t", "doc") == 0
    assert orderer.acked_boot_seq() is None
    summarize(server, "t", "doc", s.mod("service.service_summarizer"))
    boot_seq = orderer.acked_boot_seq()
    assert boot_seq is not None and boot_seq > 0
    base = orderer.scriptorium.retained_base("t", "doc")
    assert 0 < base <= boot_seq
    s1.insert_text(0, "after ")
    with pytest.raises(truncated) as ei:
        server.get_deltas("t", "doc", 0, orderer.deli.sequence_number + 1)
    assert ei.value.snapshot_seq == boot_seq
    c2 = loader.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == s1.get_text()
    orderer.apply_retention(boot_seq - 5)
    base2 = orderer.scriptorium.retained_base("t", "doc")
    assert base2 <= boot_seq
    s.note([boot_seq, base, base2, ei.value.base, s2.get_text(),
            stored(server)])


def test_retention_clamped_to_acked_boot_seq_local():
    both(_retention_clamped)


def test_stale_cache_reanchors_over_sockets():
    """The mid-trim race over real sockets: a joiner booting from a
    SUPERSEDED cached snapshot hits log_truncated on its backfill, and
    must re-anchor onto the newer summary instead of failing."""
    from fluidframework_tpu_torch.config import Config

    server = LocalServer(config=Config().with_overrides(log_retention_ops=0))
    fe = NetworkFrontEnd(server).start_background()
    try:
        factory = NetworkDocumentServiceFactory("127.0.0.1", fe.port)
        loader = Loader(factory)
        c1, s1 = make_doc(loader, "t", "doc", n_ops=30)
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        svc = ServiceSummarizer(server, HostReplicaSource(server))
        assert svc.summarize_doc("t", "doc") is not None

        # boot once to capture the (soon stale) cache entry
        loader.resolve("t", "doc")
        stale = factory.snapshot_cache.get("t", "doc")
        assert stale is not None

        # a second generation + trim: ops below the new boot seq vanish
        for i in range(20):
            s1.insert_text(0, f"gen2-{i} ")
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        assert svc.summarize_doc("t", "doc") is not None
        orderer = server._get_orderer("t", "doc")
        assert orderer.scriptorium.retained_base("t", "doc") \
            > stale["tree"]["sequence_number"]

        # resurrect the stale entry (the race: a boot that read the
        # cache just before the summary ack invalidated it)
        factory.snapshot_cache.put(
            "t", "doc", stale["version"], stale["tree"])
        c3 = loader.resolve("t", "doc")
        s3 = c3.runtime.get_data_store("default").get_channel("text")
        assert wait_for(lambda: s3.get_text() == s1.get_text())
        assert factory.counters.snapshot() \
            .get("boot.snapshot.reanchor") == 1
    finally:
        fe.stop()
