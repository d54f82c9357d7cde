"""The port's doc history plane on the CPU, and against the JAX package's.

Every test of ``tests/test_history_plane.py`` but the socket one (the
network history doors are not ported), run on the port: the commit/ref
codec with its torn-tail recovery, the O(snapshot) fork against a
whole-log replay, time travel, history reads below the retention base,
CRDT-mediated integrate with concurrent writers, chunk GC's pins and
sweeps, the crash-mid-fork adopt-or-discard contract and the history-first
replay tool. Then one fork / time-travel / integrate / GC script through
both packages on deterministic servers: refs, commit fields (all but the
wall-clock ``ts``), fork results and boots, time-travel texts, integrate
results, pinned and swept chunk sets and every stored record equal
exactly.
"""

from __future__ import annotations

import os
import random
import tempfile

import pytest

from tests.torch_stack_fixtures import history_records, stack, stored
from fluidframework_tpu_torch.chaos.hooks import armed
from fluidframework_tpu_torch.chaos.plane import FaultPlane, SimulatedCrash
from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
from fluidframework_tpu_torch.driver.file import (
    FileDocumentService,
    record_document,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.loader.container import Container
from fluidframework_tpu_torch.obs import tier_snapshot
from fluidframework_tpu_torch.protocol import refgraph
from fluidframework_tpu_torch.service.history_plane import (
    MAIN_REF,
    HistoryPlane,
    fork_pin_ref,
)
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.service_summarizer import (
    HostReplicaSource,
    ServiceSummarizer,
)

SEEDS = (0, 7, 42)


@pytest.fixture
def server():
    return LocalServer()


@pytest.fixture
def loader(server):
    return Loader(LocalDocumentServiceFactory(server))


def summarize(server, tenant, doc):
    return ServiceSummarizer(
        server, HostReplicaSource(server)).summarize_doc(tenant, doc)


def head_seq(server, tenant, doc):
    return server._get_orderer(tenant, doc).deli.sequence_number


def get_text(container):
    return container.runtime.get_data_store(
        "default").get_channel("text").get_text()


# ================================================================ codec


def _sample_commit(i=0):
    return {"id": f"c{i:04x}", "version": f"v{i}", "base_seq": 10 * i,
            "parents": [f"c{i - 1:04x}"] if i else [],
            "chunk_ids": [f"chunk{i}", f"chunk{i + 1}"],
            "ts": 1700000000.0 + i,
            "extra": {"fork_of": {"tenant": "t", "doc": "d", "seq": i}}
            if i % 3 == 0 else {}}


def test_codec_roundtrip_all_kinds():
    payloads = [refgraph.encode_commit(_sample_commit(i)) for i in range(4)]
    payloads.append(refgraph.encode_ref(MAIN_REF, "c0002", ts=5.0))
    payloads.append(refgraph.encode_ref("fork/t/d2", None))
    payloads.append(refgraph.encode_discard("c0003"))
    buf = b"".join(refgraph.frame_record(p) for p in payloads)
    records, clean = refgraph.scan_records(buf)
    assert clean == len(buf)
    assert [r["t"] for r in records] == ["commit"] * 4 + ["ref", "ref",
                                                          "discard"]
    for i in range(4):
        want = _sample_commit(i)
        got = {k: records[i][k] for k in want}
        assert got == want
    assert records[4] == {"t": "ref", "name": MAIN_REF, "commit": "c0002",
                          "ts": 5.0}
    assert records[5]["commit"] is None  # empty id = ref delete
    commits, refs, discarded = refgraph.replay_records(records)
    assert set(commits) == {f"c{i:04x}" for i in range(4)}
    assert refs == {MAIN_REF: "c0002"}
    assert discarded == {"c0003"}
    # the JAX package's codec writes the same bytes
    from fluidframework_tpu.protocol import refgraph as jax_refgraph

    assert buf == b"".join(jax_refgraph.frame_record(p) for p in [
        jax_refgraph.encode_commit(_sample_commit(i)) for i in range(4)] + [
        jax_refgraph.encode_ref(MAIN_REF, "c0002", ts=5.0),
        jax_refgraph.encode_ref("fork/t/d2", None),
        jax_refgraph.encode_discard("c0003")])


@pytest.mark.parametrize("seed", SEEDS)
def test_codec_torn_tail_fuzz(seed):
    """A tear at ANY byte offset decodes to a clean record prefix —
    never an exception, never a corrupt record — and RefLog heals the
    tear on its next append."""
    rng = random.Random(seed)
    payloads = [refgraph.encode_commit(_sample_commit(i)) for i in range(6)]
    payloads.append(refgraph.encode_ref(MAIN_REF, "c0005", ts=1.0))
    frames = [refgraph.frame_record(p) for p in payloads]
    buf = b"".join(frames)
    ends = [0]
    for f in frames:
        ends.append(ends[-1] + len(f))

    cuts = {rng.randrange(len(buf) + 1) for _ in range(200)}
    cuts.update(ends)  # every clean boundary too
    for cut in sorted(cuts):
        records, clean = refgraph.scan_records(buf[:cut])
        # clean prefix = the greatest whole-record boundary <= cut
        want_n = max(i for i, e in enumerate(ends) if e <= cut)
        assert len(records) == want_n, f"cut at {cut}"
        assert clean == ends[want_n]
        for i, rec in enumerate(records[:6]):
            assert rec["id"] == f"c{i:04x}"

    # flipping a byte inside a payload kills that record AND the tail
    # (CRC gate) but never the records before it
    pos = len(frames[0]) + 12
    flipped = bytearray(buf)
    flipped[pos] ^= 0xFF
    records, clean = refgraph.scan_records(bytes(flipped))
    assert len(records) == 1 and clean == ends[1]

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "doc.hist")
        log = refgraph.RefLog(path)
        log.append(*payloads)
        tear = ends[3] + rng.randrange(1, len(frames[3]))
        log.truncate_at(tear)
        assert len(log.load()) == 3
        log.append(refgraph.encode_discard("c0001"))
        records = log.load()  # healed: clean prefix + the new record
        assert [r["t"] for r in records] == ["commit"] * 3 + ["discard"]


# ==================================================== fork equivalence


def _drive_doc(server, loader, doc, seed, rounds=36):
    """Deterministic editing session; returns (channel, {seq: text})."""
    rng = random.Random(seed)
    c = loader.resolve("t", doc)
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "base text. ")
    oracle = {}
    for r in range(rounds):
        length = len(s.get_text())
        roll = rng.random()
        if roll < 0.6 or length < 5:
            s.insert_text(rng.randrange(length + 1), f"w{r} ")
        elif roll < 0.85:
            a = rng.randrange(length - 2)
            s.remove_text(a, min(length, a + 1 + rng.randrange(3)))
        else:
            a = rng.randrange(length - 2)
            s.annotate_range(a, min(length, a + 2), {"k": r % 4})
        oracle[head_seq(server, "t", doc)] = s.get_text()
        if r == rounds // 3:
            summarize(server, "t", doc)
    return s, oracle


@pytest.mark.parametrize("seed", SEEDS)
def test_fork_boot_equals_whole_log_replay(server, loader, seed):
    """The O(snapshot) fork boot must agree byte-for-byte with a legacy
    whole-log replay of the parent advanced to the same seq."""
    doc = f"doc{seed}"
    s, oracle = _drive_doc(server, loader, doc, seed)
    probed = sorted(q for q in oracle
                    if q > 2 * len(oracle) // 3)  # past the summary
    fork_seq = probed[len(probed) // 2]

    res = server.history.fork("t", doc, at_seq=fork_seq,
                              new_doc=f"{doc}-fork")
    assert res["base_seq"] <= fork_seq <= res["fork_seq"]
    assert res["shared_chunks"] > 0  # content-addressed: zero new bytes
    fork_text = get_text(loader.resolve("t", f"{doc}-fork"))
    assert fork_text == oracle[fork_seq]

    with tempfile.TemporaryDirectory() as d:
        doc_dir = record_document(server, "t", doc, d)
        os.remove(os.path.join(doc_dir, "snapshot.json"))
        whole = Container(FileDocumentService.from_dir(doc_dir)).load(
            connect=False)
        whole.delta_manager.advance_to(fork_seq)
        assert get_text(whole) == fork_text


# ========================================================= time travel


def test_time_travel_reads(server, loader):
    doc = "tt"
    s, oracle = _drive_doc(server, loader, doc, seed=1)
    summarize(server, "t", doc)
    mid = sorted(oracle)[len(oracle) // 2]
    tail = max(oracle)

    at = server.history.replay_read("t", doc, mid)
    assert at["base_seq"] <= mid
    assert at["commit"]["version"] == at["version"]["id"]

    for q in (mid, tail):
        hc = loader.resolve_at("t", doc, q)
        assert get_text(hc) == oracle[q]
        assert hc.readonly and not hc.connected
    hc = loader.resolve_at("t", doc, mid)
    with pytest.raises(PermissionError, match="readonly"):
        hc.runtime.get_data_store("default").get_channel(
            "text").insert_text(0, "nope")
    svc = LocalDocumentServiceFactory(server).create_document_service(
        "t", doc)
    with pytest.raises(RuntimeError, match="offline"):
        svc.history().replay_service(mid).connect_to_delta_stream()

    # newest-first log, refs/main at the newest commit
    log = server.history.log("t", doc)
    assert len(log) >= 2
    assert [c["base_seq"] for c in log] == sorted(
        (c["base_seq"] for c in log), reverse=True)
    assert server.history.refs("t", doc)[MAIN_REF] == log[0]["id"]


def test_history_reads_survive_retention_trim(server, loader):
    """History reads are explicitly historical: a range below the
    retention base falls back to the durable-log scan instead of
    refusing with log_truncated."""
    doc = "trim"
    s, oracle = _drive_doc(server, loader, doc, seed=3)
    version = summarize(server, "t", doc)
    assert version
    trim_at = head_seq(server, "t", doc)
    orderer = server._get_orderer("t", doc)
    dropped = orderer.scriptorium.truncate_below("t", doc, trim_at)
    assert dropped > 0
    before = tier_snapshot("service").get("history.replay.log_scans", 0)
    early = sorted(oracle)[3]
    msgs = server.history.read_deltas("t", doc, 0, early + 1)
    assert msgs and msgs[-1].sequence_number == early
    assert tier_snapshot("service").get(
        "history.replay.log_scans", 0) > before


# =========================================================== integrate


@pytest.mark.parametrize("seed", SEEDS)
def test_integrate_equivalence_with_concurrent_writers(server, loader,
                                                       seed):
    """Integrate rides the ordinary total order, so every parent
    replica — live clients AND a from-scratch boot — converges to one
    text that carries both the fork's and the concurrent writers'
    edits."""
    rng = random.Random(seed)
    doc = f"int{seed}"
    s, _ = _drive_doc(server, loader, doc, seed, rounds=20)
    summarize(server, "t", doc)
    server.history.fork("t", doc, new_doc=f"{doc}-fork")

    fc = loader.resolve("t", f"{doc}-fork")
    ft = fc.runtime.get_data_store("default").get_channel("text")
    writer = loader.resolve("t", doc)
    wt = writer.runtime.get_data_store("default").get_channel("text")
    for i in range(8):  # interleaved fork + parent edits
        ft.insert_text(rng.randrange(len(ft.get_text()) + 1), f"F{i} ")
        wt.insert_text(rng.randrange(len(wt.get_text()) + 1), f"P{i} ")

    out = server.history.integrate("t", f"{doc}-fork")
    assert out["parent"] == doc and out["ops"] == 8

    texts = {s.get_text(), wt.get_text(),
             get_text(loader.resolve("t", doc))}
    assert len(texts) == 1, "parent replicas diverged after integrate"
    merged = texts.pop()
    assert merged.count("F") == 8 and merged.count("P") == 8
    assert get_text(fc) == ft.get_text()  # fork untouched by integrate

    with pytest.raises(ValueError, match="not a fork"):
        server.history.integrate("t", doc)


# ================================================================== GC


def test_gc_pins_fork_chunks_and_sweeps_dead_ones(server, loader):
    """Both sides of the ref-count: trimming the parent's history never
    unlinks chunks a live fork pin can still boot from, while commits no
    ref reaches are swept."""
    doc = "gcdoc"
    c = loader.resolve("t", doc)
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "gen one ")
    summarize(server, "t", doc)
    gen1 = server.history.log("t", doc)[0]
    server.history.fork("t", doc, new_doc=f"{doc}-fork")

    # rewrite everything so generation 2 shares no chunks with gen 1
    s.remove_text(0, len(s.get_text()))
    s.insert_text(0, "generation two content, fully rewritten ")
    summarize(server, "t", doc)
    gen2 = server.history.log("t", doc)[0]
    dead_if_unpinned = set(gen1["chunk_ids"]) - set(gen2["chunk_ids"])
    assert dead_if_unpinned, "generations unexpectedly share all chunks"

    # pinned side: the fork's pin holds gen1 alive through a GC
    out = server.history.gc_chunks("t")
    assert out["deleted"] == 0
    assert set(gen1["chunk_ids"]) <= server.history.pinned_chunks("t", doc)
    for cid in gen1["chunk_ids"]:
        assert server.blob_store.get(cid) is not None
    fork_boot = loader.resolve("t", f"{doc}-fork")
    assert "gen one" in get_text(fork_boot)

    # unpinned side: drop the pin (as an integrated-and-released fork
    # would) and the same sweep reclaims gen1's now-unreachable chunks
    pstore = server.history._store("t", doc)
    pin = fork_pin_ref("t", f"{doc}-fork")
    server.history._append(pstore, refgraph.encode_ref(pin, None))
    server.history._set_ref(pstore, pin, None)
    out = server.history.gc_chunks("t", documents=[doc])
    assert out["deleted"] >= len(dead_if_unpinned)
    for cid in dead_if_unpinned:
        with pytest.raises(KeyError):
            server.blob_store.get(cid)
    for cid in gen2["chunk_ids"]:  # refs/main still pins gen2
        assert server.blob_store.get(cid) is not None


# ==================================================== crash mid-fork


def test_crash_mid_fork_adopt_or_discard(server, loader):
    """Tear a fork at both windows; a rebuilt plane (the restart) must
    leave the graph consistent: unseeded commit discarded, seeded
    commit adopted, never a dangling ref either way."""
    doc = "crashy"
    _drive_doc(server, loader, doc, seed=5, rounds=12)
    summarize(server, "t", doc)
    plane = FaultPlane(0)
    plane.rule("history.fork", "crash", at=1,
               when=lambda ctx: ctx.get("stage") == "commit")
    plane.rule("history.fork", "crash", at=1,
               when=lambda ctx: ctx.get("stage") == "seeded")
    with armed(plane, server=server):
        with pytest.raises(SimulatedCrash):
            server.history.fork("t", doc, new_doc="f-torn")
        reboot1 = HistoryPlane(server)
        fstore = reboot1._store("t", "f-torn")
        pstore = reboot1._store("t", doc)
        assert fstore.commits and not fstore.refs  # discarded, not adopted
        assert set(fstore.commits) <= fstore.discarded
        assert fork_pin_ref("t", "f-torn") not in pstore.refs
        assert reboot1.log("t", "f-torn") == []  # discard filters the log

        with pytest.raises(SimulatedCrash):
            server.history.fork("t", doc, new_doc="f-seeded")
        reboot2 = HistoryPlane(server)
        fstore = reboot2._store("t", "f-seeded")
        pstore = reboot2._store("t", doc)
        assert MAIN_REF in fstore.refs  # adopted: refs restored
        assert fstore.refs[MAIN_REF] in fstore.commits
        assert fork_pin_ref("t", "f-seeded") in pstore.refs
    # both planes still alive here: the registry tracks their counters
    assert reboot1.counters.snapshot().get("history.ref.recovered") == 1
    assert reboot2.counters.snapshot().get("history.ref.recovered") == 1
    # the adopted fork is a real doc: it boots and reads
    assert get_text(loader.resolve("t", "f-seeded"))


# ========================================================= replay tool


def test_replay_tool_history_first_vs_legacy(server, loader):
    """The unified replay tool: live docs with a committed version boot
    history-first; file-driver docs without one replay the whole log and
    count under history.replay.legacy — and the two agree."""
    doc = "rp"
    s, _ = _drive_doc(server, loader, doc, seed=9, rounds=18)
    summarize(server, "t", doc)
    s.insert_text(0, "tail ")
    from fluidframework_tpu_torch.replay.tool import ReplayController

    svc = LocalDocumentServiceFactory(server).create_document_service(
        "t", doc)
    hist = ReplayController(svc)
    assert hist.history is not None
    assert hist.container.delta_manager.last_processed_seq > 0  # O(snap)
    got = hist.run(10)

    with tempfile.TemporaryDirectory() as d:
        doc_dir = record_document(server, "t", doc, d)
        os.remove(os.path.join(doc_dir, "snapshot.json"))
        before = tier_snapshot("driver").get("history.replay.legacy", 0)
        legacy = ReplayController(FileDocumentService.from_dir(doc_dir))
        assert legacy.history is None
        got2 = legacy.run(10)
        assert tier_snapshot("driver").get(
            "history.replay.legacy", 0) == before + 1
    assert got["final_text"] == got2["final_text"] == s.get_text()
    common = set(got["snapshots"]) & set(got2["snapshots"])
    assert common
    for q in common:
        assert got["snapshots"][q] == got2["snapshots"][q]


# ============================================= the two packages, one script


def _without_ts(commit: dict) -> dict:
    return {k: v for k, v in commit.items() if k != "ts"}


def _history_script(pkg: str) -> dict:
    """Summaries, time travel, a fork at an explicit seq and name, edits
    on the fork, integrate, a rewrite and GC (pinned, then unpinned), on
    a deterministic server of ``pkg``. Returns everything observable."""
    from importlib import import_module

    root = {"jax": "fluidframework_tpu",
            "torch": "fluidframework_tpu_torch"}[pkg]
    summ = import_module(root + ".service.service_summarizer")
    hp = import_module(root + ".service.history_plane")
    rg = import_module(root + ".protocol.refgraph")
    st = stack(pkg)
    server = st.server()
    loader = st.Loader(st.LocalDocumentServiceFactory(server))

    def summarize_p():
        return summ.ServiceSummarizer(
            server, summ.HostReplicaSource(server)).summarize_doc("t", "p")

    rng = random.Random(17)
    s = loader.resolve("t", "p").runtime.create_data_store(
        "default").create_channel("text", "shared-string")
    s.insert_text(0, "history of p. ")
    oracle = {}
    for r in range(24):
        n = len(s.get_text())
        if rng.random() < 0.65 or n < 6:
            s.insert_text(rng.randrange(n + 1), f"r{r} ")
        else:
            a = rng.randrange(n - 3)
            s.remove_text(a, a + 1 + rng.randrange(3))
        oracle[head_seq(server, "t", "p")] = s.get_text()
        if r in (7, 15):
            summarize_p()
    out = {"oracle": oracle}
    seqs = sorted(oracle)
    plane = server.history
    out["log"] = [_without_ts(c) for c in plane.log("t", "p")]
    out["refs"] = plane.refs("t", "p")
    out["travel"] = {q: get_text(loader.resolve_at("t", "p", q))
                     for q in (seqs[9], seqs[16], seqs[-1])}
    out["at"] = {q: {**plane.replay_read("t", "p", q),
                     "commit": _without_ts(
                         plane.replay_read("t", "p", q)["commit"])}
                 for q in (seqs[9], seqs[-1])}
    fork_seq = seqs[-4]
    out["fork"] = plane.fork("t", "p", at_seq=fork_seq, new_doc="p-fork")
    fc = loader.resolve("t", "p-fork")
    ft = fc.runtime.get_data_store("default").get_channel("text")
    out["fork_boot"] = ft.get_text()
    for i in range(5):
        ft.insert_text(rng.randrange(len(ft.get_text()) + 1), f"<f{i}>")
    out["fork_text"] = ft.get_text()
    out["integrate"] = plane.integrate("t", "p-fork")
    out["parent_text"] = get_text(loader.resolve("t", "p"))
    s.remove_text(0, len(s.get_text()))
    s.insert_text(0, "p rewritten after the integrate ")
    summarize_p()
    out["pinned"] = sorted(plane.pinned_chunks("t", "p"))
    out["gc_pinned"] = plane.gc_chunks("t")
    fork_chunks = plane.log("t", "p-fork")[-1]["chunk_ids"]
    out["fork_chunks_kept"] = all(server.blob_store.has(c)
                                  for c in fork_chunks)
    pin = hp.fork_pin_ref("t", "p-fork")
    pstore = plane._store("t", "p")
    plane._append(pstore, rg.encode_ref(pin, None))
    plane._set_ref(pstore, pin, None)
    before = set(server.db.collection("blobs"))
    out["gc_unpinned"] = plane.gc_chunks("t", documents=["p"])
    out["swept"] = sorted(before - set(server.db.collection("blobs")))
    out["final_log"] = [_without_ts(c) for c in plane.log("t", "p")]
    out["final_refs"] = {d: plane.refs("t", d) for d in ("p", "p-fork")}
    out["records"] = history_records(server)
    out["stored"] = stored(server)
    return out


def test_history_script_equals_jax():
    got, want = _history_script("torch"), _history_script("jax")
    for key in want:
        assert got[key] == want[key], key
    # the script reached every path it means to
    assert len(want["log"]) == 2 and want["fork"]["shared_chunks"] > 0
    assert want["fork"]["tail_ops"] > 0
    assert want["fork_boot"] == want["oracle"][want["fork"]["fork_seq"]]
    assert want["integrate"]["ops"] == 5
    assert want["parent_text"].count("<f") == 5
    assert want["fork_chunks_kept"] and want["swept"]
    assert any(n.startswith("db:history-records/") for n in want["stored"])
