"""Lazy cold boot twin: ``LocalOrderer(lazy_boot=)``, ``LocalServer``'s
lazy boot with its rehydrator and the front end's boot admission in the
port, against the JAX package's, on the CPU.

The lazy-boot cases of ``tests/test_cold_start.py`` run through both
packages at seeds 0, 7 and 42: a corpus (a durable log and a chunk store:
seeded edits, a summary and a checkpoint, a tail after them, then the
server abandoned) boots lazily from its summary plus the tail and equals a
whole-log replay; the port boots the JAX package's corpus and the other
way round, to the same text and boot mode. An unsummarized doc replays
its whole log, a fresh doc counts fresh, and the rehydration executor
parks a boot storm on the retry lane, in process and over a socket.
"""

from __future__ import annotations

import random
import shutil
import time
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]

    def mod(path):
        return import_module(f"{root}.{path}")

    summ = mod("service.service_summarizer")
    rehydrate = mod("service.rehydrate")
    return SimpleNamespace(
        mod=mod,
        Loader=mod("loader").Loader,
        LocalDocumentServiceFactory=mod(
            "driver.local").LocalDocumentServiceFactory,
        DurableLog=mod("service.durable_log").DurableLog,
        LocalServer=mod("service.local_server").LocalServer,
        ServiceSummarizer=summ.ServiceSummarizer,
        HostReplicaSource=summ.HostReplicaSource,
        BootPending=rehydrate.BootPending,
        RehydrationExecutor=rehydrate.RehydrationExecutor,
        boot_counters=rehydrate.boot_counters)


PKGS = {name: _pkg(name) for name in ROOTS}
PORT = PKGS["torch"]


def wait_for(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _seeded_edits(s, rng, n):
    for i in range(n):
        text = s.get_text()
        if text and rng.random() < 0.3:
            at = rng.randrange(len(text))
            s.remove_text(at, min(len(text), at + rng.randint(1, 4)))
        else:
            at = rng.randrange(len(text) + 1)
            s.insert_text(at, f"w{i}-{rng.randint(0, 999)} ")


def _delta(P, before):
    after = P.boot_counters().snapshot()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before)}


def _build_corpus(P, tmp_path, seed, docs=("a", "b"), head=30, tail=12):
    """Seeded edits, a summary and a checkpoint mid-stream, a tail after
    them, then the server abandoned without close (a crash's aftermath).
    """
    tmp_path.mkdir(parents=True, exist_ok=True)
    log_dir, store_dir = str(tmp_path / "log"), str(tmp_path / "store")
    server = P.LocalServer(log=P.DurableLog(log_dir), storage_dir=store_dir)
    loader = P.Loader(P.LocalDocumentServiceFactory(server))
    rng = random.Random(seed)
    texts = {}
    for doc in docs:
        c = loader.resolve("t", doc)
        s = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        _seeded_edits(s, rng, head)
        svc = P.ServiceSummarizer(server, P.HostReplicaSource(server))
        assert svc.summarize_doc("t", doc) is not None
        _seeded_edits(s, rng, tail)
        texts[doc] = s.get_text()
        assert texts[doc]
    server.checkpoint_all()
    server.log.flush()
    return log_dir, store_dir, texts


def _boot_text(P, log_dir, store_dir, doc, lazy):
    server = P.LocalServer(log=P.DurableLog(log_dir), storage_dir=store_dir)
    server.lazy_boot = lazy
    loader = P.Loader(P.LocalDocumentServiceFactory(server))
    c = loader.resolve("t", doc)
    assert wait_for(
        lambda: "default" in c.runtime.data_stores
        and "text" in c.runtime.get_data_store("default").channels), \
        f"doc {doc} never materialized after boot"
    text = c.runtime.get_data_store("default").get_channel(
        "text").get_text()
    return text, server._orderers[f"t/{doc}"].boot_mode


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_lazy_boot_equals_full_replay(tmp_path, seed):
    """Per package: lazy boot == whole-log replay == the writer's text,
    counted ``boot.part.lazy`` and never ``full_replay``. Across
    packages: the corpora and every boot's text are equal, and each
    package lazily boots the other's corpus to the same text."""
    results = {}
    corpora = {}
    for name, P in PKGS.items():
        log_dir, store_dir, texts = _build_corpus(P, tmp_path / name, seed)
        corpora[name] = (log_dir, store_dir, texts)
        before = P.boot_counters().snapshot()
        for doc, want in texts.items():
            lazy_dir = str(tmp_path / name / f"lazy-{doc}")
            full_dir = str(tmp_path / name / f"full-{doc}")
            shutil.copytree(log_dir, lazy_dir)
            shutil.copytree(log_dir, full_dir)
            lazy = _boot_text(P, lazy_dir, store_dir, doc, lazy=True)
            full = _boot_text(P, full_dir, store_dir, doc, lazy=False)
            assert lazy == (want, "lazy") and full == (want, None)
            results[name, doc] = lazy
        delta = _delta(P, before)
        assert delta.get("boot.part.lazy", 0) == len(texts)
        assert delta.get("boot.part.full_replay", 0) == 0
    assert corpora["torch"][2] == corpora["jax"][2]
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        log_dir, store_dir, texts = corpora[writer]
        for doc in texts:
            crossed = str(tmp_path / f"{reader}-boots-{writer}-{doc}")
            shutil.copytree(log_dir, crossed)
            assert _boot_text(PKGS[reader], crossed, store_dir, doc,
                              lazy=True) == results[writer, doc]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_unsummarized_doc_full_replays_and_converges(tmp_path, pkg):
    """No checkpoint or summary: the whole-log replay, counted so."""
    P = PKGS[pkg]
    log_dir = str(tmp_path / "log")
    server = P.LocalServer(log=P.DurableLog(log_dir))
    loader = P.Loader(P.LocalDocumentServiceFactory(server))
    s = loader.resolve("t", "raw").runtime.create_data_store(
        "default").create_channel("text", "shared-string")
    for i in range(10):
        s.insert_text(0, f"x{i} ")
    want = s.get_text()
    server.log.flush()
    before = P.boot_counters().snapshot()
    # the port boots the log whichever package wrote it
    assert _boot_text(PORT, log_dir, str(tmp_path / "store"), "raw",
                      lazy=True) == (want, "full_replay")
    delta = _delta(PORT, before if P is PORT else {})
    assert delta.get("boot.part.full_replay", 0) >= 1
    if P is PORT:
        assert delta.get("boot.part.full_replay", 0) == 1
        assert delta.get("boot.part.lazy", 0) == 0


def test_fresh_doc_counts_fresh(tmp_path):
    server = PORT.LocalServer(log=PORT.DurableLog(str(tmp_path / "log")))
    server.lazy_boot = True
    before = PORT.boot_counters().snapshot()
    loader = PORT.Loader(PORT.LocalDocumentServiceFactory(server))
    loader.resolve("t", "newdoc").runtime.create_data_store("default")
    delta = _delta(PORT, before)
    assert delta.get("boot.part.fresh", 0) == 1
    assert delta.get("boot.part.full_replay", 0) == 0


def test_storm_parks_then_serves_in_connect_path(tmp_path):
    """Through ``LocalServer.connect``: warm docs bypass admission, cold
    boots beyond the budget park with a retry hint, in both packages
    with the same executor accounting."""
    out = {}
    for name, P in PKGS.items():
        (tmp_path / name).mkdir()
        server = P.LocalServer(
            log=P.DurableLog(str(tmp_path / name / "log")))
        server.lazy_boot = True
        now = [0.0]
        server.rehydrator = P.RehydrationExecutor(
            boots_per_s=10.0, burst=1, clock=lambda: now[0])
        before = P.boot_counters().snapshot()
        loader = P.Loader(P.LocalDocumentServiceFactory(server))
        loader.resolve("t", "cold0")
        with pytest.raises(P.BootPending) as err:
            loader.resolve("t", "cold1")
        loader.resolve("t", "cold0")
        parked = _delta(P, before).get("boot.part.parked", 0)
        now[0] += 0.2
        loader.resolve("t", "cold1")
        out[name] = (parked, err.value.retry_after_ms,
                     server.rehydrator.status())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 1 and out["torch"][2]["booted"] == 2


def test_boot_pending_retries_transparently_over_network(tmp_path):
    """``BootPending`` → an error frame with code ``boot_pending`` → the
    port's driver retries → the connect succeeds; the port's front end
    arms the executor with ``enable_boot_admission``."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.obs import tier_snapshot
    from fluidframework_tpu_torch.service.front_end import NetworkFrontEnd

    server = PORT.LocalServer(log=PORT.DurableLog(str(tmp_path / "log")))
    server.lazy_boot = True
    fe = NetworkFrontEnd(server).start_background()
    fe.enable_boot_admission(boots_per_s=5.0, burst=1)
    assert server.rehydrator is not None
    before = tier_snapshot("driver").get("boot.parked.retries", 0)
    try:
        loader = PORT.Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port))
        c0 = loader.resolve("t", "na")
        c1 = loader.resolve("t", "nb")
        s = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s.insert_text(0, "storm survivor")
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        assert tier_snapshot("driver").get(
            "boot.parked.retries", 0) - before >= 1
        assert c0.connected and c1.connected
    finally:
        fe.stop()
