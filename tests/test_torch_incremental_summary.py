"""The port's incremental summaries (per-channel handle reuse, chunked
merge-tree snapshots, boot from the chain; ``runtime/summarizer.py`` and
the server's storage) against ``tests/test_incremental_summary.py``.

Each test is the twin of the JAX test of the same name. The in-process
scenarios run on each package's client stack and ``LocalServer``
(``torch_stack_fixtures.both``: a fixed client-id epoch and a clock at
0) with the JAX test's assertions; between the packages the storage
counters after each summary (blobs written, handles reused), the reused
handles and chunks as stored, the booted replicas' values and everything
the server stored (``torch_stack_fixtures.stored``) are equal exactly.
Tolerance: exact. The network case needs sockets: it runs the JAX test's
assertions on the port alone, its core a process of the port as in the
JAX test.
"""

import subprocess
import sys
import time
from pathlib import Path

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored

ROOT = Path(__file__).resolve().parent.parent


def boot_with_channels(loader):
    c1 = loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    kv = ds.create_channel("kv", "shared-map")
    text.insert_text(0, "hello world")
    kv.set("a", 1)
    return c1, text, kv


def _stats(s):
    return dict(s.server.storage_stats)


def _reuses_unchanged(s):
    c1, text, kv = boot_with_channels(s.loader)
    sm = s.st.SummaryManager(c1, max_ops=10**9)
    h1 = sm.summarize_now()
    assert sm.summaries_acked == 1 and sm.last_acked_handle == h1
    assert s.server.storage_stats["handles_reused"] == 0
    s.note(_stats(s))
    text.insert_text(0, ">> ")
    blobs_before = s.server.storage_stats["blobs_written"]
    h2 = sm.summarize_now()
    assert sm.summaries_acked == 2 and sm.last_acked_handle == h2
    assert s.server.storage_stats["handles_reused"] >= 1
    s.note(_stats(s))
    reused_before = s.server.storage_stats["handles_reused"]
    sm.summarize_now()
    assert sm.summaries_acked == 3
    assert s.server.storage_stats["handles_reused"] >= reused_before + 2
    c2 = s.loader.resolve("t", "doc")
    ds2 = c2.runtime.get_data_store("default")
    assert ds2.get_channel("text").get_text() == ">> hello world"
    assert ds2.get_channel("kv").get("a") == 1
    assert blobs_before > 0
    s.note([h1, h2, _stats(s), stored(s.server)])


def test_second_summary_reuses_unchanged_channels():
    both(_reuses_unchanged)


def _fewer_bytes(s):
    c1 = s.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    kv = ds.create_channel("kv", "shared-map")
    for i in range(40):
        text.insert_text(0, f"paragraph {i} of substantial content. ")
    sm = s.st.SummaryManager(c1, max_ops=10**9)
    before = s.server.storage_stats["blobs_written"]
    sm.summarize_now()
    full_blobs = s.server.storage_stats["blobs_written"] - before
    kv.set("tiny", 1)
    before = s.server.storage_stats["blobs_written"]
    sm.summarize_now()
    incr_blobs = s.server.storage_stats["blobs_written"] - before
    assert incr_blobs < full_blobs
    s.note([full_blobs, incr_blobs, _stats(s), stored(s.server)])


def test_incremental_upload_writes_fewer_bytes():
    both(_fewer_bytes)


def _chunked(s):
    c1 = s.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    text.SUMMARY_CHUNK_SEGMENTS = 8
    for i in range(30):
        text.insert_text(len(text.get_text()) // 2, f"[{i}]")
    text.annotate_range(0, 5, {"bold": True})
    sm = s.st.SummaryManager(c1, max_ops=10**9)
    before = s.server.storage_stats["blobs_written"]
    sm.summarize_now()
    written = s.server.storage_stats["blobs_written"] - before
    assert written > 3
    c2 = s.loader.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == text.get_text()
    assert s2.client.get_properties_at(0).get("bold") is True
    s2.insert_text(0, "x")
    assert text.get_text() == s2.get_text()
    s.note([written, s2.get_text(), _stats(s), stored(s.server)])


def test_chunked_mergetree_summary_round_trips():
    both(_chunked)


def wait_for(cond, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_incremental_chain_over_network_driver():
    """Summaries upload as wire-encoded trees through the port's TCP
    storage RPC and a fresh network client boots from the chain."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        port = int(line.rsplit(":", 1)[1])
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c1 = loader.resolve("t", "netsumdoc")
        ds = c1.runtime.create_data_store("default")
        text = ds.create_channel("text", "shared-string")
        kv = ds.create_channel("kv", "shared-map")
        text.insert_text(0, "over the wire")
        kv.set("k", "v")
        sm = SummaryManager(c1, max_ops=10**9)
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        sm.summarize_now()
        assert wait_for(lambda: sm.summaries_acked == 1)
        text.insert_text(0, "!! ")
        assert wait_for(lambda: c1.runtime.pending.count == 0)
        sm.summarize_now()
        assert wait_for(lambda: sm.summaries_acked == 2)
        c2 = loader.resolve("t", "netsumdoc")
        ds2 = c2.runtime.get_data_store("default")
        assert ds2.get_channel("text").get_text() == "!! over the wire"
        assert ds2.get_channel("kv").get("k") == "v"
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _survives_restart(s):
    c1, text, kv = boot_with_channels(s.loader)
    sm1 = s.st.SummaryManager(c1, max_ops=10**9)
    sm1.summarize_now()
    c1.close()
    c2 = s.loader.resolve("t", "doc")
    assert c2._base_snapshot is not None
    sm2 = s.st.SummaryManager(c2, max_ops=10**9)
    sm2.summarize_now()
    assert sm2.summaries_acked == 1
    reused_before = s.server.storage_stats["handles_reused"]
    sm2.summarize_now()
    assert sm2.summaries_acked == 2
    assert s.server.storage_stats["handles_reused"] >= reused_before + 2
    s.note([reused_before, _stats(s), stored(s.server)])


def test_handle_reuse_survives_summarizer_restart():
    both(_survives_restart)
