"""History and replay over the network, in the port against the JAX
package.

The twin of ``tests/test_history_plane.py::test_history_over_sockets``
against the port's front end: the history doors (commits as binary
FT_HISTORY frames), time travel, fork and integrate over sockets; then
the port's ``NetworkHistoryClient`` must read exactly what a
``LocalHistoryClient`` reads on the same server. The twin of
``tests/test_replay.py::test_fetch_live_doc_then_replay_offline``: a live
doc aged past an acked summary under retention 0, fetched from one JAX
front end by both packages' ``fetch_document``, gives equal directories,
and the port replays its copy offline to the live text. The replay
tool's ``--port`` replays a live doc of the port's front end from its
history plane.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.driver.history import LocalHistoryClient
from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
    _Transport,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.obs import tier_snapshot
from fluidframework_tpu_torch.protocol.serialization import message_to_dict
from fluidframework_tpu_torch.service import NetworkFrontEnd
from fluidframework_tpu_torch.service.history_plane import MAIN_REF
from fluidframework_tpu_torch.service.local_server import LocalServer


def wait_for(pred, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def get_text(container):
    return container.runtime.get_data_store(
        "default").get_channel("text").get_text()


def test_history_over_sockets():
    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        factory = NetworkDocumentServiceFactory("127.0.0.1", fe.port)
        loader = Loader(factory)
        c = loader.resolve("t", "doc")
        text = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        for i in range(25):
            text.insert_text(0, f"x{i} ")
        assert wait_for(lambda: text.get_text().startswith("x24 "))
        # every edit acked before the status and the fork read the head
        assert wait_for(lambda: c.runtime.pending.count == 0)
        svc = factory.create_document_service("t", "doc")
        svc._rpc_transport().request(
            {"t": "admin_summarize", "tenant": "t", "doc": "doc"})
        mid_text = text.get_text()
        mid_seq = svc._rpc_transport().request(
            {"t": "admin_status", "tenant": "t",
             "doc": "doc"})["status"]["seq"]
        for i in range(6):
            text.insert_text(0, f"y{i} ")
        assert wait_for(lambda: text.get_text().startswith("y5 "))
        assert wait_for(lambda: c.runtime.pending.count == 0)
        tail_text = text.get_text()

        h = svc.history()
        log = h.log()
        assert log and h.refs()[MAIN_REF] == log[0]["id"]
        assert h.at(mid_seq)["base_seq"] <= mid_seq
        assert get_text(loader.resolve_at("t", "doc", mid_seq)) == mid_text

        res = h.fork(new_doc="doc2")
        assert res["shared_chunks"] > 0
        c2 = loader.resolve("t", "doc2")
        t2 = c2.runtime.get_data_store("default").get_channel("text")
        assert wait_for(lambda: t2.get_text() == tail_text)
        t2.insert_text(0, "FORK ")
        assert wait_for(lambda: t2.get_text().startswith("FORK "))
        out = factory.create_document_service("t", "doc2") \
            .history().integrate()
        assert out["ops"] == 1
        assert wait_for(lambda: text.get_text().startswith("FORK "))

        svc._rpc_transport().request(
            {"t": "admin_summarize", "tenant": "t", "doc": "doc"})
        pinned = fe.server.history.pinned_chunks("t", "doc2")
        assert pinned
        fe.server.history.gc_chunks("t")
        assert all(fe.server.blob_store.has(cid) for cid in pinned)
        cold = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", fe.port)).resolve("t", "doc2")
        assert get_text(cold).startswith("FORK ")

        snap = tier_snapshot("service")
        assert snap.get("history.fork.boots", 0) >= 1
        assert snap.get("history.replay.reads", 0) >= 1
        assert snap.get("history.integrate.ops", 0) >= 1
        assert snap.get("history.commit.records", 0) >= 1

        # the network client reads what the local client reads
        assert wait_for(lambda: c.runtime.pending.count == 0)
        for doc in ("doc", "doc2"):
            net = factory.create_document_service("t", doc).history()
            local = LocalHistoryClient(fe.server, "t", doc)
            assert net.log() == local.log() and len(net.log()) >= 1
            assert net.log(1) == local.log(1)
            assert net.refs() == local.refs()
            assert net.at(mid_seq) == local.at(mid_seq)
            assert [message_to_dict(m) for m in net.deltas(0, mid_seq)] == \
                [message_to_dict(m) for m in local.deltas(0, mid_seq)]
    finally:
        fe.stop()


def _aged_doc(port: int, jax: bool) -> str:
    """A doc aged past an acked summary (retention margin 0), with a tail
    above it, written by a client of the serving package; returns its
    live text."""
    if jax:
        from fluidframework_tpu.driver.network import (
            NetworkDocumentServiceFactory as Factory,
        )
        from fluidframework_tpu.loader import Loader as L
        from fluidframework_tpu.runtime.summarizer import SummaryManager
    else:
        from fluidframework_tpu_torch.runtime.summarizer import (
            SummaryManager,
        )
        Factory, L = NetworkDocumentServiceFactory, Loader
    c = L(Factory("127.0.0.1", port)).resolve("t", "fetchdoc")
    sm = SummaryManager(c, max_ops=3)
    s = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "offline me")
    s.remove_text(0, 4)
    assert wait_for(lambda: sm.summaries_acked >= 1, timeout=30)
    s.insert_text(0, "replay ")  # tail ops above the summary
    assert wait_for(lambda: c.runtime.pending.count == 0, timeout=15)
    return s.get_text()


def _tree(path: Path) -> dict:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


def test_fetch_matches_jax_fetch_then_replays_offline(tmp_path):
    from fluidframework_tpu.config import DEFAULT as JAX_DEFAULT
    from fluidframework_tpu.replay.fetch import (
        fetch_document as jax_fetch_document,
    )
    from fluidframework_tpu.service import LocalServer as JaxServer
    from fluidframework_tpu.service import NetworkFrontEnd as JaxFrontEnd
    from fluidframework_tpu_torch.driver.file import FileDocumentService
    from fluidframework_tpu_torch.replay import ReplayController
    from fluidframework_tpu_torch.replay.fetch import fetch_document

    fe = JaxFrontEnd(JaxServer(config=JAX_DEFAULT.with_overrides(
        log_retention_ops=0))).start_background()
    try:
        live_text = _aged_doc(fe.port, jax=True)
        # from-zero delta reads are refused now — fetch must cope
        t = _Transport("127.0.0.1", fe.port, timeout=10.0)
        try:
            with pytest.raises(RuntimeError, match="truncated"):
                t.request({"t": "get_deltas", "tenant": "t",
                           "doc": "fetchdoc", "from": 0, "to": 10**9})
        finally:
            t.close()
        want = jax_fetch_document("127.0.0.1", fe.port, "t", "fetchdoc",
                                  str(tmp_path / "jax"))
        got = fetch_document("127.0.0.1", fe.port, "t", "fetchdoc",
                             str(tmp_path / "torch"))
    finally:
        fe.stop()
    assert os.path.exists(os.path.join(got, "messages.json"))
    assert _tree(Path(got)) == _tree(Path(want))
    # the service is gone; the fetched artifact replays standalone
    ctl = ReplayController(FileDocumentService.from_dir(got))
    assert ctl.container.existing  # booted from the fetched snapshot
    result = ctl.run()
    assert result["final_text"] == live_text == "replay ine me"


def test_replay_tool_port_replays_a_live_doc(capsys):
    from fluidframework_tpu_torch.replay.tool import main

    fe = NetworkFrontEnd(LocalServer()).start_background()
    try:
        live_text = _aged_doc(fe.port, jax=False)
        # a service summary commits the doc's first history record: the
        # tool boots from it and replays the tail (history-first)
        t = _Transport("127.0.0.1", fe.port, timeout=10.0)
        try:
            t.request({"t": "admin_summarize", "tenant": "t",
                       "doc": "fetchdoc"})
        finally:
            t.close()
        assert main(["t", "fetchdoc", "--port", str(fe.port)]) == 0
    finally:
        fe.stop()
    out = capsys.readouterr().out
    assert out.startswith("history-first replay")
    assert f"final text: {live_text!r}" in out
