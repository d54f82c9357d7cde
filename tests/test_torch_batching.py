"""The port's op batching (``runtime/container_runtime.py``: flush modes,
``order_sequentially``; the delta manager's inbound slicing and pause)
against ``tests/test_batching.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's client stack over that package's ``LocalServer``
(``torch_stack_fixtures.both``: a fixed client-id epoch, a clock at 0)
with the JAX test's assertions. Between the packages, the texts and
boxcar counts on the way and everything the server stored at the end
(``torch_stack_fixtures.stored``: the ops on the wire as sequenced,
their batch metadata, every db collection) are equal exactly.
Tolerance: exact.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored


def _boxcars(deli):
    return deli.boxcars_fast + deli.boxcars_fallback


def _text(container, name="text"):
    return container.runtime.get_data_store("default").get_channel(
        name).get_text()


def _turn_based(s):
    flush_mode = s.mod("runtime.container_runtime").FlushMode
    c1 = s.loader.resolve("t", "doc")
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "base")
    deli = s.server._get_orderer("t", "doc").deli
    boxcars_before = _boxcars(deli)
    c1.runtime.set_flush_mode(flush_mode.TURN_BASED)
    st.insert_text(0, "a")
    st.insert_text(0, "b")
    st.insert_text(0, "c")
    assert _boxcars(deli) == boxcars_before
    assert st.get_text() == "cbabase"
    c1.runtime.flush()
    assert _boxcars(deli) == boxcars_before + 1
    assert c1.runtime.pending.count == 0
    c1.runtime.set_flush_mode(flush_mode.IMMEDIATE)
    c2 = s.loader.resolve("t", "doc")
    assert _text(c2) == "cbabase"
    s.note([boxcars_before, deli.boxcars_fast, deli.boxcars_fallback,
            stored(s.server)])


def test_turn_based_flush_coalesces_into_one_boxcar():
    both(_turn_based)


def _contiguous(s):
    flush_mode = s.mod("runtime.container_runtime").FlushMode
    server = s.server
    server._auto_drain = False
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    server.drain()
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    server.drain()
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    c1.runtime.set_flush_mode(flush_mode.TURN_BASED)
    s1.insert_text(0, "aaa")
    s1.insert_text(0, "bbb")
    c1.runtime.flush()
    s2.insert_text(0, "Z")
    server.drain()
    log = server.get_deltas("t", "doc", 0, 10**9)
    c1_id = c1.client_id
    batch_seqs = [m.sequence_number for m in log
                  if m.client_id == c1_id and m.type.value == "op"
                  and isinstance(m.contents, dict)
                  and m.contents.get("kind") == "chanop"
                  and "attach" not in m.contents["contents"]]
    assert batch_seqs[-1] == batch_seqs[-2] + 1
    marked = [m.metadata for m in log if m.sequence_number in batch_seqs[-2:]]
    assert marked == [{"batch": True}, {"batch": False}]
    assert s1.get_text() == s2.get_text()
    s.note([batch_seqs, s1.get_text(), stored(server)])


def test_batch_is_sequenced_contiguously():
    both(_contiguous)


def _order_sequentially(s):
    c1 = s.loader.resolve("t", "doc")
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    deli = s.server._get_orderer("t", "doc").deli
    before = _boxcars(deli)
    with c1.runtime.order_sequentially():
        st.insert_text(0, "x")
        st.insert_text(1, "y")
        st.insert_text(2, "z")
    assert _boxcars(deli) == before + 1
    assert st.get_text() == "xyz"
    assert c1.runtime.pending.count == 0
    s.note([before, stored(s.server)])


def test_order_sequentially_batches_and_flushes():
    both(_order_sequentially)


def _exception_closes(s):
    c1 = s.loader.resolve("t", "doc")
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    with pytest.raises(ValueError):
        with c1.runtime.order_sequentially():
            st.insert_text(0, "doomed")
            raise ValueError("app error mid-transaction")
    assert c1.closed
    s.note([c1.closed, stored(s.server)])


def test_order_sequentially_exception_closes_container():
    both(_exception_closes)


def _scheduler_yields(s):
    container_cls = s.mod("loader.container").Container
    c1 = s.loader.resolve("t", "doc")
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for _ in range(40):
        st.insert_text(0, "x")
    svc = s.st.LocalDocumentServiceFactory(s.server).create_document_service(
        "t", "doc")
    late = container_cls(svc)
    yields = []
    late.delta_manager.inbound_slice = 10
    late.delta_manager.inbound_yield = lambda seq: yields.append(seq)
    late.load()
    assert len(yields) >= 3
    assert _text(late) == st.get_text()
    s.note([yields, _text(late)])


def test_delta_scheduler_yields_during_long_drain():
    both(_scheduler_yields)


def _pause(s):
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "base")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    c2.delta_manager.pause_inbound()
    s1.insert_text(4, "-one")
    s1.insert_text(8, "-two")
    assert s2.get_text() == "base"
    s2.insert_text(0, ">")
    assert s2.get_text() == ">base"
    stepped = c2.delta_manager.step_inbound(1)
    assert stepped == 1 and s2.get_text() != s1.get_text()
    s.note(s2.get_text())
    c2.delta_manager.resume_inbound()
    assert s1.get_text() == s2.get_text() == ">base-one-two"
    s.note([s2.get_text(), stored(s.server)])


def test_per_client_pause_controls_interleaving():
    both(_pause)


def _legacy_snapshot(s):
    load_channel = s.mod("dds.registry").load_channel
    c = s.loader.resolve("t", "doc")
    st = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "old format")
    legacy = st.snapshot()["mergetree"]
    revived = load_channel("shared-string", "text2", legacy)
    assert revived.get_text() == "old format"
    s.note([legacy, revived.snapshot()])


def test_legacy_pre_intervals_snapshot_still_loads():
    both(_legacy_snapshot)
