"""The port's summary pipeline (``runtime/summarizer.py``, scribe's
validation and acks, boot from acked summaries) against
``tests/test_summarizer.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's client stack and ``LocalServer``
(``torch_stack_fixtures.both``: a fixed client-id epoch and a clock at
0), with the JAX test's assertions. Between the packages, the managers'
counters and handles, the booted replicas' values, and everything the
server stored (``torch_stack_fixtures.stored``: the summary trees and
versions, the sequenced streams with their acks and nacks, every db
collection) are equal exactly. Tolerance: exact.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, canonical, stored


def _sm(s, container, **kw):
    return s.st.SummaryManager(container, **kw)


def _counts(*managers):
    return [[m.summaries_acked, m.summaries_nacked, m.last_acked_handle]
            for m in managers]


def _elected(s):
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    sm1, sm2 = _sm(s, c1), _sm(s, c2)
    assert sm1.elected_summarizer == c1.client_id
    assert sm1.is_summarizer and not sm2.is_summarizer
    c1.close()
    assert sm2.elected_summarizer == c2.client_id
    assert sm2.is_summarizer
    s.note([sm2.elected_summarizer, stored(s.server)])


def test_oldest_member_is_elected():
    both(_elected)


def _acked_and_used(s):
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=3)
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "abcdef")
    st.remove_text(0, 2)
    assert sm.summaries_acked >= 1
    assert sm.last_acked_handle is not None
    c2 = s.loader.resolve("t", "doc")
    assert c2._base_snapshot is not None
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == "cdef"
    s2.insert_text(0, "x")
    assert st.get_text() == "xcdef"
    s.note([_counts(sm), canonical(c2._base_snapshot), stored(s.server)])


def test_summary_acked_and_used_for_boot():
    both(_acked_and_used)


def _chain(s):
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=2)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    for i in range(8):
        kv.set(f"k{i}", i)
    assert sm.summaries_acked >= 2
    versions = c1.storage.get_versions(10)
    assert len(versions) >= 2
    s.note([_counts(sm), canonical(versions), stored(s.server)])


def test_summary_chain_parents_link():
    both(_chain)


def _stale_parent(s):
    c1 = s.loader.resolve("t", "doc")
    sm1 = _sm(s, c1, max_ops=10_000)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    kv.set("a", 1)
    sm1.summarize_now()
    assert sm1.summaries_acked == 1
    sm1.last_acked_handle = None
    nacked_handle = sm1.summarize_now()
    assert sm1.summaries_nacked == 1
    versions = c1.storage.get_versions(10)
    assert nacked_handle is not None
    assert all(v["id"] != nacked_handle for v in versions)
    s.note([_counts(sm1), nacked_handle, stored(s.server)])


def test_stale_parent_summary_nacked():
    both(_stale_parent)


def _defers(s):
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=10_000)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    s.server._auto_drain = False
    kv.set("a", 1)
    with pytest.raises(RuntimeError) as err:
        sm.summarize_now()
    s.server.drain()
    sm.summarize_now()
    s.server.drain()
    assert sm.summaries_acked == 1
    s.note([str(err.value), _counts(sm), stored(s.server)])


def test_summarizer_defers_with_pending_ops():
    both(_defers)


def _scribe_restart(s):
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=10_000)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    kv.set("a", 1)
    sm.summarize_now()
    assert sm.summaries_acked == 1
    s.server.restart_orderer("t", "doc")
    kv.set("b", 2)
    sm.summarize_now()
    assert sm.summaries_acked == 2
    assert sm.summaries_nacked == 0
    s.note([_counts(sm), stored(s.server)])


def test_scribe_restart_keeps_summary_head():
    both(_scribe_restart)


def _non_summarizer(s):
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    sm1 = _sm(s, c1, max_ops=2)
    sm2 = _sm(s, c2, max_ops=2)
    kv2 = c2.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    for i in range(6):
        kv2.set(f"k{i}", i)
    assert sm2.summaries_acked == 0
    assert sm1.summaries_acked >= 1
    s.note([_counts(sm1, sm2), stored(s.server)])


def test_non_summarizer_client_never_summarizes():
    both(_non_summarizer)


def _late_elected(s):
    c1 = s.loader.resolve("t", "doc")
    sm1 = _sm(s, c1, max_ops=10_000)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    kv.set("a", 1)
    sm1.summarize_now()
    assert sm1.summaries_acked == 1
    c2 = s.loader.resolve("t", "doc")
    sm2 = _sm(s, c2, max_ops=10_000)
    assert sm2.last_acked_handle == sm1.last_acked_handle
    c1.close()
    kv2 = c2.runtime.get_data_store("default").get_channel("kv")
    kv2.set("b", 2)
    sm2.summarize_now()
    assert sm2.summaries_acked == 1 and sm2.summaries_nacked == 0
    s.note([_counts(sm1, sm2), stored(s.server)])


def test_late_elected_summarizer_continues_chain():
    both(_late_elected)


def _future_head(s):
    summarize = s.mod("protocol.messages").MessageType.SUMMARIZE
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=10_000)
    kv = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    kv.set("a", 1)
    summary = {"protocol": c1.protocol.snapshot(),
               "runtime": c1.runtime.snapshot(),
               "sequence_number": 999}
    handle = c1.storage.upload_summary(summary, parent=None)
    c1.delta_manager.submit(
        summarize, {"handle": handle, "parent": None, "head": 999})
    assert c1.storage.get_versions(10) == []
    sm.summarize_now()
    assert sm.summaries_acked == 1
    s.note([handle, _counts(sm), stored(s.server)])


def test_future_head_summary_nacked():
    both(_future_head)


def _seq_align(s):
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=10_000)
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "hello")
    sm.summarize_now()
    c2 = s.loader.resolve("t", "doc")
    st2 = c2.runtime.get_data_store("default").get_channel("text")
    st2.insert_text(5, "!")
    assert st.get_text() == st2.get_text() == "hello!"
    assert c2.protocol.sequence_number == \
        c2.delta_manager.last_processed_seq
    s.note([c2.protocol.sequence_number, stored(s.server)])


def test_boot_from_summary_sequence_numbers_align():
    both(_seq_align)


def _crash_replay(s):
    mtype = s.mod("protocol.messages").MessageType
    server = s.server
    c1 = s.loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=2)
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "hello")
    st.insert_text(5, " world")
    assert sm.summaries_acked >= 1
    acked_before = sm.summaries_acked

    def nacks():
        return sum(1 for m in server.get_deltas("t", "doc", 0, 10**6)
                   if m.type == mtype.SUMMARY_NACK)

    before = nacks()
    server._orderers.pop("t/doc").close()
    server._get_orderer("t", "doc")
    server.drain()
    assert nacks() == before
    assert sm.summaries_acked == acked_before
    s.note([before, _counts(sm), stored(server)])


def test_deli_crash_replay_does_not_spuriously_nack_acked_summary():
    both(_crash_replay)


def _duplicate_summarize(s):
    msgs = s.mod("protocol.messages")
    core = s.mod("service.core")
    scribe_lambda = s.mod("service.scribe").ScribeLambda
    db = core.InMemoryDb()
    db.upsert(core.summary_versions_collection("t", "d"), "h1",
              {"id": "h1", "parent": None, "acked": False})
    sent = []
    scribe = scribe_lambda("t", "d", db, send_to_deli=sent.append)
    summarize = msgs.SequencedDocumentMessage(
        client_id="c1", sequence_number=1, minimum_sequence_number=0,
        client_sequence_number=1, reference_sequence_number=0,
        type=msgs.MessageType.SUMMARIZE,
        contents={"handle": "h1", "parent": None, "head": 1})
    scribe.handler(core.QueuedMessage(topic="deltas/t/d", partition=0,
                                      offset=0,
                                      value={"message": summarize}))
    assert [m.operation.type for m in sent] == \
        [msgs.MessageType.SUMMARY_ACK]
    assert scribe.last_summary_head == "h1"
    scribe.handler(core.QueuedMessage(topic="deltas/t/d", partition=0,
                                      offset=1,
                                      value={"message": summarize}))
    assert [m.operation.type for m in sent] == \
        [msgs.MessageType.SUMMARY_ACK]
    assert scribe.last_summary_head == "h1"
    s.note([canonical(sent), canonical(db.collections)])


def test_scribe_skips_duplicate_summarize_at_new_offset():
    both(_duplicate_summarize)


def _log_truncates(s):
    config = s.mod("config").Config
    truncated = s.mod("service.scriptorium").LogTruncatedError
    srv = s.st.server(config=config().with_overrides(log_retention_ops=5))
    loader = s.st.Loader(s.st.LocalDocumentServiceFactory(srv))
    c1 = loader.resolve("t", "doc")
    sm = _sm(s, c1, max_ops=10**9)
    st = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for i in range(30):
        st.insert_text(0, f"{i % 10}")
    sm.summarize_now()
    assert sm.summaries_acked == 1
    orderer = srv._get_orderer("t", "doc")
    base = orderer.scriptorium.retained_base("t", "doc")
    assert base > 0
    head = orderer.deli.sequence_number
    assert head - base >= 5
    with pytest.raises(truncated) as err:
        srv.get_deltas("t", "doc", 0, 10**9)
    assert all(m.sequence_number > base
               for m in srv.get_deltas("t", "doc", base, 10**9))
    c2 = loader.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == st.get_text()
    s2.insert_text(0, "x")
    assert st.get_text() == s2.get_text()
    for _ in range(10):
        st.insert_text(0, "y")
    sm.summarize_now()
    base2 = orderer.scriptorium.retained_base("t", "doc")
    assert base2 > base
    s.note([base, head, base2, str(err.value), st.get_text(), stored(srv)])


def test_log_truncates_behind_acked_summaries():
    both(_log_truncates)
