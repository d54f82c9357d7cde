"""The port's replica farm (``GpuDocumentApplier(device="cpu")``, the
plain PyTorch lane of B1) against ``tests/test_tpu_applier.py``.

Each test is the twin of the JAX test of the same name (the mesh case's
twin is ``test_torch_mesh_applier.py::test_applier_on_virtual_mesh``):
its scenario runs on each package, the port's applier fed the port's
server and the JAX ``TpuDocumentApplier`` fed the JAX server, from the
same client edits (``torch_stack_fixtures.both``). The JAX test's
assertions hold on both, and what each side shows is equal exactly:
every doc's text, properties by position, ``slot_count`` after each
flush of the churn (under the JAX bound of 60 at ``max_slots=64``),
escalations, dispatches, and the warm-restarted farm's texts.
Tolerance: exact.
"""

import numpy as np
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both


def _applier(s, **geo):
    return s.st.applier(**geo)


def feed_applier(s, applier, tenant, doc):
    for msg in s.st.channel_stream(s.server, tenant, doc, "default",
                                   "text"):
        applier.ingest(tenant, doc, msg, msg.contents)
    applier.finalize()


def _matches_client_replicas(s):
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s1.insert_text(0, "hello world")
    s2.insert_text(5, ", tpu")
    s1.remove_text(0, 5)
    s2.insert_text(len(s2.get_text()), "!")
    assert s1.get_text() == s2.get_text()
    applier = _applier(s, max_docs=8, max_slots=64, ops_per_dispatch=4)
    feed_applier(s, applier, "t", "doc")
    assert applier.get_text("t", "doc") == s1.get_text()
    assert applier.host_escalations == 0
    s.note([applier.get_text("t", "doc"), applier.dispatches,
            applier.slot_count("t", "doc")])


def test_applier_matches_client_replicas():
    both(_matches_client_replicas)


def _many_docs_fuzz(s):
    rng = np.random.default_rng(11)
    docs = [f"doc{i}" for i in range(6)]
    strings = {}
    for d in docs:
        c = s.loader.resolve("t", d)
        strings[d] = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
    for _ in range(120):
        d = docs[rng.integers(0, len(docs))]
        st = strings[d]
        n = len(st.get_text())
        if n > 4 and rng.random() < 0.35:
            a = int(rng.integers(0, n - 1))
            b = int(rng.integers(a + 1, n + 1))
            st.remove_text(a, b)
        else:
            pos = int(rng.integers(0, n + 1))
            st.insert_text(pos, f"[{rng.integers(0, 100)}]")
    applier = _applier(s, max_docs=16, max_slots=512, ops_per_dispatch=8)
    for d in docs:
        feed_applier(s, applier, "t", d)
    for d in docs:
        assert applier.get_text("t", d) == strings[d].get_text(), d
        s.note([d, applier.get_text("t", d), applier.slot_count("t", d)])
    assert applier.host_escalations == 0
    assert applier.dispatches > 0
    s.note(applier.dispatches)


def test_applier_many_docs_fuzz():
    both(_many_docs_fuzz)


def _annotate_stays_on_device(s):
    c1 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "styled text")
    s1.annotate_range(0, 6, {"bold": True})
    s1.annotate_range(3, 8, {"size": 12})
    s1.annotate_range(0, 2, {"bold": None})
    s1.insert_text(4, "x")
    applier = _applier(s, max_docs=4, max_slots=32, ops_per_dispatch=4)
    feed_applier(s, applier, "t", "doc")
    assert applier.host_escalations == 0
    assert applier.get_text("t", "doc") == s1.get_text()
    replica = c1.runtime.get_data_store("default").get_channel("text").client
    for pos in range(len(s1.get_text())):
        props = applier.get_properties_at("t", "doc", pos)
        assert props == replica.get_properties_at(pos), pos
        s.note([pos, props])


def test_applier_annotate_stays_on_device():
    both(_annotate_stays_on_device)


def _zamboni_bounds_slots(s):
    rng = np.random.default_rng(5)
    c1 = s.loader.resolve("t", "doc")
    c2 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    applier = _applier(s, max_docs=4, max_slots=64, ops_per_dispatch=8)
    seen = 0
    max_count = 0
    for i in range(150):
        st = s1 if i % 2 == 0 else s2
        n = len(st.get_text())
        if n > 6 and rng.random() < 0.5:
            a = int(rng.integers(0, n - 3))
            st.remove_text(a, a + 3)
        else:
            st.insert_text(int(rng.integers(0, n + 1)), "ab")
        msgs = list(s.st.channel_stream(s.server, "t", "doc", "default",
                                        "text"))
        for m in msgs[seen:]:
            applier.ingest("t", "doc", m, m.contents)
        seen = len(msgs)
        if i % 10 == 9:
            applier.flush()
            count = applier.slot_count("t", "doc")
            max_count = max(max_count, count)
            s.note(["slots", i, count])
    applier.flush()
    assert applier.host_escalations == 0
    assert applier.get_text("t", "doc") == s1.get_text() == s2.get_text()
    assert max(max_count, applier.slot_count("t", "doc")) < 60
    s.note([applier.get_text("t", "doc"), applier.slot_count("t", "doc")])


def test_applier_zamboni_bounds_slots_under_churn():
    both(_zamboni_bounds_slots)


def _escalates_capacity_overflow(s):
    c1 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for i in range(30):
        s1.insert_text(len(s1.get_text()) // 2, f"seg{i}")
    applier = _applier(s, max_docs=4, max_slots=8, ops_per_dispatch=4)
    applier.set_replay_source(lambda t, d: list(
        s.st.channel_stream(s.server, t, d, "default", "text")))
    feed_applier(s, applier, "t", "doc")
    assert applier.host_escalations == 1
    assert applier.get_text("t", "doc") == s1.get_text()
    s.note([applier.host_escalations, applier.get_text("t", "doc")])


def test_applier_escalates_capacity_overflow():
    both(_escalates_capacity_overflow)


def _interval_only_batch(s):
    msgs = s.mod("protocol.messages")
    applier = _applier(s, max_docs=4, max_slots=16, ops_per_dispatch=4)
    applier.set_replay_source(lambda t, d: [])

    def msg(seq):
        return msgs.SequencedDocumentMessage(
            client_id="c1", sequence_number=seq, minimum_sequence_number=0,
            client_sequence_number=seq, reference_sequence_number=seq - 1,
            type=msgs.MessageType.OPERATION)

    applier.ingest("t", "iv-doc", msg(1), {"type": "interval", "op": "add"})
    applier.ingest("t", "txt-doc", msg(1),
                   {"type": 0, "pos": 0, "text": "hi"})
    applier.flush()
    applier.finalize()
    assert applier.host_escalations == 0
    assert applier.get_text("t", "txt-doc") == "hi"
    s.note([applier.get_text("t", "iv-doc"), applier.dispatches])


def test_interval_only_batch_does_not_crash_dispatch():
    both(_interval_only_batch)


def _checkpoint_warm_restart(s, tmp_path):
    mod = s.mod("service." + ("tpu_applier" if s.pkg == "jax"
                              else "gpu_applier"))
    docs = ["a", "b"]
    strings = {}
    applier = _applier(s, max_docs=4, max_slots=64, ops_per_dispatch=4)
    applier.set_replay_source(lambda t, d: [])
    for d in docs:
        c = s.loader.resolve("t", d)
        st = c.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        st.insert_text(0, f"checkpointed {d} ")
        st.annotate_range(0, 3, {"bold": True})
        strings[d] = st
        feed_applier(s, applier, "t", d)
    path = str(tmp_path / f"farm-{s.pkg}")
    mod.save_applier_checkpoint(applier, path)
    revived = (mod.load_applier_checkpoint(path) if s.pkg == "jax"
               else mod.load_applier_checkpoint(path, device="cpu"))
    revived.set_replay_source(lambda t, d: [])
    for d in docs:
        assert revived.get_text("t", d) == strings[d].get_text()
        assert revived.get_properties_at("t", d, 0).get("bold") is True
    seen = {d: s.server.get_deltas("t", d, 0, 10**9)[-1].sequence_number
            for d in docs}
    for d in docs:
        strings[d].insert_text(0, ">> ")
        for m in s.st.channel_stream(s.server, "t", d, "default", "text"):
            if m.sequence_number > seen[d]:
                revived.ingest("t", d, m, m.contents)
    revived.finalize()
    assert revived.host_escalations == 0
    for d in docs:
        assert revived.get_text("t", d) == strings[d].get_text()
        s.note([d, revived.get_text("t", d),
                revived.get_properties_at("t", d, 3),
                revived.applied_seq("t", d)])


def test_applier_checkpoint_warm_restart(tmp_path):
    both(_checkpoint_warm_restart, tmp_path)
