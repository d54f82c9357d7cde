"""The port's array lane against ``tests/test_array_lane.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package (``service/array_batch.py``, ``load_gen.py``,
``synthetic.py``, the port's ``GpuDocumentApplier(device="cpu")`` beside
the JAX ``TpuDocumentApplier``) with the JAX test's assertions, and what
each side shows is equal exactly (``torch_stack_fixtures.both``): the
applier's texts through either lane and the pipeline's op counts, the
materialized boxcar messages, every backfilled message (seq, msn,
contents), the late joiner's text, scribe's and deli's seqs, the nack.
Tolerance: exact.
"""

import random

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, canonical


def _drive(s, array_lane: bool, seed: int = 3):
    applier = s.st.applier(max_docs=8, max_slots=128, ops_per_dispatch=8)
    stats = s.mod("service.load_gen").run_inproc(
        n_docs=4, clients_per_doc=2, ops_per_client=24, applier=applier,
        flush_every=64, seed=seed, batch_size=8, array_lane=array_lane)
    applier.finalize()
    texts = {d: applier.get_text("bench", f"doc{d}") for d in range(4)}
    return texts, stats, applier


def _converges_like_dict_lane(s):
    texts_a, stats_a, ap_a = _drive(s, True)
    texts_d, stats_d, ap_d = _drive(s, False)
    assert stats_a.ops_acked == stats_a.ops_submitted
    assert ap_a.host_escalations == 0
    assert texts_a == texts_d
    assert stats_a.ops_submitted == stats_d.ops_submitted
    s.note([texts_a, stats_a.ops_submitted, stats_a.ops_acked,
            stats_d.ops_acked, ap_a.host_escalations, ap_d.host_escalations])


def test_array_lane_converges_like_dict_lane():
    both(_converges_like_dict_lane)


def _boxcar_equivalence(s):
    editor = s.mod("service.synthetic").SyntheticEditor
    ed_a, ed_b = editor(random.Random(11)), editor(random.Random(11))
    ed_a.length = ed_b.length = 500
    ed_a.ref_seq = ed_b.ref_seq = 7
    box = ed_a.next_boxcar(32, "t", "d", "c1")
    ops = ed_b.next_ops(32)
    raw = box.to_raw_boxcar()
    assert [m.contents for m in raw.ops] == [m.contents for m in ops]
    assert [m.client_sequence_number for m in raw.ops] \
        == [m.client_sequence_number for m in ops]
    assert [m.reference_sequence_number for m in raw.ops] \
        == [m.reference_sequence_number for m in ops]
    assert ed_a.length == ed_b.length
    assert ed_a.client_seq == ed_b.client_seq
    s.note([canonical(m) for m in raw.ops])
    s.note([ed_a.length, ed_a.client_seq])


def test_array_boxcar_equivalence_to_dict_boxcar():
    both(_boxcar_equivalence)


def _backfill_materializes(s):
    editor = s.mod("service.synthetic").SyntheticEditor
    server = s.server
    conn = server.connect("t", "doc")
    ed = editor(random.Random(5))
    for _ in range(4):
        conn.submit_array(ed.next_boxcar(8, "t", "doc", conn.client_id))
    msgs = server.get_deltas("t", "doc", 0, 10 ** 9)
    op_msgs = [m for m in msgs if m.type.value == "op"]
    assert len(op_msgs) == 32
    seqs = [m.sequence_number for m in op_msgs]
    assert seqs == sorted(seqs) and len(set(seqs)) == 32
    for m in op_msgs:
        env = m.contents
        assert env["kind"] == "chanop" and env["address"] == "default"
        assert m.minimum_sequence_number <= m.sequence_number
    s.note([[m.sequence_number, m.minimum_sequence_number,
             m.client_sequence_number, m.reference_sequence_number,
             m.contents] for m in op_msgs])

    server2 = s.st.server()
    loader = s.st.Loader(s.st.LocalDocumentServiceFactory(server2))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "seed")
    conn2 = server2.connect("t", "doc")
    ed2 = editor(random.Random(6))
    ed2.ref_seq = server2._get_orderer("t", "doc").deli.sequence_number
    ed2.length = 4
    for _ in range(3):
        conn2.submit_array(ed2.next_boxcar(8, "t", "doc", conn2.client_id))
    c2 = loader.resolve("t", "doc")
    text = c2.runtime.get_data_store("default").get_channel(
        "text").get_text()
    assert text == s1.get_text()
    assert len(s1.get_text()) > 4
    s.note(text)


def test_backfill_materializes_array_batches():
    both(_backfill_materializes)


def _through_scribe_and_summary(s):
    editor = s.mod("service.synthetic").SyntheticEditor
    server = s.server
    conn = server.connect("t", "doc")
    ed = editor(random.Random(9))
    for _ in range(5):
        conn.submit_array(ed.next_boxcar(16, "t", "doc", conn.client_id))
        ed.ref_seq = server._get_orderer("t", "doc").deli.sequence_number
    orderer = server._get_orderer("t", "doc")
    assert orderer.scribe.protocol.sequence_number \
        == orderer.deli.sequence_number
    s.note([orderer.deli.sequence_number,
            orderer.scribe.protocol.minimum_sequence_number])


def test_array_lane_through_scribe_and_summary():
    both(_through_scribe_and_summary)


def _fallback_on_gap(s):
    editor = s.mod("service.synthetic").SyntheticEditor
    conn = s.server.connect("t", "doc")
    nacks = []
    conn.on_nack = nacks.append
    ed = editor(random.Random(1))
    box = ed.next_boxcar(4, "t", "doc", conn.client_id)
    box.cseq = box.cseq + 5
    conn.submit_array(box)
    assert nacks and nacks[0].code == 400
    s.note([[n.code, n.message] for n in nacks])


def test_fallback_to_scalar_lane_on_gap():
    both(_fallback_on_gap)
