"""GpuDocumentApplier(device="cpu") against the JAX TpuDocumentApplier.

The seeded two-client sessions of test_pallas_apply.py::_fuzz_session
(seeds 0, 7, 42, built through the JAX package's LocalServer) are fed to
both appliers; texts, properties and escalations must agree, and the
texts must equal the converged client text. Sequenced messages cross
into the port as its own ``SequencedDocumentMessage`` (field copies).
"""

import numpy as np
import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu.service.tpu_applier import (
    TpuDocumentApplier,
    channel_stream,
)
from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
from fluidframework_tpu_torch.ops.opgen import generate_doc_ops
from fluidframework_tpu_torch.protocol import SequencedDocumentMessage
from fluidframework_tpu_torch.service.array_batch import (
    ArrayBoxcar,
    SequencedArrayBatch,
)
from fluidframework_tpu_torch.service.gpu_applier import GpuDocumentApplier
from fluidframework_tpu_torch.testing.farm import run_session
from fluidframework_tpu_torch.testing.streams import array_batches, wire_pairs
from tests.test_pallas_apply import _fuzz_session

SEEDS = (0, 7, 42)
GEOMETRY = dict(max_docs=16, max_slots=256, ops_per_dispatch=8)


@pytest.fixture(scope="module")
def sessions():
    """seed -> (JAX messages, port messages, converged text)."""
    out = {}
    for seed in SEEDS:
        server, want = _fuzz_session(seed, f"mx{seed}")
        jmsgs = list(channel_stream(server, "t", f"mx{seed}", "default",
                                    "text"))
        out[seed] = (jmsgs, [_to_port(m) for m in jmsgs], want)
    return out


def _to_port(m) -> SequencedDocumentMessage:
    return SequencedDocumentMessage(
        client_id=m.client_id, sequence_number=m.sequence_number,
        minimum_sequence_number=m.minimum_sequence_number,
        client_sequence_number=m.client_sequence_number,
        reference_sequence_number=m.reference_sequence_number,
        type=m.type, contents=m.contents)


def _jax_applier(docs: dict, **geo):
    """A JAX applier (XLA kernel) fed {doc: messages} one op at a time."""
    app = TpuDocumentApplier(kernel="xla", **{**GEOMETRY, **geo})
    app.set_replay_source(lambda t, d: docs[d])
    for doc, msgs in docs.items():
        for m in msgs:
            app.ingest("t", doc, m, m.contents)
    app.finalize()
    return app


def _port_applier(docs: dict, **geo):
    app = GpuDocumentApplier(device="cpu", **{**GEOMETRY, **geo})
    app.set_replay_source(lambda t, d: docs[d])
    for doc, msgs in docs.items():
        for m in msgs:
            app.ingest("t", doc, m, m.contents)
    app.finalize()
    return app


def _assert_same_doc(jax_app, port_app, doc, want):
    text = port_app.get_text("t", doc)
    assert text == jax_app.get_text("t", doc) == want
    for pos in range(len(text)):
        assert port_app.get_properties_at("t", doc, pos) == \
            jax_app.get_properties_at("t", doc, pos), pos
    assert port_app.slot_count("t", doc) == jax_app.slot_count("t", doc)
    assert port_app.applied_seq("t", doc) == jax_app.applied_seq("t", doc)
    assert port_app.first_seq("t", doc) == jax_app.first_seq("t", doc)
    assert port_app.get_tree("t", doc).get_text() == want


@pytest.mark.parametrize("seed", SEEDS)
def test_applier_matches_jax_and_clients(sessions, seed):
    jmsgs, pmsgs, want = sessions[seed]
    doc = f"mx{seed}"
    jax_app = _jax_applier({doc: jmsgs})
    port_app = _port_applier({doc: pmsgs})
    _assert_same_doc(jax_app, port_app, doc, want)
    # the annotated range really carries props
    assert any(port_app.get_properties_at("t", doc, p)
               for p in range(len(want)))
    assert port_app.host_escalations == jax_app.host_escalations == 0
    assert port_app.ops_applied == jax_app.ops_applied == len(pmsgs)
    assert port_app.dispatches == jax_app.dispatches > 0


def _array_lane(msgs: list) -> list:
    """The session's messages as array batches: runs of one client with
    consecutive seqs."""
    batches, run = [], []

    def close():
        if not run:
            return
        ops = [m.contents for m in run]
        kind = np.array([op["type"] for op in ops], np.int8)
        texts = [op.get("text", "") if op["type"] == 0 else ""
                 for op in ops]
        box = ArrayBoxcar(
            tenant_id="t", document_id="d", client_id=run[0].client_id,
            ds_id="default", channel_id="text", kind=kind,
            a=np.array([op.get("pos", op.get("start")) for op in ops],
                       np.int32),
            b=np.array([op.get("end", 0) for op in ops], np.int32),
            cseq=np.array([m.client_sequence_number for m in run], np.int32),
            rseq=np.array([m.reference_sequence_number for m in run],
                          np.int32),
            text="".join(texts),
            text_off=np.concatenate([[0], np.cumsum([len(t) for t in texts])]
                                    ).astype(np.int32),
            props=[op.get("props") for op in ops])
        batches.append(SequencedArrayBatch(
            boxcar=box, base_seq=run[0].sequence_number,
            msns=np.array([m.minimum_sequence_number for m in run],
                          np.int64), timestamp=0.0))
        run.clear()

    for m in msgs:
        if run and (m.client_id != run[-1].client_id
                    or m.sequence_number != run[-1].sequence_number + 1):
            close()
        run.append(m)
    close()
    return batches


@pytest.mark.parametrize("seed", SEEDS)
def test_array_lane_matches_jax(sessions, seed):
    jmsgs, pmsgs, want = sessions[seed]
    doc = f"mx{seed}"
    batches = _array_lane(pmsgs)
    assert len(batches) < len(pmsgs)  # some boxcars hold several ops
    port_app = GpuDocumentApplier(device="cpu", **GEOMETRY)
    jax_app = TpuDocumentApplier(kernel="xla", **GEOMETRY)
    for app in (port_app, jax_app):
        for batch in batches:
            app.ingest_array_batch("t", doc, batch)
        app.finalize()
    _assert_same_doc(jax_app, port_app, doc, want)
    assert port_app.host_escalations == jax_app.host_escalations == 0


def test_overflow_escalates_the_same_doc_as_jax(sessions):
    """At S=8 the busiest session outgrows the device slots: both appliers
    escalate that doc (and only it) through the replay source and end on
    the converged text."""
    _, small, small_text = sessions[0]
    big_log, big_text = run_session(3, n_clients=2, n_ops=80)
    docs = {"small": small[:3], "big": big_log}
    jax_app = _jax_applier({d: m for d, m in docs.items()}, max_slots=8)
    port_app = _port_applier(docs, max_slots=8)
    assert port_app.host_escalations == jax_app.host_escalations == 1
    escalated = {port_app._doc_keys[s] for s in port_app._host_docs}
    assert escalated == {jax_app._doc_keys[s] for s in jax_app._host_docs}
    assert escalated == {("t", "big")}
    assert port_app.get_text("t", "big") == jax_app.get_text("t", "big") \
        == big_text
    oracle = MergeTreeClient("o")
    for m in small[:3]:
        oracle.apply_msg(m, local=False)
    assert port_app.get_text("t", "small") == oracle.get_text() == \
        jax_app.get_text("t", "small")


def test_prop_table_overflow_escalates():
    """P + 1 distinct keys on one character overflow the device prop
    table; the doc escalates and keeps every key."""
    log = [SequencedDocumentMessage(
        client_id="a", sequence_number=1, minimum_sequence_number=0,
        client_sequence_number=1, reference_sequence_number=0,
        type="op", contents={"type": 0, "pos": 0, "text": "xyz"})]
    log += [SequencedDocumentMessage(
        client_id="a", sequence_number=2 + k, minimum_sequence_number=0,
        client_sequence_number=2 + k, reference_sequence_number=1 + k,
        type="op", contents={"type": 2, "start": 0, "end": 1,
                             "props": {f"key{k}": k}}) for k in range(9)]
    port_app = _port_applier({"hot": log})
    jax_app = _jax_applier({"hot": log})
    assert port_app.host_escalations == jax_app.host_escalations == 1
    props = port_app.get_properties_at("t", "hot", 0)
    assert props == jax_app.get_properties_at("t", "hot", 0)
    assert props == {f"key{k}": k for k in range(9)}


def test_replay_source_is_required_for_escalation():
    app = GpuDocumentApplier(device="cpu", max_docs=2, max_slots=4,
                             ops_per_dispatch=4)
    log, _ = run_session(1, n_clients=2, n_ops=24)
    for m in log:
        app.ingest("t", "d", m, m.contents)
    with pytest.raises(RuntimeError, match="replay source"):
        app.finalize()


@pytest.mark.parametrize("lane", ["batch", "array"])
def test_opgen_wire_streams_match_jax_and_oracle(lane):
    """The opgen-derived wire streams that chip_smoke.py drives (annotate
    and remove heavy, four clients per doc), through either ingest lane:
    the port, the JAX applier and the scalar oracle agree on every doc."""
    rng = np.random.default_rng(5)
    texts_rng = np.random.default_rng(6)
    port_app = GpuDocumentApplier(device="cpu", max_docs=8, max_slots=64,
                                  ops_per_dispatch=16)
    jax_app = TpuDocumentApplier(kernel="xla", max_docs=8, max_slots=64,
                                 ops_per_dispatch=16)
    oracles = {}
    for d in range(6):
        rows, _, _ = generate_doc_ops(rng, 40, remove_fraction=0.4,
                                      annotate_fraction=0.2, max_insert=6)
        doc = f"doc{d}"
        if lane == "batch":
            pairs = wire_pairs(rows, texts_rng)
            for app in (port_app, jax_app):
                app.ingest_batch("t", doc, pairs)
        else:
            batches = array_batches(rows, texts_rng, "t", doc, max_boxcar=4)
            for app in (port_app, jax_app):
                for batch in batches:
                    app.ingest_array_batch("t", doc, batch)
            pairs = [(b.message(i), b.boxcar.wire_op(i))
                     for b in batches for i in range(b.n)]
        oracle = MergeTreeClient("oracle")
        for m, w in pairs:
            m.contents = w
            oracle.apply_msg(m, local=False)
        oracles[doc] = oracle
    for app in (port_app, jax_app):
        app.finalize()
    assert port_app.host_escalations == jax_app.host_escalations == 0
    for doc, oracle in oracles.items():
        text = oracle.get_text()
        assert port_app.get_text("t", doc) == jax_app.get_text("t", doc) \
            == text
        for pos in range(0, len(text), 3):
            assert port_app.get_properties_at("t", doc, pos) == \
                jax_app.get_properties_at("t", doc, pos) == \
                oracle.get_properties_at(pos)


def test_wide_lane_matches_jax():
    """An insert longer than int16 holds escapes the packed wave: that
    wave ships at int32 width and both appliers end on the same text."""
    text = "ab" * 20000  # 40,000 chars: F_TLEN escapes int16

    def msg(seq, contents):
        return SequencedDocumentMessage(
            client_id="a", sequence_number=seq, minimum_sequence_number=0,
            client_sequence_number=seq, reference_sequence_number=seq - 1,
            type="op", contents=contents)

    log = [msg(1, {"type": 0, "pos": 0, "text": "hello"}),
           msg(2, {"type": 0, "pos": 2, "text": text}),
           msg(3, {"type": 1, "start": 1, "end": 4})]
    port_app = _port_applier({"wide": log})
    jax_app = _jax_applier({"wide": log})
    assert port_app.wide_dispatches == 1
    want = "h" + text[2:] + "llo"
    assert port_app.get_text("t", "wide") == jax_app.get_text("t", "wide") \
        == want
    assert port_app.host_escalations == jax_app.host_escalations == 0
