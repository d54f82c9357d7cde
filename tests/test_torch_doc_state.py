"""The port's doc-state codec against the JAX package's.

``encode_tree`` / ``decode_state`` of both packages run on the same oracle
trees (seeded concurrent farm sessions, replayed by an observer replica of
each package, plus a marker and props), and must give the same arrays, the
same arena text and interned tables, and trees that decode back to the
same segments. ``state_from_numpy`` / ``state_to_numpy`` carry a JAX
``DocState`` batch into the port and back unchanged. Integer fields are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.mergetree import MergeTreeClient as JClient
from fluidframework_tpu.ops import apply as japply
from fluidframework_tpu.ops import doc_state as jds
from fluidframework_tpu.ops.opgen import generate_batch_ops
from fluidframework_tpu.protocol.messages import (
    SequencedDocumentMessage as JMessage,
)
from fluidframework_tpu_torch.mergetree import MergeTreeClient
from fluidframework_tpu_torch.ops import doc_state as tds
from fluidframework_tpu_torch.protocol import (
    MessageType,
    SequencedDocumentMessage,
)
from fluidframework_tpu_torch.testing.farm import run_session

SEEDS = (0, 3, 11)
S = 128


def _session_log(seed):
    """A farm session's messages, then a marker insert with props and an
    insert-with-props by a third client."""
    log, _ = run_session(seed, n_clients=3, n_ops=60)
    last = log[-1].sequence_number
    extra = [
        {"type": 0, "pos": 0, "marker": {"refType": 1}, "props": {"m": 1}},
        {"type": 0, "pos": 1, "text": "xy", "props": {"bold": True}},
    ]
    for k, contents in enumerate(extra):
        log.append(SequencedDocumentMessage(
            client_id="c9", sequence_number=last + 1 + k,
            minimum_sequence_number=log[-1].minimum_sequence_number,
            client_sequence_number=k + 1, reference_sequence_number=last,
            type=MessageType.OPERATION, contents=contents))
    return log


def _replicas(seed):
    """(port observer, JAX observer), both replaying the same log."""
    port, jax_client = (MergeTreeClient("obs", blocked=False),
                        JClient("obs", blocked=False))
    for m in _session_log(seed):
        port.apply_msg(m, local=False)
        jax_client.apply_msg(JMessage(
            client_id=m.client_id, sequence_number=m.sequence_number,
            minimum_sequence_number=m.minimum_sequence_number,
            client_sequence_number=m.client_sequence_number,
            reference_sequence_number=m.reference_sequence_number,
            type=m.type, contents=m.contents), local=False)
    return port, jax_client


def _encode_both(seed):
    port, jax_client = _replicas(seed)
    t_arena, t_props = tds.TextArena(), tds.PropTable()
    j_arena, j_props = jds.TextArena(), jds.PropTable()
    t_state = tds.encode_tree(port.tree, t_arena, S, prop_table=t_props,
                              device="cpu")
    j_state = jds.encode_tree(jax_client.tree, j_arena, S,
                              prop_table=j_props)
    return (port, t_state, t_arena, t_props), (jax_client, j_state, j_arena,
                                                j_props)


def _segments(tree):
    return [(s.text, bool(s.is_marker), dict(s.props or {}), s.ins_seq,
             s.ins_client, s.rem_seq, sorted(s.rem_clients or ()))
            for s in tree.segments]


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_tree_matches_jax(seed):
    (port, t_state, t_arena, t_props), (_, j_state, j_arena, j_props) = \
        _encode_both(seed)
    got = tds.state_to_numpy(t_state)
    assert t_state.num_docs == 1
    for f in tds.FIELDS:
        np.testing.assert_array_equal(got[f][0], np.asarray(getattr(j_state, f)),
                                      f)
    assert int(got["count"][0]) == len(port.tree.segments) > 2
    assert (got["flags"][0] & tds.FLAG_MARKER).any()
    assert (got["prop_key"][0] != tds.NO_KEY).any()
    assert t_arena.text() == j_arena.text()
    assert t_props.snapshot() == j_props.snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_decode_round_trip_matches_jax(seed):
    (port, t_state, t_arena, t_props), (_, j_state, j_arena, j_props) = \
        _encode_both(seed)
    t_tree = tds.decode_state(t_state, t_arena, t_props)
    j_tree = jds.decode_state(j_state, j_arena, j_props)
    assert _segments(t_tree) == _segments(j_tree) == _segments(port.tree)
    view = port.local_view()
    assert t_tree.get_text(view) == port.get_text()
    for pos in range(port.get_length()):
        assert t_tree.properties_at(pos, view) == port.get_properties_at(pos)


def test_decode_picks_one_doc_of_a_batch():
    (port, t_state, t_arena, t_props), _ = _encode_both(SEEDS[0])
    empty = tds.DocState.empty(1, S, device="cpu")
    batch = tds.DocState(**{f: torch.cat([getattr(empty, f),
                                          getattr(t_state, f)])
                            for f in tds.FIELDS})
    tree = tds.decode_state(batch, t_arena, t_props, doc=1)
    assert _segments(tree) == _segments(port.tree)
    assert tds.decode_state(batch, t_arena, t_props, doc=0).segments == []


def test_encode_refuses_too_many_segments():
    port, _ = _replicas(SEEDS[0])
    n = len(port.tree.segments)
    with pytest.raises(ValueError, match="exceed"):
        tds.encode_tree(port.tree, tds.TextArena(), n - 1,
                        prop_table=tds.PropTable(), device="cpu")


def test_empty_state_matches_jax():
    D, S_, P = 4, 32, 8
    want = jax.vmap(lambda _: jds.DocState.empty(S_, P))(jnp.arange(D))
    got = tds.state_to_numpy(tds.DocState.empty(D, S_, P, device="cpu"))
    for f in tds.FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), f)
        assert got[f].dtype == np.asarray(getattr(want, f)).dtype, f


@pytest.mark.parametrize("seed", [0, 4])
def test_state_carry_over_round_trips_jax_state(seed):
    """A JAX DocState batch after a wave (overflow flags included) crosses
    into the port and back unchanged; a single JAX doc gains D=1."""
    D, S_, K = 8, 16, 32
    rng = np.random.default_rng(seed)
    state = jax.vmap(lambda _: jds.DocState.empty(S_))(jnp.arange(D))
    ops = generate_batch_ops(rng, D, K, remove_fraction=0.4,
                             annotate_fraction=0.1, max_insert=8)
    jstate = japply.apply_ops_batch(state, jnp.asarray(ops))
    arrays = {f: np.asarray(getattr(jstate, f)) for f in tds.FIELDS}
    port = tds.state_from_numpy(arrays, "cpu")
    assert port.overflow.dtype == torch.bool
    assert port.length.dtype == torch.int32
    back = tds.state_to_numpy(port)
    for f in tds.FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f], f)
    one = tds.state_to_numpy(tds.state_from_numpy(
        {f: a[3] for f, a in arrays.items()}, "cpu"))
    for f in tds.FIELDS:
        np.testing.assert_array_equal(one[f][0], arrays[f][3], f)
    moved = port.to("cpu").rows(slice(2, 5))
    assert moved.num_docs == 3 and moved.max_slots == S_
