"""The port's merge-tree convergence farms against ``tests/test_mergetree_farm.py``.

Each test is the twin of the JAX test of the same name and ids. The JAX
side runs that test's farm as written, on ``tests/mergetree_fixtures.py``
and the JAX package's ``mergetree``; the port's side runs the session
generator of ``fluidframework_tpu_torch/testing/farm.py`` at the same
seed (``conflict_session``, ``inserts_removes_session``,
``reconnect_session``, ``storm_session``, ``growth_session``), which
asserts convergence every round as the JAX test does. Tolerance: exact.
After every round both sides' sequenced logs (sender, seq, clientSeq,
refSeq, msn, wire contents) and every client's rich text (``(char,
props)`` runs) are equal, and at the end both logs and texts are equal
as a whole; the growth doc also keeps the JAX test's segment bound.
"""

from __future__ import annotations

import random

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.mergetree_fixtures import FarmClient, assert_converged, random_op
from tests.torch_stack_fixtures import farm_msg, jax_farm_server

from fluidframework_tpu.mergetree import op_to_wire as jax_op_to_wire
from fluidframework_tpu_torch.testing import farm


class _Recorder:
    """What a farm shows after each round: the log so far and every
    client's rich text."""

    def __init__(self):
        self.rounds = []
        self.log = self.final = None

    def __call__(self, rnd, clients):
        self.rounds.append((rnd, [c.rich_text() for c in clients]))

    def close(self, log, clients):
        self.log = [farm_msg(m) for m in log]
        self.final = [c.rich_text() for c in clients]


def _jax_farm(seed, n_clients):
    rng = random.Random(seed)
    clients = [FarmClient(f"c{i}") for i in range(n_clients)]
    return rng, clients, jax_farm_server(clients, rng)


def _jax_reconnect(fc):
    """The JAX tests' inline reconnect step."""
    fc.outbound.clear()
    for op in fc.client.regenerate_pending_ops():
        fc.client_seq += 1
        fc.outbound.append({"clientSeq": fc.client_seq,
                            "refSeq": fc.client.tree.current_seq,
                            "contents": jax_op_to_wire(op)})


def _compare(jax_rec: _Recorder, port_rec: _Recorder) -> None:
    assert len(port_rec.rounds) == len(jax_rec.rounds)
    for (rnd, jax_texts), (prnd, port_texts) in zip(jax_rec.rounds,
                                                     port_rec.rounds):
        assert prnd == rnd
        assert port_texts == jax_texts, f"round {rnd}"
    assert port_rec.log == jax_rec.log
    assert port_rec.final == jax_rec.final


def _run_port(gen, seed):
    rec = _Recorder()
    log, clients = gen(seed, on_round=rec)
    rec.close(log, clients)
    return rec, clients


@pytest.mark.parametrize("n_clients,rounds,ops_per_round,seed", [
    (2, 30, 2, 1),
    (2, 30, 2, 2),
    (3, 25, 2, 3),
    (3, 25, 3, 4),
    (5, 15, 2, 5),
    (5, 20, 3, 6),
    (8, 10, 2, 7),
])
def test_conflict_farm(n_clients, rounds, ops_per_round, seed):
    assert farm.CONFLICT_SHAPES[seed - 1] == (n_clients, rounds,
                                              ops_per_round)
    rec = _Recorder()
    rng, clients, server = _jax_farm(seed, n_clients)
    for rnd in range(rounds):
        for fc in clients:
            for _ in range(ops_per_round):
                random_op(fc, rng)
        partial = rng.randint(0, server.pending_count())
        for _ in range(partial):
            server.sequence_one()
        for fc in clients:
            if rng.random() < 0.3:
                random_op(fc, rng)
        server.sequence_all()
        assert_converged(clients, f"seed={seed} round={rnd}")
        rec(rnd, clients)
    rec.close(server.log, clients)
    _compare(rec, _run_port(farm.conflict_session, seed)[0])


@pytest.mark.parametrize("seed", range(8))
def test_conflict_farm_inserts_removes_only(seed):
    rec = _Recorder()
    rng, clients, server = _jax_farm(1000 + seed, 4)
    for rnd in range(20):
        for fc in clients:
            for _ in range(3):
                random_op(fc, rng, allow_annotate=False)
        server.sequence_all()
        assert_converged(clients, f"ir-seed={seed} round={rnd}")
        rec(rnd, clients)
    rec.close(server.log, clients)
    port, _ = _run_port(farm.inserts_removes_session, seed)
    _compare(rec, port)
    # no annotate reached the wire
    assert all(m[-1]["type"] != 2 for m in port.log)


@pytest.mark.parametrize("seed", range(6))
def test_reconnect_farm(seed):
    rec = _Recorder()
    rng, clients, server = _jax_farm(2000 + seed, 3)
    for rnd in range(20):
        for fc in clients:
            for _ in range(2):
                random_op(fc, rng)
        for _ in range(rng.randint(0, server.pending_count())):
            server.sequence_one()
        _jax_reconnect(rng.choice(clients))
        server.sequence_all()
        assert_converged(clients, f"rc-seed={seed} round={rnd}")
        rec(rnd, clients)
    rec.close(server.log, clients)
    port, _ = _run_port(farm.reconnect_session, seed)
    _compare(rec, port)
    # the resubmitted ops reach the sequencer with stale refSeqs
    assert any(m[3] < m[1] - 1 for m in port.log)


@pytest.mark.parametrize("seed", range(6))
def test_reconnect_storm_farm(seed):
    rec = _Recorder()
    rng, clients, server = _jax_farm(3000 + seed, 3)
    for rnd in range(15):
        for fc in clients:
            for _ in range(rng.randint(1, 4)):
                random_op(fc, rng)
        for _ in range(rng.randint(0, server.pending_count())):
            server.sequence_one()
        for _ in range(rng.randint(0, 2)):
            _jax_reconnect(rng.choice(clients))
            for _ in range(rng.randint(0, server.pending_count())):
                server.sequence_one()
        server.sequence_all()
        assert_converged(clients, f"storm-seed={seed} round={rnd}")
        rec(rnd, clients)
    rec.close(server.log, clients)
    _compare(rec, _run_port(farm.storm_session, seed)[0])


def test_long_document_growth():
    rec = _Recorder()
    rng, clients, server = _jax_farm(42, 3)
    for rnd in range(150):
        for fc in clients:
            random_op(fc, rng)
        server.sequence_all()
        rec(rnd, clients)
    assert_converged(clients, "long-doc")
    rec.close(server.log, clients)
    port, port_clients = _run_port(farm.growth_session, 42)
    _compare(rec, port)
    for side in (clients, port_clients):
        text_len = side[0].client.get_length()
        seg_count = len(side[0].client.tree.segments)
        # zamboni keeps metadata roughly proportional to text, not to op
        # count
        assert seg_count < max(200, text_len)
    assert len(port_clients[0].client.tree.segments) == \
        len(clients[0].client.tree.segments)
