"""Seeded concurrent multi-client merge-tree sessions.

JAX counterpart: ``tests/mergetree_fixtures.py`` (``FarmClient``,
``FarmServer``, ``assert_converged``, ``random_op``), copied with its
imports rebased so that ``chip_smoke.py`` can make sequenced streams
without the JAX package. One addition: ``FarmServer.log`` keeps every
sequenced message, which is the stream an applier ingests.

The session generators below are the farms of
``tests/test_mergetree_farm.py`` as functions (conflict, inserts and
removes only, reconnect, reconnect storm, long-document growth): each
runs one seeded farm exactly as the JAX test does, checks convergence
every round, and returns ``(server.log, clients)``. The reconnect step
(drop a client's queued ops, ``regenerate_pending_ops``, resubmit at the
current refSeq) is the tests' own, so these streams carry rebased ops
(one an insert's surviving part, one a removed or annotated range) sent
before earlier ops of the same client were sequenced.

Mirrors the reference's test harness (TestClient + TestServer,
testServer.ts): a fake ordering service that assigns sequence numbers
while preserving each client's FIFO submit order, delivering every
sequenced message to all clients (including the author, as its ack).
"""

from __future__ import annotations

import random
from collections import deque

from ..mergetree import MergeTreeClient, op_to_wire
from ..protocol import MessageType, SequencedDocumentMessage


class FarmClient:
    """A MergeTreeClient plus its outbound queue of unsequenced ops."""

    def __init__(self, name: str):
        self.client = MergeTreeClient(name)
        self.name = name
        self.client_seq = 0
        self.outbound: deque[dict] = deque()

    def submit(self, op) -> None:
        self.client_seq += 1
        self.outbound.append(
            {
                "clientSeq": self.client_seq,
                "refSeq": self.client.tree.current_seq,
                "contents": op_to_wire(op),
            }
        )

    # convenience local-op helpers that auto-submit
    def insert(self, pos: int, text: str, props=None):
        self.submit(self.client.insert_text_local(pos, text, props))

    def remove(self, start: int, end: int):
        self.submit(self.client.remove_range_local(start, end))

    def annotate(self, start: int, end: int, props: dict):
        self.submit(self.client.annotate_range_local(start, end, props))

    def text(self) -> str:
        return self.client.get_text()

    def rich_text(self):
        """(char, frozen props) sequence — convergence must include props."""
        return rich_text(self.client)


def rich_text(client: MergeTreeClient) -> list:
    """A merge-tree client's visible content as (char, frozen props)
    pairs, a marker as one object-replacement character."""
    out = []
    view = client.local_view()
    for seg in client.tree.segments:
        if seg.visible_in(view):
            if seg.is_marker:
                out.append(("\ufffc", tuple(sorted(seg.props.items()))))
            else:
                p = tuple(sorted(seg.props.items()))
                out.extend((ch, p) for ch in seg.text)
    return out


class FarmServer:
    """Fake sequencer: random cross-client interleaving, per-client FIFO,
    deli-style msn = min of connected clients' last reference seq."""

    def __init__(self, clients: list[FarmClient], rng: random.Random):
        self.clients = clients
        self.rng = rng
        self.seq = 0
        self.client_ref = {c.name: 0 for c in clients}
        self.log: list[SequencedDocumentMessage] = []

    def pending_count(self) -> int:
        return sum(len(c.outbound) for c in self.clients)

    def sequence_one(self) -> bool:
        ready = [c for c in self.clients if c.outbound]
        if not ready:
            return False
        sender = self.rng.choice(ready)
        raw = sender.outbound.popleft()
        self.seq += 1
        self.client_ref[sender.name] = max(
            self.client_ref[sender.name], raw["refSeq"]
        )
        msn = min(self.client_ref.values())
        msg = SequencedDocumentMessage(
            client_id=sender.name,
            sequence_number=self.seq,
            minimum_sequence_number=msn,
            client_sequence_number=raw["clientSeq"],
            reference_sequence_number=raw["refSeq"],
            type=MessageType.OPERATION,
            contents=raw["contents"],
        )
        self.log.append(msg)
        for c in self.clients:
            c.client.apply_msg(msg)
        return True

    def sequence_all(self) -> None:
        while self.sequence_one():
            pass


def assert_converged(clients: list[FarmClient], context: str = "") -> None:
    base = clients[0]
    for other in clients[1:]:
        if base.rich_text() != other.rich_text():
            lines = [f"DIVERGENCE {context}"]
            for c in clients:
                lines.append(f"  {c.name}: {c.text()!r}")
                for seg in c.client.tree.segments:
                    lines.append(f"    {seg!r}")
            raise AssertionError("\n".join(lines))


def random_op(fc: FarmClient, rng: random.Random,
              allow_annotate: bool = True) -> None:
    """One random local op, weighted toward inserts so docs grow."""
    n = fc.client.get_length()
    roll = rng.random()
    if n == 0 or roll < 0.55:
        pos = rng.randint(0, n)
        text = "".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 4)))
        props = None
        if allow_annotate and rng.random() < 0.2:  # insert-with-props
            props = {"k": rng.randint(0, 3)}
        fc.insert(pos, text, props)
    elif roll < 0.85 or not allow_annotate:
        start = rng.randint(0, n - 1)
        end = rng.randint(start + 1, min(n, start + 5))
        fc.remove(start, end)
    elif roll < 0.95:
        start = rng.randint(0, n - 1)
        end = rng.randint(start + 1, min(n, start + 6))
        fc.annotate(start, end, {"k": rng.randint(0, 3)})
    else:  # key deletion
        start = rng.randint(0, n - 1)
        end = rng.randint(start + 1, min(n, start + 6))
        fc.annotate(start, end, {"k": None})


def run_session(seed: int, n_clients: int = 2, n_ops: int = 48,
                sequence_every: int = 3) -> tuple[list, str]:
    """One seeded concurrent session: ``n_clients`` clients make
    ``n_ops`` random local ops in turn, the server sequences a few
    between rounds (so ops stay concurrent), and everything drains.
    Returns (the sequenced messages, the converged text)."""
    rng, clients, server = _farm(seed, n_clients)
    for k in range(n_ops):
        random_op(clients[k % n_clients], rng)
        if k % sequence_every == sequence_every - 1:
            for _ in range(rng.randint(0, sequence_every)):
                server.sequence_one()
    server.sequence_all()
    assert_converged(clients, f"seed {seed}")
    return server.log, clients[0].text()


def reconnect(fc: FarmClient) -> None:
    """A client "reconnects": its unsequenced ops are dropped at the
    server, and it resubmits the regenerated (rebased) pending ops
    against its current state."""
    fc.outbound.clear()
    for op in fc.client.regenerate_pending_ops():
        fc.client_seq += 1
        fc.outbound.append(
            {
                "clientSeq": fc.client_seq,
                "refSeq": fc.client.tree.current_seq,
                "contents": op_to_wire(op),
            }
        )


# (n_clients, rounds, ops_per_round) of the conflict farm's cases, whose
# seeds are 1..7 in this order
CONFLICT_SHAPES = ((2, 30, 2), (2, 30, 2), (3, 25, 2), (3, 25, 3),
                   (5, 15, 2), (5, 20, 3), (8, 10, 2))


def _farm(seed: int, n_clients: int):
    rng = random.Random(seed)
    clients = [FarmClient(f"c{i}") for i in range(n_clients)]
    return rng, clients, FarmServer(clients, rng)


def _round_done(clients, context: str, on_round, rnd: int) -> None:
    assert_converged(clients, context)
    if on_round is not None:
        on_round(rnd, clients)


def conflict_session(seed: int, on_round=None) -> tuple[list, list]:
    """The conflict farm at ``seed`` (its shape ``CONFLICT_SHAPES`` cycled
    by seed, seed 1 the first): every client makes ops concurrently, a
    random prefix is sequenced, some clients make more against the
    partly delivered state, everything drains. ``on_round(rnd, clients)``
    runs after each round's convergence check."""
    n_clients, rounds, ops_per_round = \
        CONFLICT_SHAPES[(seed - 1) % len(CONFLICT_SHAPES)]
    rng, clients, server = _farm(seed, n_clients)
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
        _round_done(clients, f"seed={seed} round={rnd}", on_round, rnd)
    return server.log, clients


def inserts_removes_session(seed: int, on_round=None) -> tuple[list, list]:
    """The inserts-and-removes farm (rng seed ``1000 + seed``): 4 clients,
    20 rounds of 3 ops each with no annotates, all sequenced a round."""
    rng, clients, server = _farm(1000 + seed, 4)
    for rnd in range(20):
        for fc in clients:
            for _ in range(3):
                random_op(fc, rng, allow_annotate=False)
        server.sequence_all()
        _round_done(clients, f"ir-seed={seed} round={rnd}", on_round, rnd)
    return server.log, clients


def reconnect_session(seed: int, on_round=None) -> tuple[list, list]:
    """The reconnect farm (rng seed ``2000 + seed``): 3 clients, 20
    rounds; a random prefix is sequenced, then one client reconnects."""
    rng, clients, server = _farm(2000 + seed, 3)
    for rnd in range(20):
        for fc in clients:
            for _ in range(2):
                random_op(fc, rng)
        for _ in range(rng.randint(0, server.pending_count())):
            server.sequence_one()
        reconnect(rng.choice(clients))
        server.sequence_all()
        _round_done(clients, f"rc-seed={seed} round={rnd}", on_round, rnd)
    return server.log, clients


def storm_session(seed: int, on_round=None) -> tuple[list, list]:
    """The reconnect-storm farm (rng seed ``3000 + seed``): 3 clients, 15
    rounds of up to two reconnects each, with sequencing between them."""
    rng, clients, server = _farm(3000 + seed, 3)
    for rnd in range(15):
        for fc in clients:
            for _ in range(rng.randint(1, 4)):
                random_op(fc, rng)
        for _ in range(rng.randint(0, server.pending_count())):
            server.sequence_one()
        for _ in range(rng.randint(0, 2)):
            reconnect(rng.choice(clients))
            for _ in range(rng.randint(0, server.pending_count())):
                server.sequence_one()
        server.sequence_all()
        _round_done(clients, f"storm-seed={seed} round={rnd}", on_round,
                    rnd)
    return server.log, clients


def growth_session(seed: int = 42, on_round=None) -> tuple[list, list]:
    """The long-document growth farm: 3 clients, 150 rounds of one op
    each, all sequenced a round (the JAX test's seed is 42)."""
    rng, clients, server = _farm(seed, 3)
    for rnd in range(150):
        for fc in clients:
            random_op(fc, rng)
        server.sequence_all()
        if on_round is not None:
            on_round(rnd, clients)
    assert_converged(clients, "long-doc")
    return server.log, clients
