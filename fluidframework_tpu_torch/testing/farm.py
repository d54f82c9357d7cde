"""Seeded concurrent multi-client merge-tree sessions.

JAX counterpart: ``tests/mergetree_fixtures.py`` (``FarmClient``,
``FarmServer``, ``assert_converged``, ``random_op``), copied with its
imports rebased so that ``chip_smoke.py`` can make sequenced streams
without the JAX package. One addition: ``FarmServer.log`` keeps every
sequenced message, which is the stream an applier ingests.

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
        out = []
        view = self.client.local_view()
        for seg in self.client.tree.segments:
            if seg.visible_in(view):
                if seg.is_marker:
                    out.append(("￼", tuple(sorted(seg.props.items()))))
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
    rng = random.Random(seed)
    clients = [FarmClient(f"c{i}") for i in range(n_clients)]
    server = FarmServer(clients, rng)
    for k in range(n_ops):
        random_op(clients[k % n_clients], rng)
        if k % sequence_every == sequence_every - 1:
            for _ in range(rng.randint(0, sequence_every)):
                server.sequence_one()
    server.sequence_all()
    assert_converged(clients, f"seed {seed}")
    return server.log, clients[0].text()
