"""The port's deli boxcar lane (``service/deli.py``) against
``tests/test_deli_boxcar.py``.

Each test is the twin of the JAX test of the same name: its records are
built on each package and run through that package's deli twice, as
boxcars (the fast lane) and op by op (the scalar lane), with the JAX
test's assertions (the two lanes' sequenced messages and nacks equal).
Between the packages, the sequenced stream (sender, seq, msn, clientSeq,
refSeq, type, contents, timestamp, trace hops), the nacks and the fast
and fallback counters are equal exactly. Tolerance: exact.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

PKGS = ("jax", "torch")


def _p(pkg) -> SimpleNamespace:
    msgs = module(pkg, "protocol.messages")
    deli = module(pkg, "service.deli")
    return SimpleNamespace(
        DocumentMessage=msgs.DocumentMessage, MessageType=msgs.MessageType,
        QueuedMessage=module(pkg, "service.core").QueuedMessage,
        DeliLambda=deli.DeliLambda, RawBoxcar=deli.RawBoxcar,
        RawMessage=deli.RawMessage)


class Capture:
    def __init__(self):
        self.sequenced = []
        self.nacks = []

    def send(self, msg):
        self.sequenced.append(msg)

    def send_batch(self, msgs):
        self.sequenced.extend(msgs)

    def nack(self, client_id, nack):
        self.nacks.append((client_id, nack))


def make_deli(p, cap, batch: bool):
    return p.DeliLambda("t", "d", send_sequenced=cap.send,
                        send_nack=cap.nack, clock=lambda: 1000.0,
                        send_sequenced_batch=cap.send_batch if batch
                        else None)


def feed(p, deli, records, as_boxcars: bool):
    offset = 0
    for rec in records:
        if as_boxcars or not isinstance(rec, p.RawBoxcar):
            deli.handler(p.QueuedMessage(offset, "raw", 0, rec))
            offset += 1
        else:
            for op in rec.ops:
                deli.handler(p.QueuedMessage(offset, "raw", 0, p.RawMessage(
                    rec.tenant_id, rec.document_id, rec.client_id, op,
                    rec.timestamp)))
                offset += 1


def msg_key(m):
    return (m.client_id, m.sequence_number, m.minimum_sequence_number,
            m.client_sequence_number, m.reference_sequence_number,
            m.type.value, repr(m.contents), m.timestamp,
            [(t.service, t.action, t.timestamp) for t in m.traces])


def join(p, client_id, ts=1000.0):
    return p.RawMessage("t", "d", None, p.DocumentMessage(
        -1, -1, p.MessageType.CLIENT_JOIN, {"clientId": client_id}),
        timestamp=ts)


def leave(p, client_id, ts=1000.0):
    return p.RawMessage("t", "d", None, p.DocumentMessage(
        -1, -1, p.MessageType.CLIENT_LEAVE, {"clientId": client_id}),
        timestamp=ts)


def run_both(p, records):
    cap_s, cap_b = Capture(), Capture()
    feed(p, make_deli(p, cap_s, batch=False), records, as_boxcars=False)
    deli_b = make_deli(p, cap_b, batch=True)
    feed(p, deli_b, records, as_boxcars=True)
    stream = [msg_key(m) for m in cap_b.sequenced]
    assert stream == [msg_key(m) for m in cap_s.sequenced]
    nacks = [(c, n.message) for c, n in cap_b.nacks]
    assert nacks == [(c, n.message) for c, n in cap_s.nacks]
    return deli_b, [stream, nacks, deli_b.boxcars_fast,
                    deli_b.boxcars_fallback]


def _both(scenario) -> None:
    shown = {pkg: scenario(_p(pkg)) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _happy_path(p):
    op = p.MessageType.OPERATION
    records = [join(p, "a"), join(p, "b")]
    ops_a = [p.DocumentMessage(i + 1, 2, op, {"n": i}) for i in range(5)]
    ops_b = [p.DocumentMessage(i + 1, 2, op, {"n": 100 + i})
             for i in range(3)]
    records.append(p.RawBoxcar("t", "d", "a", ops_a, timestamp=1001.0))
    records.append(p.RawBoxcar("t", "d", "b", ops_b, timestamp=1002.0))
    deli, shown = run_both(p, records)
    assert deli.boxcars_fast == 2
    assert deli.boxcars_fallback == 0
    return shown


def test_boxcar_happy_path_is_fast_and_identical():
    _both(_happy_path)


def _msn_tracks(p):
    records = [join(p, "a"), join(p, "b")]
    ops = [p.DocumentMessage(i + 1, 2 + i, p.MessageType.OPERATION, {})
           for i in range(4)]
    records.append(p.RawBoxcar("t", "d", "b", ops, timestamp=1003.0))
    return run_both(p, records)[1]


def test_boxcar_msn_tracks_growing_refseq_within_boxcar():
    _both(_msn_tracks)


def _fallbacks(p):
    op = p.MessageType.OPERATION
    records = [join(p, "a"), join(p, "b")]
    ops = [p.DocumentMessage(i + 1, 2, op, {}) for i in range(3)]
    box = p.RawBoxcar("t", "d", "a", ops, timestamp=1001.0)
    records.append(box)
    records.append(box)
    records.append(p.RawBoxcar("t", "d", "a",
                               [p.DocumentMessage(9, 3, op, {})], 1002.0))
    records.append(p.RawBoxcar("t", "d", "ghost",
                               [p.DocumentMessage(1, 0, op, {})], 1002.5))
    records.append(p.RawBoxcar("t", "d", "b", [
        p.DocumentMessage(1, 3, op, {}),
        p.DocumentMessage(2, 3, p.MessageType.NOOP, None)], 1003.0))
    deli, shown = run_both(p, records)
    assert deli.boxcars_fallback >= 4
    return shown


def test_boxcar_fallbacks_match_scalar():
    _both(_fallbacks)


def _fuzz(p):
    op = p.MessageType.OPERATION
    rng = random.Random(7)
    clients = ["a", "b", "c"]
    records = [join(p, c) for c in clients]
    state = {c: {"cseq": 0, "ref": 0} for c in clients}
    head = 3
    for _ in range(200):
        roll = rng.random()
        c = rng.choice(clients)
        if roll < 0.08:
            records.append(leave(p, c))
            records.append(join(p, c))
            state[c] = {"cseq": 0, "ref": head}
            head += 2
        elif roll < 0.16:
            kind = rng.choice(["dup", "gap", "stale"])
            if kind == "dup":
                cseq = max(1, state[c]["cseq"])
            elif kind == "gap":
                cseq = state[c]["cseq"] + 5
            else:
                cseq = state[c]["cseq"] + 1
            ref = -5 if kind == "stale" else state[c]["ref"]
            records.append(p.RawBoxcar("t", "d", c, [p.DocumentMessage(
                cseq, ref, op, {"adv": kind})], 1000.0))
        else:
            n = rng.randint(1, 6)
            ops = []
            ref = state[c]["ref"]
            for _ in range(n):
                state[c]["cseq"] += 1
                if rng.random() < 0.3:
                    ref += rng.randint(0, 2)
                ops.append(p.DocumentMessage(state[c]["cseq"], ref, op,
                                             {"r": rng.randint(0, 99)}))
            state[c]["ref"] = ref
            head += n
            records.append(p.RawBoxcar("t", "d", c, ops, timestamp=1000.0))
        for cc in clients:
            state[cc]["ref"] += rng.randint(0, 1)
    deli, shown = run_both(p, records)
    assert deli.boxcars_fast > 10
    return shown


def test_boxcar_fuzz_equivalence():
    _both(_fuzz)


def _checkpoint_restart(p):
    records = [join(p, "a"), join(p, "b")]
    for r in range(4):
        ops = [p.DocumentMessage(r * 3 + i + 1, 2, p.MessageType.OPERATION,
                                 {"r": r}) for i in range(3)]
        records.append(p.RawBoxcar("t", "d", "a", ops,
                                   timestamp=1001.0 + r))
    cap1 = Capture()
    deli1 = make_deli(p, cap1, batch=True)
    feed(p, deli1, records, as_boxcars=True)
    cp = deli1.checkpoint()
    cap2 = Capture()
    deli2 = p.DeliLambda("t", "d", send_sequenced=cap2.send,
                         send_nack=cap2.nack, checkpoint=cp,
                         clock=lambda: 1000.0,
                         send_sequenced_batch=cap2.send_batch)
    feed(p, deli2, records, as_boxcars=True)
    assert cap2.sequenced == []
    assert deli2.sequence_number == deli1.sequence_number
    cap3 = Capture()
    deli3 = make_deli(p, cap3, batch=True)
    feed(p, deli3, records + records, as_boxcars=True)
    stream = [msg_key(m) for m in cap3.sequenced]
    assert stream == [msg_key(m) for m in cap1.sequenced]
    return [stream, repr(cp), deli2.sequence_number]


def test_boxcar_checkpoint_restart_equivalence():
    _both(_checkpoint_restart)
