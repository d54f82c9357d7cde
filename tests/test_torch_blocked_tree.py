"""The port's blocked merge tree against ``tests/test_blocked_tree.py``.

Each test is the twin of the JAX test of the same name. Its scenario
drives the flat oracle and the blocked tree of one package from the same
op stream with the JAX test's assertions (flat equals blocked: text,
length, properties, canonical snapshots), and it runs on both packages:
what each package's replicas show after every step (text and length),
the properties it sampled and its final snapshots are equal between the
packages. ``test_escalated_replay_scales`` feeds the escalation path of
the port's ``GpuDocumentApplier(device="cpu")`` and of the JAX
``TpuDocumentApplier`` the same log: escalations, text and properties
equal. Tolerance: exact, but for the two wall-clock bounds the JAX tests
set (the escalation replay's 30 s; the long doc's per-op growth under
4x, which is marked ``slow`` here: it compares two timings, and its JAX
twin fails under a loaded run's CPU contention).
"""

from __future__ import annotations

import random
import time

import pytest
from tests.torch_stack_fixtures import module

PKGS = ("jax", "torch")


class Duo:
    """One logical client as two replicas: flat oracle + blocked."""

    def __init__(self, pkg: str, name: str):
        mtc = module(pkg, "mergetree.client").MergeTreeClient
        self.flat = mtc(name, blocked=False)
        self.blk = mtc(name, blocked=True)
        self.name = name

    def check(self, where: str, shown: list) -> None:
        assert self.flat.get_length() == self.blk.get_length(), where
        assert self.flat.get_text() == self.blk.get_text(), where
        shown.append(self.flat.get_text())


def _sequencer(pkg: str, duos):
    """Minimal deli: assigns seqs; delivers to every duo (both replicas)."""
    msgs = module(pkg, "protocol.messages")
    state = {"seq": 0}

    def sequence(author: Duo, flat_op, blk_op, ref_seq: int):
        state["seq"] += 1
        seq = state["seq"]
        msn = max(0, seq - 6)
        for duo in duos:
            local = duo is author
            for client, op in ((duo.flat, flat_op), (duo.blk, blk_op)):
                msg = msgs.SequencedDocumentMessage(
                    client_id=author.name, sequence_number=seq,
                    minimum_sequence_number=msn,
                    client_sequence_number=seq,
                    reference_sequence_number=ref_seq,
                    type=msgs.MessageType.OPERATION, contents=op)
                client.apply_msg(msg, local=local)
    return sequence


def _both(scenario, *args) -> None:
    shown = {pkg: scenario(pkg, *args) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _differential_fuzz(pkg: str) -> list:
    shown = []
    rng = random.Random(42)
    duos = [Duo(pkg, "a"), Duo(pkg, "b"), Duo(pkg, "c")]
    sequence = _sequencer(pkg, duos)
    for step in range(600):
        duo = rng.choice(duos)
        ref_seq = duo.flat.tree.current_seq
        assert ref_seq == duo.blk.tree.current_seq
        n = duo.flat.get_length()
        r = rng.random()
        if n > 4 and r < 0.3:
            a = rng.randrange(n - 1)
            b = a + 1 + rng.randrange(min(n - a - 1, 9) + 1)
            flat_op = duo.flat.remove_range_local(a, b)
            blk_op = duo.blk.remove_range_local(a, b)
        elif n > 2 and r < 0.42:
            a = rng.randrange(n - 1)
            b = a + 1 + rng.randrange(min(n - a - 1, 6) + 1)
            props = {"k": rng.randrange(4)}
            flat_op = duo.flat.annotate_range_local(a, b, props)
            blk_op = duo.blk.annotate_range_local(a, b, props)
        elif r < 0.47:
            pos = rng.randrange(n + 1)
            marker = {"kind": "m", "v": step}
            flat_op = duo.flat.insert_marker_local(pos, marker)
            blk_op = duo.blk.insert_marker_local(pos, marker)
        else:
            pos = rng.randrange(n + 1)
            text = "abcdefgh"[: 1 + rng.randrange(6)]
            flat_op = duo.flat.insert_text_local(pos, text)
            blk_op = duo.blk.insert_text_local(pos, text)
        duo.check(f"step {step} local", shown)
        sequence(duo, flat_op, blk_op, ref_seq)
        for d in duos:
            d.check(f"step {step} after seq", shown)
        if rng.random() < 0.1:
            n2 = duo.flat.get_length()
            if n2:
                p = rng.randrange(n2)
                try:
                    pf = duo.flat.get_properties_at(p)
                    pb = duo.blk.get_properties_at(p)
                    assert pf == pb, f"step {step} props@{p}"
                    shown.append(pf)
                except IndexError:
                    shown.append("IndexError")
    for d in duos:
        assert not d.flat.pending and not d.blk.pending
        assert d.flat.snapshot() == d.blk.snapshot()
        shown.append(d.flat.snapshot())
    return shown


def test_differential_fuzz_flat_vs_blocked():
    _both(_differential_fuzz)


def _snapshot_canonical(pkg: str) -> list:
    shown = []
    mtc = module(pkg, "mergetree.client").MergeTreeClient
    rng = random.Random(7)
    duo = Duo(pkg, "a")
    sequence = _sequencer(pkg, [duo])
    for _ in range(120):
        n = duo.flat.get_length()
        if n > 3 and rng.random() < 0.3:
            a = rng.randrange(n - 1)
            f = duo.flat.remove_range_local(a, a + 1)
            b = duo.blk.remove_range_local(a, a + 1)
        else:
            pos = rng.randrange(n + 1)
            f = duo.flat.insert_text_local(pos, "xy")
            b = duo.blk.insert_text_local(pos, "xy")
        sequence(duo, f, b, duo.flat.tree.current_seq)
    snap_f = duo.flat.snapshot()
    snap_b = duo.blk.snapshot()
    assert snap_f == snap_b
    rf = mtc.load("a", snap_f, blocked=False)
    rb = mtc.load("a", snap_f, blocked=True)
    assert rf.get_text() == rb.get_text() == duo.flat.get_text()
    assert rf.snapshot() == rb.snapshot() == snap_f
    shown += [snap_f, rf.get_text()]
    return shown


def test_snapshot_canonical_across_representations():
    _both(_snapshot_canonical)


@pytest.mark.slow
def test_long_doc_latency_near_flat():
    """Per-op time of the port's blocked tree grows under 4x from a
    100k-char doc to a 1M-char doc (the JAX test's bound), and both
    packages build the same 1M-char text."""
    def drive(pkg, client, upto: int, chunk: int = 32):
        msgs = module(pkg, "protocol.messages")
        rng = random.Random(1)
        seq = client.tree.current_seq
        t0 = time.perf_counter()
        ops = 0
        while client.get_length() < upto:
            pos = rng.randrange(client.get_length() + 1)
            op = client.insert_text_local(pos, "x" * chunk)
            seq += 1
            client.apply_msg(msgs.SequencedDocumentMessage(
                client_id=client.client_id, sequence_number=seq,
                minimum_sequence_number=max(0, seq - 8),
                client_sequence_number=seq,
                reference_sequence_number=seq - 1,
                type=msgs.MessageType.OPERATION, contents=op), local=True)
            ops += 1
        return (time.perf_counter() - t0) / max(ops, 1)

    lengths = {}
    for pkg in PKGS:
        c = module(pkg, "mergetree.client").MergeTreeClient(
            "perf", blocked=True)
        small = drive(pkg, c, 100_000)
        drive(pkg, c, 900_000)
        big = drive(pkg, c, 1_000_000)
        lengths[pkg] = (c.get_length(), c.tree.current_seq)
        if pkg == "torch":
            assert big < small * 4, (
                f"per-op latency grew {big / small:.1f}x from 100k to 1M "
                f"chars ({small * 1e6:.0f}us -> {big * 1e6:.0f}us)")
    assert lengths["torch"] == lengths["jax"]


def _escalation_log(pkg: str):
    msgs = module(pkg, "protocol.messages")
    rng = random.Random(3)
    log = []
    length = 0
    for seq in range(1, 6001):
        if length > 40 and rng.random() < 0.2:
            a = rng.randrange(length - 8)
            op = {"type": 1, "start": a, "end": a + 1 + rng.randrange(8)}
            length -= op["end"] - op["start"]
        else:
            op = {"type": 0, "pos": rng.randrange(length + 1),
                  "text": "y" * 40}
            length += 40
        log.append(msgs.SequencedDocumentMessage(
            client_id="gen", sequence_number=seq,
            minimum_sequence_number=max(0, seq - 8),
            client_sequence_number=seq, reference_sequence_number=seq - 1,
            type=msgs.MessageType.OPERATION, contents=op))
    return log, length


def test_escalated_replay_scales():
    """A host escalation replays the doc's whole log through the blocked
    tree: the port's applier (``device="cpu"``) and the JAX applier give
    one escalation and the same ~200k-char text, the port's in under the
    JAX test's 30 s."""
    from fluidframework_tpu.service.tpu_applier import TpuDocumentApplier
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    shown = {}
    for pkg, make in (
            ("jax", lambda: TpuDocumentApplier(
                max_docs=2, max_slots=8, ops_per_dispatch=4)),
            ("torch", lambda: GpuDocumentApplier(
                device="cpu", max_docs=2, max_slots=8,
                ops_per_dispatch=4))):
        log, length = _escalation_log(pkg)
        applier = make()
        applier.set_replay_source(lambda t, d, log=log: log)
        t0 = time.perf_counter()
        for m in log[:40]:
            applier.ingest("t", "doc", m, m.contents)
        applier.flush()
        applier.finalize()
        took = time.perf_counter() - t0
        assert applier.host_escalations == 1
        text = applier.get_text("t", "doc")
        assert len(text) == length
        if pkg == "torch":
            assert took < 30.0, f"escalation replay took {took:.1f}s"
        shown[pkg] = (applier.host_escalations, text,
                      [applier.get_properties_at("t", "doc", p)
                       for p in (0, length // 2, length - 1)])
    assert shown["torch"] == shown["jax"]


def _tiny_blocks(pkg: str, monkeypatch) -> list:
    blocked = module(pkg, "mergetree.blocked")
    monkeypatch.setattr(blocked, "TARGET_BLOCK", 3)
    shown = []
    rng = random.Random(99)
    duos = [Duo(pkg, "a"), Duo(pkg, "b")]
    sequence = _sequencer(pkg, duos)
    for step in range(500):
        duo = rng.choice(duos)
        ref_seq = duo.flat.tree.current_seq
        n = duo.flat.get_length()
        r = rng.random()
        if n > 6 and r < 0.35:
            a = rng.randrange(n - 4)
            b = a + 1 + rng.randrange(min(n - a - 1, 20) + 1)
            f = duo.flat.remove_range_local(a, b)
            k = duo.blk.remove_range_local(a, b)
        elif n > 4 and r < 0.55:
            a = rng.randrange(n - 2)
            b = a + 1 + rng.randrange(min(n - a - 1, 16) + 1)
            props = {"s": rng.randrange(3)}
            f = duo.flat.annotate_range_local(a, b, props)
            k = duo.blk.annotate_range_local(a, b, props)
        else:
            pos = rng.randrange(n + 1)
            text = "qwerty"[: 1 + rng.randrange(5)]
            f = duo.flat.insert_text_local(pos, text)
            k = duo.blk.insert_text_local(pos, text)
        duo.check(f"tiny step {step} local", shown)
        sequence(duo, f, k, ref_seq)
        for d in duos:
            d.check(f"tiny step {step} after seq", shown)
        if rng.random() < 0.2 and duo.flat.get_length():
            p = rng.randrange(duo.flat.get_length())
            assert duo.flat.get_properties_at(p) \
                == duo.blk.get_properties_at(p), f"tiny step {step} props"
            shown.append(duo.flat.get_properties_at(p))
    for d in duos:
        assert d.flat.snapshot() == d.blk.snapshot()
        shown.append(d.flat.snapshot())
    return shown


def test_differential_fuzz_tiny_blocks(monkeypatch):
    _both(_tiny_blocks, monkeypatch)
