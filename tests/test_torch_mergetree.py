"""The port's merge-tree semantics against ``tests/test_mergetree.py``.

Each test is the twin of the JAX test of the same name: its op script
runs on each package (the JAX package's ``mergetree`` with
``tests/mergetree_fixtures.py``; the port's ``mergetree`` with
``fluidframework_tpu_torch/testing/farm.py``) with the JAX test's
assertions on both, and what each side shows is compared exactly: every
client's segments with every stamp (``torch_stack_fixtures.segments``)
and rich text after each step of the script, the sequenced log, and each
op's ``op_to_wire`` / ``op_from_wire`` round trip. Tolerance: exact.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import farm_msg, jax_farm_server, segments


def _side(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        from tests import mergetree_fixtures as fx

        from fluidframework_tpu import mergetree, protocol

        server = jax_farm_server
    else:
        from fluidframework_tpu_torch import mergetree, protocol
        from fluidframework_tpu_torch.testing import farm as fx

        server = fx.FarmServer
    return SimpleNamespace(pkg=pkg, mt=mergetree, protocol=protocol,
                           FarmClient=fx.FarmClient, FarmServer=server,
                           assert_converged=fx.assert_converged)


class _Run:
    """One package's run of a script: its farm and what it showed."""

    def __init__(self, pkg: str):
        self.P = _side(pkg)
        self.shown = []
        self.server = None
        self.clients = []

    def farm(self, n, seed=0):
        rng = random.Random(seed)
        self.clients = [self.P.FarmClient(f"c{i}") for i in range(n)]
        self.server = self.P.FarmServer(self.clients, rng)
        return self.clients, self.server

    def step(self, *clients) -> None:
        """Note every client's segments and rich text."""
        for fc in clients or self.clients:
            client = getattr(fc, "client", fc)
            self.shown.append((segments(client), client.get_text()))
            if hasattr(fc, "rich_text"):
                self.shown.append(fc.rich_text())

    def record(self) -> list:
        out = list(self.shown)
        if self.server is not None:
            log = [farm_msg(m) for m in self.server.log]
            mt = self.P.mt
            wire = [mt.op_to_wire(mt.op_from_wire(m[-1])) for m in log]
            assert wire == [m[-1] for m in log]
            out.append(log)
        return out


def twin(script) -> None:
    """Run ``script(run)`` on the JAX package, then on the port, and
    require equal records."""
    records = {}
    for pkg in ("jax", "torch"):
        run = _Run(pkg)
        script(run)
        records[pkg] = run.record()
    assert records["torch"] == records["jax"]


def _basic_insert_remove_local(r):
    c = r.P.mt.MergeTreeClient("a")
    c.insert_text_local(0, "hello world")
    assert c.get_text() == "hello world"
    r.step(c)
    c.remove_range_local(5, 11)
    assert c.get_text() == "hello"
    r.step(c)
    c.insert_text_local(5, "!")
    assert c.get_text() == "hello!"
    r.step(c)


def test_basic_insert_remove_local():
    twin(_basic_insert_remove_local)


def _sequential_edits_converge(r):
    (a, b), server = r.farm(2)
    a.insert(0, "abc")
    server.sequence_all()
    r.step()
    b.insert(3, "def")
    server.sequence_all()
    assert a.text() == b.text() == "abcdef"
    r.step()


def test_sequential_edits_converge():
    twin(_sequential_edits_converge)


def _concurrent_inserts_same_position(r):
    (a, b), server = r.farm(2)
    a.insert(0, "base")
    server.sequence_all()
    a.insert(0, "AA")
    b.insert(0, "BB")
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "concurrent same-pos insert")
    assert set(a.text()[:-4].replace("AA", "").replace("BB", "")) == set()
    assert a.text().endswith("base")
    assert "AA" in a.text() and "BB" in a.text()
    r.step()


def test_concurrent_inserts_same_position():
    twin(_concurrent_inserts_same_position)


def _own_pending_then_remote_insert(r):
    (a, b), server = r.farm(2)
    a.insert(0, "base")
    server.sequence_all()
    a.insert(0, "1")
    a.insert(1, "2")
    b.insert(0, "X")
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "pending-vs-remote")
    assert "12" in a.text()
    r.step()


def test_own_pending_then_remote_insert():
    twin(_own_pending_then_remote_insert)


def _insert_into_concurrently_removed_range(r):
    (a, b), server = r.farm(2)
    a.insert(0, "abcdef")
    server.sequence_all()
    b.insert(3, "XY")
    a.remove(1, 5)
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "insert into removed range")
    assert "XY" in a.text()
    assert a.text() == "aXYf"
    r.step()


def test_insert_into_concurrently_removed_range():
    twin(_insert_into_concurrently_removed_range)


def _overlapping_concurrent_removes(r):
    (a, b), server = r.farm(2)
    a.insert(0, "abcdef")
    server.sequence_all()
    a.remove(1, 4)
    b.remove(2, 5)
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "overlapping removes")
    assert a.text() == "af"
    r.step()


def test_overlapping_concurrent_removes():
    twin(_overlapping_concurrent_removes)


def _remove_then_concurrent_annotate(r):
    (a, b), server = r.farm(2)
    a.insert(0, "abcdef")
    server.sequence_all()
    a.remove(0, 3)
    b.annotate(0, 6, {"bold": True})
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "remove vs annotate")
    assert a.text() == "def"
    r.step()


def test_remove_then_concurrent_annotate():
    twin(_remove_then_concurrent_annotate)


def _annotate_lww_by_seq(r):
    (a, b), server = r.farm(2)
    a.insert(0, "xyz")
    server.sequence_all()
    a.annotate(0, 3, {"color": "red"})
    b.annotate(0, 3, {"color": "blue"})
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b], "annotate LWW")
    colors = {seg.props.get("color") for seg in a.client.tree.segments}
    assert len(colors) == 1
    r.step()


def test_annotate_lww_by_seq():
    twin(_annotate_lww_by_seq)


def _annotate_delete_key(r):
    (a, b), server = r.farm(2)
    a.insert(0, "xyz")
    a.annotate(0, 3, {"k": 1})
    server.sequence_all()
    r.step()
    b.annotate(0, 3, {"k": None})
    server.sequence_all()
    r.P.assert_converged([a, b], "annotate delete")
    assert all("k" not in seg.props for seg in a.client.tree.segments)
    r.step()


def test_annotate_delete_key():
    twin(_annotate_delete_key)


def _marker_insert(r):
    (a, b), server = r.farm(2)
    a.insert(0, "para1")
    a.submit(a.client.insert_marker_local(5, {"refType": 1},
                                          {"type": "pg"}))
    r.step()
    server.sequence_all()
    assert a.client.get_length() == 6
    r.P.assert_converged([a, b], "marker")
    r.step()


def test_marker_insert():
    twin(_marker_insert)


def _zamboni_compacts_and_preserves_text(r):
    (a, b), server = r.farm(2)
    for i in range(10):
        a.insert(a.client.get_length(), f"w{i}")
        server.sequence_all()
        b.insert(0, "z")
        server.sequence_all()
        r.step()
    a.remove(0, 5)
    server.sequence_all()
    a.insert(a.client.get_length(), ".")
    b.insert(0, "-")
    server.sequence_all()
    r.P.assert_converged([a, b], "zamboni")
    assert all(seg.rem_seq is None or seg.rem_seq > a.client.tree.min_seq
               for seg in a.client.tree.segments)
    assert len(a.client.tree.segments) < 24
    r.step()
    r.shown.append(a.client.tree.min_seq)


def test_zamboni_compacts_and_preserves_text():
    twin(_zamboni_compacts_and_preserves_text)


def _snapshot_roundtrip_and_catchup(r):
    (a, b), server = r.farm(2)
    a.insert(0, "hello ")
    b.insert(0, "say: ")
    server.sequence_all()
    a.annotate(0, 4, {"em": 1})
    server.sequence_all()
    snap = a.client.snapshot()
    r.shown.append(snap)
    c = r.P.mt.MergeTreeClient.load("c_new", snap)
    assert c.get_text() == a.text()
    r.step(c)
    b.insert(b.client.get_length(), "world")
    raw = b.outbound[-1]
    server.sequence_all()
    proto = r.P.protocol
    c.apply_msg(proto.SequencedDocumentMessage(
        client_id="c1", sequence_number=server.seq,
        minimum_sequence_number=0,
        client_sequence_number=raw["clientSeq"],
        reference_sequence_number=raw["refSeq"],
        type=proto.MessageType.OPERATION, contents=raw["contents"]))
    assert c.get_text() == a.text()
    r.step(c)


def test_snapshot_roundtrip_and_catchup():
    twin(_snapshot_roundtrip_and_catchup)


def _snapshot_refuses_pending(r):
    c = r.P.mt.MergeTreeClient("a")
    c.insert_text_local(0, "x")
    with pytest.raises(RuntimeError) as err:
        c.snapshot()
    r.shown.append(str(err.value))
    r.step(c)


def test_snapshot_refuses_pending():
    twin(_snapshot_refuses_pending)


def _local_reference_slides_on_remove(r):
    (a, b), server = r.farm(2)
    a.insert(0, "abcdef")
    server.sequence_all()
    ref = a.client.create_reference(3)
    assert a.client.reference_position(ref) == 3
    b.remove(2, 5)
    server.sequence_all()
    pos = a.client.reference_position(ref)
    assert 0 <= pos <= a.client.get_length()
    r.shown.append(pos)
    r.step()


def test_local_reference_slides_on_remove():
    twin(_local_reference_slides_on_remove)


def _three_way_concurrent_edits(r):
    (a, b, c), server = r.farm(3)
    a.insert(0, "The quick brown fox")
    server.sequence_all()
    a.insert(19, " jumps")
    b.remove(4, 10)
    c.annotate(10, 15, {"style": "i"})
    r.step()
    server.sequence_all()
    r.P.assert_converged([a, b, c], "three-way")
    r.step()


def test_three_way_concurrent_edits():
    twin(_three_way_concurrent_edits)
