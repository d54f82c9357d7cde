"""The port's DDS catalog against the JAX package's: cell, counter,
directory, consensus register and queue, ink, summary block, matrix.

Each test is the twin of the test of the same name in
``tests/test_dds_catalog.py``: its scenario runs with the JAX test's
assertions on each package's ``LocalServer`` and local-driver loader
(``torch_stack_fixtures.twin``), and every container's channels then
agree between the packages exactly: each channel's value as a reader
sees it and its ``snapshot()`` JSON, with client ids mapped by first
appearance. Values a scenario reads on the way are noted and compared
too. Host code, so nothing is loosened: tolerance 0.
"""

import random

import pytest
from tests.torch_stack_fixtures import twin


def pair(t, channel_type, doc="doc", name="ch"):
    c1 = t.loader.resolve("t", doc)
    c2 = t.loader.resolve("t", doc)
    d1 = c1.runtime.create_data_store("default").create_channel(
        name, channel_type)
    d2 = c2.runtime.get_data_store("default").get_channel(name)
    return c1, c2, d1, d2


# ----------------------------------------------------------------- cell

def _cell_lww_and_pending_mask(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-cell")
    a.set(1)
    assert b.get() == 1
    server._auto_drain = False
    b.set(2)
    a.set(3)  # later in total order → wins everywhere
    t.note(a.get(), b.get())  # each side's optimistic value, in flight
    server.drain()
    assert a.get() == b.get() == 3
    a.delete()
    server.drain()
    assert b.empty


def test_cell_lww_and_pending_mask():
    twin(_cell_lww_and_pending_mask)


# -------------------------------------------------------------- counter

def _counter_commutative_increments(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-counter")
    server._auto_drain = False
    a.increment(5)
    b.increment(-2)
    a.increment(1)
    t.note(a.value, b.value, a.snapshot(), b.snapshot())
    server.drain()
    assert a.value == b.value == 4


def test_counter_commutative_increments():
    twin(_counter_commutative_increments)


def _counter_offline_reconnect(t):
    c1, c2, a, b = pair(t, "shared-counter")
    c1.disconnect()
    a.increment(10)
    b.increment(1)
    t.note(a.value, b.value)
    c1.reconnect()
    assert a.value == b.value == 11


def test_counter_offline_reconnect():
    twin(_counter_offline_reconnect)


# ------------------------------------------------------------ directory

def _directory_subdirs_and_values(t):
    c1, c2, a, b = pair(t, "shared-directory")
    a.set("rootKey", 1)
    sub = a.create_subdirectory("sub")
    sub.set("x", "deep")
    nested = sub.create_subdirectory("nested")
    nested.set("y", [1, 2])
    assert b.get("rootKey") == 1
    assert b.get_working_directory("/sub").get("x") == "deep"
    assert b.get_working_directory("/sub/nested").get("y") == [1, 2]
    b.get_working_directory("/sub").delete("x")
    assert a.get_working_directory("/sub").get("x") is None


def test_directory_subdirs_and_values():
    twin(_directory_subdirs_and_values)


def _directory_pending_local_wins(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-directory")
    sub_a = a.create_subdirectory("s")
    server.drain()
    sub_b = b.get_subdirectory("s")
    server._auto_drain = False
    sub_b.set("k", "b-val")
    sub_a.set("k", "a-val")  # later in order → wins
    t.note(sub_a.get("k"), sub_b.get("k"))
    server.drain()
    assert sub_a.get("k") == sub_b.get("k") == "a-val"


def test_directory_pending_local_wins():
    twin(_directory_pending_local_wins)


def _directory_concurrent_delete_recreate_converges(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-directory")
    a.create_subdirectory("x")
    server.drain()
    server._auto_drain = False
    b.delete_subdirectory("x")
    b.create_subdirectory("x")
    a.delete_subdirectory("x")  # sequenced last → wins
    server.drain()
    assert a.get_subdirectory("x") is None
    assert b.get_subdirectory("x") is None


def test_directory_concurrent_delete_recreate_converges():
    twin(_directory_concurrent_delete_recreate_converges)


def _directory_delete_parent_vs_create_child_converges(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-directory")
    a.create_subdirectory("p")
    server.drain()
    server._auto_drain = False
    b.delete_subdirectory("p")  # sequenced first
    a.get_subdirectory("p").create_subdirectory("c")
    server.drain()
    # the delete killed the subtree; the interior create must not resurrect
    assert (a.get_working_directory("/p/c") is None) == (
        b.get_working_directory("/p/c") is None)
    assert (a.get_subdirectory("p") is None) == (
        b.get_subdirectory("p") is None)
    t.note(a.get_working_directory("/p/c") is None,
           a.get_subdirectory("p") is None)


def test_directory_delete_parent_vs_create_child_converges():
    twin(_directory_delete_parent_vs_create_child_converges)


def _directory_recreate_masks_interior_remote_ops(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-directory")
    a.create_subdirectory("x")
    server.drain()
    server._auto_drain = False
    a.delete_subdirectory("x")
    a.create_subdirectory("x")  # fresh empty node, both ops in flight
    b.get_subdirectory("x").set("k", 5)  # sequenced between them
    server.drain()
    # a's recreate is last: the subtree is empty on BOTH replicas
    assert a.get_subdirectory("x").get("k") == \
        b.get_subdirectory("x").get("k")
    t.note(a.get_subdirectory("x").get("k"))


def test_directory_recreate_masks_interior_remote_ops():
    twin(_directory_recreate_masks_interior_remote_ops)


# ---------------------------------------------------- consensus register

def _register_atomic_first_write_wins(t):
    server = t.server
    c1, c2, a, b = pair(t, "consensus-register-collection")
    server._auto_drain = False
    a.write("leader", c1.client_id)
    b.write("leader", c2.client_id)
    server.drain()
    # both versions coexist (neither writer had seen the other)
    assert set(a.read_versions("leader")) == {c1.client_id, c2.client_id}
    # atomic read = first sequenced = consensus winner, same on both
    assert a.read("leader") == b.read("leader") == c1.client_id
    assert a.read("leader", "lww") == c2.client_id
    t.note(a.read_versions("leader"), b.read_versions("leader"))
    # a later write that has seen both supersedes them
    a.write("leader", "final")
    server.drain()
    assert b.read_versions("leader") == ["final"]


def test_register_atomic_first_write_wins():
    twin(_register_atomic_first_write_wins)


# ------------------------------------------------------- consensus queue

def _queue_exactly_once_acquire(t):
    server = t.server
    c1, c2, a, b = pair(t, "consensus-queue")
    a.add("job1")
    a.add("job2")
    server._auto_drain = False
    a.acquire()
    b.acquire()
    server.drain()
    held_a, held_b = a.holding(c1.client_id), b.holding(c2.client_id)
    # each job handed to exactly one client, consistently on both replicas
    assert len(held_a) == 1 and len(held_b) == 1
    assert {held_a[0][1], held_b[0][1]} == {"job1", "job2"}
    assert a.holding(c1.client_id) == b.holding(c1.client_id)
    t.note(held_a, held_b)
    # complete removes durably
    item_id = held_a[0][0]
    a.complete(item_id)
    server.drain()
    assert b.holding(c1.client_id) == []


def test_queue_exactly_once_acquire():
    twin(_queue_exactly_once_acquire)


def _queue_release_requeues(t):
    c1, c2, a, b = pair(t, "consensus-queue")
    a.add("job")
    a.acquire()
    item_id = a.holding()[0][0]
    t.note(item_id)
    a.release(item_id)
    assert len(a) == len(b) == 1
    b.acquire()
    assert b.holding()[0][1] == "job"


def test_queue_release_requeues():
    twin(_queue_release_requeues)


def _queue_holder_leave_requeues(t):
    c1, c2, a, b = pair(t, "consensus-queue")
    a.add("orphan")
    a.acquire()
    assert len(b) == 0
    c1.close()  # leave is sequenced; b sees the requeue
    assert len(b) == 1
    b.acquire()
    assert b.holding()[0][1] == "orphan"


def test_queue_holder_leave_requeues():
    twin(_queue_holder_leave_requeues)


# ------------------------------------------------------------------- ink

def _ink_strokes_converge(t):
    c1, c2, a, b = pair(t, "ink")
    sid = a.create_stroke({"color": "red", "thickness": 2})
    a.append_point(sid, 0.0, 0.0)
    a.append_point(sid, 1.0, 1.5)
    sid2 = b.create_stroke({"color": "blue"})
    b.append_point(sid2, 5.0, 5.0)
    t.note(sid, sid2)
    for ink in (a, b):
        strokes = ink.get_strokes()
        assert len(strokes) == 2
        assert ink.get_stroke(sid)["points"] == [
            {"x": 0.0, "y": 0.0}, {"x": 1.0, "y": 1.5}]
        assert ink.get_stroke(sid2)["pen"] == {"color": "blue"}


def test_ink_strokes_converge():
    twin(_ink_strokes_converge)


def _ink_stroke_order_converges(t):
    server = t.server
    c1, c2, a, b = pair(t, "ink")
    server._auto_drain = False
    s1 = a.create_stroke({"n": 1})
    s2 = b.create_stroke({"n": 2})
    server.drain()
    assert [s["id"] for s in a.get_strokes()] == \
        [s["id"] for s in b.get_strokes()]
    assert a.snapshot()["order"] == b.snapshot()["order"]
    t.note(s1, s2, a.snapshot()["order"])


def test_ink_stroke_order_converges():
    twin(_ink_stroke_order_converges)


def _ink_snapshot_is_acked_state_only(t):
    server = t.server
    c1, c2, a, b = pair(t, "ink")
    sid = a.create_stroke({})
    a.append_point(sid, 0, 0)
    server._auto_drain = False
    b.append_point(sid, 9, 9)  # remote point sequenced before a's pending
    server.drain()
    a.append_point(sid, 1, 1)  # pending, unsequenced
    snap = a.snapshot()
    # acked: both sequenced points, no pending one
    assert snap["strokes"][sid]["points"] == [
        {"x": 0, "y": 0}, {"x": 9, "y": 9}]
    # live view still shows the optimistic point at the end
    assert a.get_stroke(sid)["points"][-1] == {"x": 1, "y": 1}
    t.note(snap, a.get_stroke(sid))


def test_ink_snapshot_is_acked_state_only():
    twin(_ink_snapshot_is_acked_state_only)


# ---------------------------------------------------------------- matrix

def _matrix_shape_and_cells(t):
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_rows(0, 2)
    a.insert_cols(0, 3)
    a.set_cell(0, 0, "tl")
    a.set_cell(1, 2, "br")
    assert (b.row_count, b.col_count) == (2, 3)
    assert b.get_cell(0, 0) == "tl" and b.get_cell(1, 2) == "br"
    assert a.to_lists() == b.to_lists()
    t.note(a.to_lists())


def test_matrix_shape_and_cells():
    twin(_matrix_shape_and_cells)


def _matrix_concurrent_row_insert_keeps_cells_aligned(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_rows(0, 2)
    a.insert_cols(0, 2)
    a.set_cell(1, 1, "anchor")
    server._auto_drain = False
    # b inserts a row ABOVE the anchor while a writes to it by position
    b.insert_rows(0, 1)
    a.set_cell(1, 1, "updated")
    server.drain()
    # the anchor row slid to index 2; the positional write still hit it
    assert a.to_lists() == b.to_lists()
    assert a.get_cell(2, 1) == "updated"
    assert (a.row_count, a.col_count) == (3, 2)
    t.note(a.to_lists())


def test_matrix_concurrent_row_insert_keeps_cells_aligned():
    twin(_matrix_concurrent_row_insert_keeps_cells_aligned)


def _matrix_concurrent_cell_write_lww(t):
    server = t.server
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_rows(0, 1)
    a.insert_cols(0, 1)
    server._auto_drain = False
    a.set_cell(0, 0, "from-a")
    b.set_cell(0, 0, "from-b")
    t.note(a.get_cell(0, 0), b.get_cell(0, 0))
    server.drain()
    assert a.get_cell(0, 0) == b.get_cell(0, 0) == "from-b"


def test_matrix_concurrent_cell_write_lww():
    twin(_matrix_concurrent_cell_write_lww)


def _matrix_remove_rows(t):
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_rows(0, 3)
    a.insert_cols(0, 1)
    for r in range(3):
        a.set_cell(r, 0, f"r{r}")
    a.remove_rows(1, 1)
    assert b.row_count == 2
    assert [b.get_cell(r, 0) for r in range(2)] == ["r0", "r2"]
    assert a.to_lists() == b.to_lists()


def test_matrix_remove_rows():
    twin(_matrix_remove_rows)


def _matrix_offline_edits_rebase(t):
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_rows(0, 1)
    a.insert_cols(0, 1)
    a.set_cell(0, 0, "base")
    c1.disconnect()
    a.insert_rows(1, 1)
    a.set_cell(1, 0, "offline")
    b.insert_rows(0, 1)  # lands before reconnect
    t.note(a.to_lists(), b.to_lists())
    c1.reconnect()
    assert a.to_lists() == b.to_lists()
    assert a.get_cell(2, 0) == "offline"  # slid down by b's insert


def test_matrix_offline_edits_rebase():
    twin(_matrix_offline_edits_rebase)


def _matrix_snapshot_boot(t):
    summary_manager = t.mod("runtime.summarizer").SummaryManager
    c1 = t.loader.resolve("t", "doc")
    sm = summary_manager(c1, max_ops=10_000)
    m = c1.runtime.create_data_store("default").create_channel(
        "m", "shared-matrix")
    m.insert_rows(0, 2)
    m.insert_cols(0, 2)
    m.set_cell(0, 1, 42)
    sm.summarize_now()
    c3 = t.loader.resolve("t", "doc")
    m3 = c3.runtime.get_data_store("default").get_channel("m")
    assert m3.get_cell(0, 1) == 42
    m3.set_cell(1, 1, "post-boot")
    assert m.get_cell(1, 1) == "post-boot"
    t.note(c3._base_snapshot is not None)


def test_matrix_snapshot_boot():
    twin(_matrix_snapshot_boot)


def _matrix_removed_rows_purge_cell_storage(t):
    c1, c2, a, b = pair(t, "shared-matrix")
    a.insert_cols(0, 1)
    for round_ in range(5):
        a.insert_rows(0, 2)
        a.set_cell(0, 0, f"v{round_}")
        a.set_cell(1, 0, f"w{round_}")
        a.remove_rows(0, 2)
    assert a.row_count == b.row_count == 0
    # the sparse store must not accumulate dead cells on either replica
    assert len(a._cells) == 0
    assert len(b._cells) == 0
    assert a.snapshot()["cells"] == []


def test_matrix_removed_rows_purge_cell_storage():
    twin(_matrix_removed_rows_purge_cell_storage)


# -------------------------------------------------------- summary block

def _summary_block_travels_via_snapshot_only(t):
    summary_manager = t.mod("runtime.summarizer").SummaryManager
    c1 = t.loader.resolve("t", "doc")
    sm = summary_manager(c1, max_ops=10_000)
    sb = c1.runtime.create_data_store("default").create_channel(
        "sb", "shared-summary-block")
    sb.set("stats", {"count": 7})
    sm.summarize_now()
    c2 = t.loader.resolve("t", "doc")
    sb2 = c2.runtime.get_data_store("default").get_channel("sb")
    assert sb2.get("stats") == {"count": 7}


def test_summary_block_travels_via_snapshot_only():
    twin(_summary_block_travels_via_snapshot_only)


def _queue_multi_release_preserves_fifo(t):
    c1, c2, a, b = pair(t, "consensus-queue")
    for v in ["w1", "w2", "w3"]:
        a.add(v)
    a.acquire()
    a.acquire()
    held = [iid for iid, _ in a.holding()]
    assert [v for _, v in a.holding()] == ["w1", "w2"]
    t.note(held)
    for iid in held:
        a.release(iid)
    # w3 was never acquired; released w1, w2 queue BEHIND it, in order
    assert a.peek_values() == b.peek_values() == ["w3", "w1", "w2"]


def test_queue_multi_release_preserves_fifo():
    """Released items re-add at the back in release order."""
    twin(_queue_multi_release_preserves_fifo)


def _queue_holder_leave_requeues_at_back(t):
    c1, c2, a, b = pair(t, "consensus-queue")
    for v in ["w1", "w2"]:
        a.add(v)
    b.acquire()
    assert [v for _, v in b.holding()] == ["w1"]
    c2.disconnect()  # holder leaves → its items requeue deterministically
    assert a.peek_values() == ["w2", "w1"]


def test_queue_holder_leave_requeues_at_back():
    twin(_queue_holder_leave_requeues_at_back)


def _matrix_1kx1k_eight_clients_concurrent(t):
    server = t.server
    rng = random.Random(33)
    c0 = t.loader.resolve("t", "grid")
    m0 = c0.runtime.create_data_store("default").create_channel(
        "grid", "shared-matrix")
    m0.insert_rows(0, 1000)
    m0.insert_cols(0, 1000)
    clients = [c0] + [t.loader.resolve("t", "grid") for _ in range(7)]
    mats = [c.runtime.get_data_store("default").get_channel("grid")
            for c in clients]

    server._auto_drain = False  # force real concurrency
    server.drain()
    for round_ in range(5):
        for i, m in enumerate(mats):
            for _ in range(5):
                r, c = rng.randrange(m.row_count), rng.randrange(m.col_count)
                m.set_cell(r, c, f"c{i}r{round_}")
        if round_ == 2:
            mats[3].insert_rows(500, 2)  # concurrent shape change
        server.drain()
    server._auto_drain = True
    server.drain()

    assert mats[0].row_count == 1002 and mats[0].col_count == 1000
    if t.pkg == "jax":
        # the JAX side's to_lists checks are tests/test_dds_catalog.py's;
        # here it gives the record (every replica's shape and visible
        # cells, and its snapshot) that the port's must equal
        return
    ref = mats[0].to_lists()
    for m in mats[1:]:
        assert m.row_count == 1002 and m.col_count == 1000
        assert m.to_lists() == ref
    # some edits really landed
    assert sum(1 for row in ref for v in row if v is not None) >= 100


def test_matrix_1kx1k_eight_clients_concurrent():
    """BASELINE config 3: a 1000x1000 SharedMatrix with 8 clients making
    concurrent cell edits (and concurrent shape edits) converges, to the
    same cells as the JAX package's."""
    twin(_matrix_1kx1k_eight_clients_concurrent)


def test_create_channel_knows_every_jax_channel_type():
    """The port's registry holds the JAX registry's channel types, and
    each makes an instance of the class of the same name."""
    from fluidframework_tpu.dds import registry as jax_registry
    from fluidframework_tpu_torch.dds import create_channel
    from fluidframework_tpu_torch.dds import registry as port_registry

    assert sorted(port_registry._REGISTRY) == sorted(jax_registry._REGISTRY)
    assert len(port_registry._REGISTRY) == 12
    for kind, cls in jax_registry._REGISTRY.items():
        ch = create_channel(kind, "x")
        assert type(ch).__name__ == cls.__name__
        assert type(ch).__module__.startswith("fluidframework_tpu_torch.")
    with pytest.raises(KeyError):
        create_channel("no-such-type", "x")
