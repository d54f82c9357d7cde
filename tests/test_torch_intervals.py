"""The port's interval collections against ``tests/test_intervals.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's client stack over that package's ``LocalServer``
(``torch_stack_fixtures.both``: a fixed client-id epoch and a clock at
0, so interval ids agree) with the JAX test's assertions, and after each
step every replica's collection (``snapshot()``: id, endpoints, props)
and text are noted and equal between the packages. Tolerance: exact.
"""

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both


def string_pair(loader):
    c1 = loader.resolve("t", "doc")
    c2 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "0123456789")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    return c1, c2, s1, s2


def _shown(s, *pairs):
    """Note each (string, collection)'s text and endpoints."""
    s.note([[st.get_text(), ic.snapshot()] for st, ic in pairs])


def _replicates_and_slides(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    ivals1 = s1.get_interval_collection("highlights")
    ival = ivals1.add(2, 5, {"color": "yellow"})
    ivals2 = s2.get_interval_collection("highlights")
    assert len(ivals2) == 1
    remote = ivals2.get(ival.id)
    assert ivals2.position(remote) == (2, 5)
    assert remote.properties == {"color": "yellow"}
    _shown(s, (s1, ivals1), (s2, ivals2))
    s2.insert_text(0, "ab")
    assert ivals1.position(ival) == (4, 7)
    assert ivals2.position(remote) == (4, 7)
    _shown(s, (s1, ivals1), (s2, ivals2))
    s1.remove_text(3, 6)
    assert ivals1.position(ival) == ivals2.position(remote)
    _shown(s, (s1, ivals1), (s2, ivals2))


def test_interval_replicates_and_slides():
    both(_replicates_and_slides)


def _delete_and_change(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    ivals1 = s1.get_interval_collection("x")
    a = ivals1.add(1, 3)
    b = ivals1.add(5, 8)
    ivals2 = s2.get_interval_collection("x")
    assert len(ivals2) == 2
    _shown(s, (s1, ivals1), (s2, ivals2))
    ivals2.delete(a.id)
    assert len(ivals1) == 1 and ivals1.get(a.id) is None
    _shown(s, (s1, ivals1), (s2, ivals2))
    ivals1.change(b.id, start=0, end=9, props={"tag": "wide"})
    rb = ivals2.get(b.id)
    assert ivals2.position(rb) == (0, 9)
    assert rb.properties == {"tag": "wide"}
    _shown(s, (s1, ivals1), (s2, ivals2))


def test_interval_delete_and_change():
    both(_delete_and_change)


def _concurrent_change_local_wins(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    i1 = s1.get_interval_collection("x")
    ival = i1.add(2, 4)
    i2 = s2.get_interval_collection("x")
    s.server._auto_drain = False
    i1.change(ival.id, start=0)
    i2.change(ival.id, start=6)
    _shown(s, (s1, i1), (s2, i2))
    s.server.drain()
    assert i1.position(i1.get(ival.id)) == i2.position(i2.get(ival.id))
    assert i1.position(i1.get(ival.id))[0] == 6
    _shown(s, (s1, i1), (s2, i2))


def test_interval_concurrent_change_local_wins():
    both(_concurrent_change_local_wins)


def _anchors_at_author_perspective(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    i1 = s1.get_interval_collection("x")
    i2 = s2.get_interval_collection("x")
    s.server._auto_drain = False
    s1.insert_text(0, "XYZ")
    i2.add(4, 6)
    _shown(s, (s1, i1), (s2, i2))
    s.server.drain()
    ival1 = next(iter(i1))
    ival2 = next(iter(i2))
    assert i1.position(ival1) == i2.position(ival2) == (7, 9)
    _shown(s, (s1, i1), (s2, i2))


def test_interval_anchors_at_author_perspective():
    both(_anchors_at_author_perspective)


def _overlapping_query(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    ic = s1.get_interval_collection("x")
    a = ic.add(0, 2)
    b = ic.add(5, 8)
    hits = ic.find_overlapping(1, 4)
    assert [i.id for i in hits] == [a.id]
    s.note([i.id for i in hits])
    hits = ic.find_overlapping(0, 9)
    assert {i.id for i in hits} == {a.id, b.id}
    s.note([i.id for i in hits])


def test_interval_overlapping_query():
    both(_overlapping_query)


def _reconnect_rebases(s):
    c1, c2, s1, s2 = string_pair(s.loader)
    i1 = s1.get_interval_collection("x")
    i2 = s2.get_interval_collection("x")
    c1.disconnect()
    ival = i1.add(3, 5)
    s2.insert_text(0, "PRE-")
    _shown(s, (s1, i1), (s2, i2))
    c1.reconnect()
    assert len(i2) == 1
    r = i2.get(ival.id)
    assert i2.position(r) == i1.position(ival) == (7, 9)
    _shown(s, (s1, i1), (s2, i2))


def test_interval_reconnect_resubmits_with_rebased_positions():
    both(_reconnect_rebases)


def _survive_summary_boot(s):
    summary_manager = s.mod("runtime.summarizer").SummaryManager
    c1, c2, s1, s2 = string_pair(s.loader)
    sm = summary_manager(c1, max_ops=10_000)
    ic = s1.get_interval_collection("marks")
    ival = ic.add(2, 6, {"kind": "comment"})
    sm.summarize_now()
    c3 = s.loader.resolve("t", "doc")
    s3 = c3.runtime.get_data_store("default").get_channel("text")
    i3 = s3.get_interval_collection("marks")
    assert len(i3) == 1
    r = i3.get(ival.id)
    assert i3.position(r) == (2, 6)
    assert r.properties == {"kind": "comment"}
    _shown(s, (s1, ic), (s3, i3))
    s3.insert_text(0, "zz")
    assert i3.position(r) == (4, 8)
    _shown(s, (s1, ic), (s3, i3))


def test_intervals_survive_summary_boot():
    both(_survive_summary_boot)
