"""The port's client stack against the service lambdas in one process
(``loader/``, ``driver/`` local, ``service/``), twin of
``tests/test_e2e.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's loader, runtime and DDSes over that package's
``LocalServer`` (``torch_stack_fixtures.both``: a fixed client-id epoch
and a clock at 0, so the streams are fixed by the script), with the JAX
test's assertions. Between the packages, the values each replica shows on
the way and everything the server stored at the end
(``torch_stack_fixtures.stored``: the sequenced streams, summaries and
every db collection) are equal exactly. Tolerance: exact.
"""

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored


def boot_two(s, doc="doc"):
    return s.loader.resolve("t", doc), s.loader.resolve("t", doc)


def _end(s, *values):
    s.note([list(values), stored(s.server)])


def _string_converge(s):
    c1, c2 = boot_two(s)
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "hello world")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == "hello world"
    s2.insert_text(5, ", brave")
    s1.remove_text(0, 5)
    s1.insert_text(0, "HELLO")
    assert s1.get_text() == s2.get_text() == "HELLO, brave world"
    _end(s, s1.get_text())


def test_shared_string_two_clients_converge():
    both(_string_converge)


def _concurrent_inserts(s):
    server = s.server
    server._auto_drain = False
    c1, c2 = boot_two(s)
    server.drain()
    ds1 = c1.runtime.create_data_store("default")
    server.drain()
    s1 = ds1.create_channel("text", "shared-string")
    server.drain()
    s1.insert_text(0, "base")
    server.drain()
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s1.insert_text(0, "AA")
    s2.insert_text(0, "BB")
    server.drain()
    assert s1.get_text() == s2.get_text()
    assert sorted([s1.get_text().count("AA"),
                   s1.get_text().count("BB")]) == [1, 1]
    _end(s, s1.get_text())


def test_shared_string_concurrent_inserts_deterministic():
    both(_concurrent_inserts)


def _map_pending_local_wins(s):
    c1, c2 = boot_two(s)
    m1 = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    m2 = c2.runtime.get_data_store("default").get_channel("kv")
    m1.set("a", 1)
    assert m2.get("a") == 1
    s.server._auto_drain = False
    m1.set("x", "from-1")
    m2.set("x", "from-2")
    s.server.drain()
    assert m1.get("x") == m2.get("x") == "from-2"
    _end(s, m1.get("x"))


def test_shared_map_converges_and_pending_local_wins():
    both(_map_pending_local_wins)


def _map_remote_clear(s):
    c1, c2 = boot_two(s)
    m1 = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    m2 = c2.runtime.get_data_store("default").get_channel("kv")
    m1.set("a", 1)
    s.server._auto_drain = False
    m2.clear()
    m1.set("b", 2)
    s.server.drain()
    assert m1.get("a") is None and m2.get("a") is None
    assert m1.get("b") == m2.get("b") == 2
    _end(s, m1.get("b"))


def test_shared_map_remote_clear_preserves_pending():
    both(_map_remote_clear)


def _late_joiner(s):
    c1 = s.loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "written before client 2 existed")
    c2 = s.loader.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == "written before client 2 existed"
    assert c2.existing
    _end(s, s2.get_text(), c2.existing)


def test_late_joiner_catches_up_from_op_history():
    both(_late_joiner)


def _reconnect_string(s):
    c1, c2 = boot_two(s)
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "shared ")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    c1.disconnect()
    s1.insert_text(len(s1.get_text()), "offline-edit")
    s2.insert_text(0, "remote ")
    assert "offline-edit" not in s2.get_text()
    c1.reconnect()
    assert s1.get_text() == s2.get_text() == "remote shared offline-edit"
    _end(s, s1.get_text())


def test_reconnect_resubmits_pending_string_ops():
    both(_reconnect_string)


def _reconnect_map(s):
    c1, c2 = boot_two(s)
    m1 = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    m2 = c2.runtime.get_data_store("default").get_channel("kv")
    c1.disconnect()
    m1.set("offline", True)
    m2.set("online", True)
    c1.reconnect()
    for m in (m1, m2):
        assert m.get("offline") is True and m.get("online") is True
    _end(s, sorted(m1.keys()))


def test_reconnect_resubmits_pending_map_ops():
    both(_reconnect_map)


def _in_flight_not_duplicated(s):
    server = s.server
    server._auto_drain = False
    c1, c2 = boot_two(s)
    server.drain()
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    server.drain()
    s1.insert_text(0, "x")
    c1.disconnect()
    server.drain()
    c1.reconnect()
    server.drain()
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s1.get_text() == s2.get_text() == "x"
    _end(s, s1.get_text())


def test_ops_in_flight_at_disconnect_are_not_duplicated():
    both(_in_flight_not_duplicated)


def _offline_channel(s):
    c1, c2 = boot_two(s)
    ds1 = c1.runtime.create_data_store("default")
    c1.disconnect()
    kv = ds1.create_channel("kv2", "shared-map")
    kv.set("a", 1)
    c1.reconnect()
    m2 = c2.runtime.get_data_store("default").get_channel("kv2")
    assert m2.get("a") == 1
    _end(s, m2.get("a"))


def test_channel_created_offline_attaches_on_reconnect():
    both(_offline_channel)


def _reconnect_before_sequenced(s):
    server = s.server
    server._auto_drain = False
    c1, c2 = boot_two(s)
    server.drain()
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    server.drain()
    s1.insert_text(0, "x")
    c1.disconnect()
    c1.reconnect()
    server.drain()
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s1.get_text() == s2.get_text() == "x"
    assert c1.runtime.pending.count == 0
    _end(s, s1.get_text())


def test_reconnect_before_inflight_op_is_sequenced():
    both(_reconnect_before_sequenced)


def _quorum_membership(s):
    c1, c2 = boot_two(s)
    assert set(c1.audience) == {c1.client_id, c2.client_id}
    before = sorted(c1.audience)
    c2.close()
    assert set(c1.audience) == {c1.client_id}
    _end(s, before, sorted(c1.audience))


def test_quorum_membership_tracks_joins_and_leaves():
    both(_quorum_membership)


def _proposal_commits(s):
    c1, c2 = boot_two(s)
    c1.propose("code", "pkg@1.0")
    c1.runtime.create_data_store("a")
    c2.runtime.create_data_store("b")
    c1.runtime.create_data_store("c")
    c2.runtime.create_data_store("d")
    assert c1.quorum.get("code") == "pkg@1.0"
    assert c2.quorum.get("code") == "pkg@1.0"
    _end(s, c1.quorum.get("code"))


def test_quorum_proposal_commits_via_msn():
    both(_proposal_commits)


def _snapshot_plus_tail(s):
    c1 = s.loader.resolve("t", "doc")
    sm = s.st.SummaryManager(c1, max_ops=10_000)
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "summarized")
    sm.summarize_now()
    s1.insert_text(0, "tail ")
    c3 = s.loader.resolve("t", "doc")
    s3 = c3.runtime.get_data_store("default").get_channel("text")
    assert s3.get_text() == "tail summarized"
    assert c3.existing
    s3.insert_text(0, "c3 ")
    s1.insert_text(len(s1.get_text()), " end")
    assert s1.get_text() == s3.get_text() == "c3 tail summarized end"
    _end(s, s3.get_text())


def test_boot_from_snapshot_plus_tail():
    both(_snapshot_plus_tail)


def _signals(s):
    c1, c2 = boot_two(s)
    got = []
    c2.on_signal = lambda sig: got.append((sig.client_id, sig.content))
    c1.submit_signal({"presence": "typing"})
    assert got == [(c1.client_id, {"presence": "typing"})]
    _end(s, got)


def test_signals_between_containers():
    both(_signals)
