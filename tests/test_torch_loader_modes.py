"""The port's loader modes (detached create and attach, readonly, read
scope; ``loader/``, ``service/tenants.py``) against
``tests/test_loader_modes.py``.

Each test is the twin of the JAX test of the same name: its scenario runs
on each package's client stack and ``LocalServer``
(``torch_stack_fixtures.both``: a fixed client-id epoch and a clock at
0), with the JAX test's assertions. Between the packages, what each
replica shows on the way, the refusals' texts, the nacks and everything
the server stored at the end (``torch_stack_fixtures.stored``) are equal
exactly. Tolerance: exact.
"""

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, stored


def _detached_then_attach(s):
    detached = s.loader.create_detached("t", "newdoc")
    assert detached.detached and not detached.connected
    ds = detached.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    text.insert_text(0, "built offline")
    text.annotate_range(0, 5, {"bold": True})
    kv = ds.create_channel("kv", "shared-map")
    kv.set("made", "detached")
    assert s.server.get_deltas("t", "newdoc", 0, 10**9) == []
    detached.attach()
    assert detached.connected and not detached.detached
    assert detached.runtime.pending.count == 0
    c2 = s.loader.resolve("t", "newdoc")
    ds2 = c2.runtime.get_data_store("default")
    assert ds2.get_channel("text").get_text() == "built offline"
    assert ds2.get_channel("kv").get("made") == "detached"
    ds2.get_channel("text").insert_text(0, ">")
    assert text.get_text() == ">built offline"
    s.note([text.get_text(), ds2.get_channel("text").snapshot(),
            stored(s.server)])


def test_detached_container_builds_offline_then_attaches():
    both(_detached_then_attach)


def _attach_refused(s):
    c = s.loader.resolve("t", "doc")
    with pytest.raises(RuntimeError, match="not detached") as err:
        c.attach()
    s.note(str(err.value))


def test_attach_on_non_detached_container_refused():
    both(_attach_refused)


def _force_readonly(s):
    c = s.loader.resolve("t", "doc")
    st = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "editable")
    c.force_readonly()
    assert c.readonly
    with pytest.raises(PermissionError, match="readonly") as err:
        st.insert_text(0, "nope")
    assert c.closed
    assert c.runtime.pending.count == 0
    c2 = s.loader.resolve("t", "doc")
    text = c2.runtime.get_data_store("default").get_channel(
        "text").get_text()
    assert text == "editable"
    s.note([str(err.value), text, stored(s.server)])


def test_force_readonly_blocks_local_edits():
    both(_force_readonly)


def _readonly_receives(s):
    c = s.loader.resolve("t", "doc")
    st = c.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    st.insert_text(0, "editable")
    c.force_readonly()
    c2 = s.loader.resolve("t", "doc")
    c2.runtime.get_data_store("default").get_channel("text") \
        .insert_text(0, "remote ")
    assert st.get_text() == "remote editable"
    c.force_readonly(False)
    st.insert_text(0, "again ")
    assert st.get_text() == "again remote editable"
    s.note([st.get_text(), stored(s.server)])


def test_readonly_replica_keeps_receiving_remote_ops():
    both(_readonly_receives)


def _tenant_server(s):
    tenants = s.mod("service.tenants")
    tm = tenants.TenantManager()
    tm.register("acme", "s3cret")
    return s.st.server(tenants=tm), tenants


def _read_out_of_quorum(s):
    server, tenants = _tenant_server(s)
    msgs = s.mod("protocol.messages")
    w = server.connect("acme", "doc",
                       token=tenants.sign_token("acme", "doc", "s3cret"))
    r = server.connect("acme", "doc", token=tenants.sign_token(
        "acme", "doc", "s3cret", scopes=(tenants.SCOPE_READ,)))
    assert r.mode == "read"
    deli = server._get_orderer("acme", "doc").deli
    assert r.client_id not in deli.clients
    seen = []
    r.on_ops = lambda batch: seen.extend(batch)
    for i in range(1, 6):
        w.submit([msgs.DocumentMessage(
            client_sequence_number=i, reference_sequence_number=i,
            type=msgs.MessageType.OPERATION, contents={"i": i})])
    assert deli._min_ref_seq() >= 5
    assert len([m for m in seen if m.type.value == "op"]) == 5
    r.disconnect()
    s.note([r.mode, deli._min_ref_seq(), [m.sequence_number for m in seen],
            stored(server)])


def test_read_connection_stays_out_of_quorum_and_msn():
    both(_read_out_of_quorum)


def _read_scope(s):
    server, tenants = _tenant_server(s)
    msgs = s.mod("protocol.messages")
    writer = server.connect(
        "acme", "doc", token=tenants.sign_token("acme", "doc", "s3cret"))
    reader = server.connect("acme", "doc", token=tenants.sign_token(
        "acme", "doc", "s3cret", scopes=(tenants.SCOPE_READ,)))
    seen, nacks = [], []
    reader.on_ops = lambda batch: seen.extend(batch)
    reader.on_nack = lambda n: nacks.append(n)
    writer.submit([msgs.DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=msgs.MessageType.OPERATION, contents={"x": 1})])
    assert any(m.client_id == writer.client_id for m in seen)
    reader.submit([msgs.DocumentMessage(
        client_sequence_number=1, reference_sequence_number=0,
        type=msgs.MessageType.OPERATION, contents={"x": 2})])
    assert nacks and nacks[0].type.value == "InvalidScopeError"
    assert all(m.client_id != reader.client_id or m.type.value != "op"
               for m in server.get_deltas("acme", "doc", 0, 10**9))
    s.note([[[n.code, n.type.value, n.message] for n in nacks],
            stored(server)])


def test_read_scope_connection_watches_but_cannot_write():
    both(_read_scope)


def _watch_only_heartbeats(s):
    editor = s.loader.resolve("t", "doc")
    watcher = s.loader.resolve("t", "doc")
    watcher.delta_manager.noop_frequency = 10
    st = editor.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    for _ in range(30):
        st.insert_text(0, "x")
    deli = s.server._get_orderer("t", "doc").deli
    watcher_state = deli.clients[watcher.client_id]
    assert watcher_state.reference_sequence_number > 0
    lag = deli.sequence_number - deli._min_ref_seq()
    assert lag <= 2 * watcher.delta_manager.noop_frequency
    s.note([watcher_state.reference_sequence_number, lag, stored(s.server)])


def test_watch_only_client_heartbeats_and_msn_advances():
    both(_watch_only_heartbeats)


def _no_client_marker(s):
    s.loader.resolve("t", "doc")
    seen = []
    conn = s.server.connect("t", "watchdoc")
    conn.on_ops = lambda batch: seen.extend(batch)
    c2 = s.loader.resolve("t", "watchdoc")
    c2.close()
    conn.disconnect()
    types = [m.type.value for m in seen]
    assert "noClient" not in types
    log = s.server.get_deltas("t", "watchdoc", 0, 10**9)
    assert [m.type.value for m in log][-1] == "noClient"
    s.note([types, [m.type.value for m in log], stored(s.server)])


def test_no_client_marker_when_doc_goes_quiet():
    both(_no_client_marker)
