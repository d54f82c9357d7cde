"""The port's framework layer against the JAX package's: the DataObject
lifecycle, undo-redo (strings, maps, matrices), interceptions, the
number and object sequences, dependency synthesis, request routing and
the last-edited tracker.

Each test is the twin of the test of the same name in
``tests/test_framework.py`` or ``tests/test_framework_extras.py``: its
scenario runs with the JAX test's assertions on each package
(``torch_stack_fixtures.twin``), and every container's channels (value
and ``snapshot()``), with what the scenario noted on the way, agree
between the packages exactly, client ids mapped by first appearance.
"""

import pytest
from tests.torch_stack_fixtures import module, twin

# ------------------------------------------------------------ data object


def _notes_class(t):
    data_object = t.mod("framework").DataObject

    class Notes(data_object):
        def initializing_first_time(self):
            self.create_channel("text", "shared-string")
            self.root.set("title", "untitled")
            self.calls = "first"

        def initializing_from_existing(self):
            self.calls = "existing"

    return Notes


def _data_object_lifecycle(t):
    fw = t.mod("framework")
    factory = fw.DataObjectFactory("notes", _notes_class(t))
    c1 = t.loader.resolve("t", "doc")
    n1 = factory.create_or_load(c1)
    assert n1.calls == "first"
    assert n1.root.get("title") == "untitled"
    n1.get_channel("text").insert_text(0, "hello")

    c2 = t.loader.resolve("t", "doc")
    n2 = factory.create_or_load(c2)
    assert n2.calls == "existing"
    assert n2.root.get("title") == "untitled"
    assert n2.get_channel("text").get_text() == "hello"
    t.note(n1.calls, n2.calls, n1.runtime.pkg, n2.runtime.pkg)


def test_data_object_lifecycle():
    twin(_data_object_lifecycle)


# --------------------------------------------------------------- undo-redo

def undo_setup(t):
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    s1 = ds.create_channel("text", "shared-string")
    m1 = ds.create_channel("kv", "shared-map")
    mgr = t.mod("framework").UndoRedoStackManager()
    mgr.attach_string(s1)
    mgr.attach_map(m1)
    ds2 = c2.runtime.get_data_store("default")
    return mgr, s1, m1, ds2.get_channel("text"), ds2.get_channel("kv")


def _undo_redo_string(t):
    mgr, s1, m1, s2, m2 = undo_setup(t)
    s1.insert_text(0, "hello")
    mgr.close_current_operation()
    s1.insert_text(5, " world")
    mgr.close_current_operation()
    assert mgr.undo()
    assert s1.get_text() == s2.get_text() == "hello"
    assert mgr.undo()
    assert s1.get_text() == s2.get_text() == ""
    assert mgr.redo()
    assert s1.get_text() == s2.get_text() == "hello"
    assert mgr.redo()
    assert s1.get_text() == s2.get_text() == "hello world"
    t.note(mgr.can_undo, mgr.can_redo)


def test_undo_redo_string():
    twin(_undo_redo_string)


def _undo_remove_restores_text(t):
    mgr, s1, m1, s2, m2 = undo_setup(t)
    s1.insert_text(0, "abcdef")
    mgr.close_current_operation()
    s1.remove_text(2, 4)
    mgr.close_current_operation()
    assert s1.get_text() == "abef"
    mgr.undo()
    assert s1.get_text() == s2.get_text() == "abcdef"


def test_undo_remove_restores_text():
    twin(_undo_remove_restores_text)


def _undo_slides_past_remote_edits(t):
    mgr, s1, m1, s2, m2 = undo_setup(t)
    s1.insert_text(0, "base ")
    mgr.close_current_operation()
    s1.insert_text(5, "LOCAL")
    mgr.close_current_operation()
    s2.insert_text(0, "remote ")  # shifts everything right
    mgr.undo()  # must remove LOCAL, not whatever now sits at 5..10
    assert s1.get_text() == s2.get_text() == "remote base "


def test_undo_slides_past_remote_edits():
    twin(_undo_slides_past_remote_edits)


def _undo_map_and_redo_clear_on_new_edit(t):
    mgr, s1, m1, s2, m2 = undo_setup(t)
    m1.set("k", 1)
    mgr.close_current_operation()
    m1.set("k", 2)
    mgr.close_current_operation()
    mgr.undo()
    assert m1.get("k") == m2.get("k") == 1
    assert mgr.can_redo
    m1.set("k", 9)  # fresh edit invalidates the redo future
    assert not mgr.can_redo
    mgr.undo()
    assert m1.get("k") == 1
    mgr.undo()
    assert not m1.has("k") and not m2.has("k")


def test_undo_map_and_redo_clear_on_new_edit():
    twin(_undo_map_and_redo_clear_on_new_edit)


# ------------------------------------------------------------ interceptions

def _interceptions_stamp_attribution(t):
    fw = t.mod("framework")
    c1 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    s = ds.create_channel("text", "shared-string")
    m = ds.create_channel("kv", "shared-map")
    user = {"user": "alice"}
    si = fw.intercepted_string(s, lambda props: dict(props or {}, **user))
    mi = fw.intercepted_map(m, lambda k, v: {"value": v, **user})
    si.insert_text(0, "hi")
    mi.set("k", 42)
    # reads pass through to the underlying DDS
    assert si.get_text() == "hi"
    assert mi.get("k") == {"value": 42, "user": "alice"}
    seg = s.client.tree.segments[0]
    assert seg.props == {"user": "alice"}
    t.note([sg.props for sg in s.client.tree.segments])


def test_interceptions_stamp_attribution():
    twin(_interceptions_stamp_attribution)


# ---------------------------------------------------------- value sequences

def _number_and_object_sequences(t):
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    nums = ds.create_channel("nums", "shared-number-sequence")
    objs = ds.create_channel("objs", "shared-object-sequence")
    nums.insert_range(0, [1, 2, 3])
    nums.insert_range(1, [10])
    nums.remove_range(0, 1)
    objs.insert_range(0, [{"a": 1}, {"b": 2}])
    ds2 = c2.runtime.get_data_store("default")
    assert ds2.get_channel("nums").get_items() == [10, 2, 3]
    assert nums.get_items() == [10, 2, 3]
    assert nums.get_item(1) == 2
    assert ds2.get_channel("objs").get_items() == [{"a": 1}, {"b": 2}]
    t.note(nums.item_count(), objs.item_count())


def test_number_and_object_sequences():
    twin(_number_and_object_sequences)


def _matrix_undo_redo(t):
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    m = c1.runtime.create_data_store("default").create_channel(
        "grid", "shared-matrix")
    m.insert_rows(0, 2)
    m.insert_cols(0, 2)
    m.set_cell(0, 0, "keep")

    mgr = t.mod("framework.undo_redo").UndoRedoStackManager()
    mgr.attach_matrix(m)

    m.set_cell(0, 0, "edited")
    mgr.close_current_operation()
    m.insert_rows(2, 1)
    m.set_cell(2, 1, "new-row-cell")
    mgr.close_current_operation()

    m2 = c2.runtime.get_data_store("default").get_channel("grid")
    assert m2.row_count == 3 and m2.get_cell(2, 1) == "new-row-cell"

    assert mgr.undo()  # retract the row insert (incl. its cell edit)
    assert m.row_count == 2 and m2.row_count == 2
    t.note(m.to_lists(), m2.to_lists())
    assert mgr.undo()  # revert the cell edit
    assert m.get_cell(0, 0) == "keep" and m2.get_cell(0, 0) == "keep"
    assert mgr.redo()
    assert m.get_cell(0, 0) == "edited" and m2.get_cell(0, 0) == "edited"


def test_matrix_undo_redo():
    """Matrix undo: cell LWW reverts and inserted rows/cols retract
    (removals are not undoable)."""
    twin(_matrix_undo_redo)


# ------------------------------------------------------ framework extras

def _dependency_container(pkg: str) -> list:
    """The JAX test's steps on one package; returns what it observed."""
    dependency_container = module(pkg, "framework.synthesize") \
        .DependencyContainer
    host = dependency_container()
    host.register("logger", "host-logger")
    built = []
    host.register_factory("expensive", lambda: built.append(1) or "svc")
    child = dependency_container(parent=host)
    child.register("config", {"x": 1})

    deps = child.synthesize(required=("logger", "config"),
                            optional=("missing", "expensive"))
    assert deps["logger"] == "host-logger"
    assert deps["config"] == {"x": 1}
    assert deps["missing"] is None
    assert deps["expensive"] == "svc"
    child.resolve("expensive")
    assert built == [1]  # factory ran once (cached)
    with pytest.raises(KeyError) as err:
        child.synthesize(required=("nope",))
    return [deps, built, str(err.value)]


def test_dependency_container_required_optional_and_scopes():
    assert _dependency_container("torch") == _dependency_container("jax")


def _request_router_walks_the_object_graph(t):
    router_cls = t.mod("framework.request_handler").RequestRouter
    c = t.loader.resolve("t", "doc")
    ds = c.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    router = router_cls(c)
    assert router.request("/") is c.runtime
    assert router.request("/default") is ds
    assert router.request("/default/text") is text
    with pytest.raises(KeyError) as err:
        router.request("/nope/where")
    # custom handlers compose in front
    router.add_handler(
        lambda parts, cont: "CUSTOM" if parts[:1] == ["_debug"] else None)
    assert router.request("/_debug/state") == "CUSTOM"
    assert router.request("/default/text") is text  # default still works
    t.note(str(err.value))


def test_request_router_walks_the_object_graph():
    twin(_request_router_walks_the_object_graph)


def _last_edited_converges_and_names_the_editor(t):
    tracker = t.mod("framework.last_edited").LastEditedTracker
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    t1 = tracker(c1)
    t2 = tracker(c2)

    s2 = c2.runtime.get_data_store("default").get_channel("text")
    s2.insert_text(0, "bob was here")
    assert t1.last_edited is not None
    assert t1.last_edited["clientId"] == c2.client_id
    assert t1.last_edited == t2.last_edited  # convergent record
    t.note(t1.last_edited)

    text.insert_text(0, "alice later: ")
    assert t2.last_edited["clientId"] == c1.client_id
    t.note(t1.last_edited, t2.last_edited)


def test_last_edited_converges_and_names_the_editor():
    twin(_last_edited_converges_and_names_the_editor)
