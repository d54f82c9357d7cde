"""The port's storage tier against the JAX package's: the native chunk
store (``csrc/chunkstore.cpp``), ``GitStore``, the storage process
(``storage_server.StorageService`` / ``StorageServer``) and its client
(``storage_client.RemoteStorage``).

Twins of ``tests/test_native.py``'s chunk-store tests and of
``tests/test_storage_server.py``'s flows, with the storage server run in
process on a daemon thread; the two packages' chunk stores read each
other's directories; the same RPC frames into a JAX and a port
``StorageService`` give identical replies (content-addressed ids, commit
ids, refs, histories, trees; stats but the read cache's hit counts);
the golden round-3 session boots in the port to ``expected.json``. The
placement table door (``--table-dir``) arms on the storage socket.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import sys
import threading
import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.driver import (
    LocalDocumentServiceFactory,
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.native import NativeChunkStore
from fluidframework_tpu_torch.runtime.summarizer import SummaryManager
from fluidframework_tpu_torch.service import NetworkFrontEnd
from fluidframework_tpu_torch.service.blob_store import NativeBlobStore
from fluidframework_tpu_torch.service.durable_log import DurableLog
from fluidframework_tpu_torch.service.git_store import GitStore, head_ref
from fluidframework_tpu_torch.service.local_server import LocalServer
from fluidframework_tpu_torch.service.storage_client import (
    RemoteStorage,
    StorageConnection,
)
from fluidframework_tpu_torch.service.storage_server import (
    StorageServer,
    StorageService,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def wait_for(pred, timeout=20.0, interval=0.01):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(interval)
    return False


@contextlib.contextmanager
def storage_server(directory):
    """The port's storage server in this process on a daemon thread;
    yields it once it listens, stops it (closing its stores) after."""
    server = StorageServer(str(directory))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    assert wait_for(lambda: server.port != 0)
    try:
        yield server
    finally:
        server.stop()
        thread.join(timeout=10)
        assert not thread.is_alive()


@contextlib.contextmanager
def remote(port, tenant="t", doc="doc"):
    conn = StorageConnection("127.0.0.1", port)
    try:
        yield RemoteStorage(conn, tenant, doc)
    finally:
        conn.close()


# ------------------------------------------------------ the chunk store


def test_chunkstore_put_get_dedup(tmp_path):
    store = NativeChunkStore(str(tmp_path / "cas"))
    data = b"the quick brown fox"
    h = store.put(data)
    assert h == hashlib.sha256(data).hexdigest()  # interoperable addressing
    assert store.get(h) == data
    assert store.has(h)
    assert store.put(data) == h  # dedup: same address
    assert not store.has("0" * 64)
    with pytest.raises(KeyError):
        store.get("0" * 64)
    big = bytes(range(256)) * 1000
    hb = store.put(big)
    assert store.get(hb) == big
    store.close()


def test_chunkstore_rejects_traversal_hashes(tmp_path):
    store = NativeChunkStore(str(tmp_path / "cas"))
    with pytest.raises(KeyError):
        store.get("../" * 21 + "x")
    assert not store.has("../../etc/passwd")
    store.close()


BLOBS = [b"", b"a", b"the quick brown fox", bytes(range(256)) * 300]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chunkstores_read_each_others_directories(tmp_path, writer):
    """Same ids, same files: a directory either package wrote reads back
    in the other, and a put of the same bytes there is a dedup hit."""
    from fluidframework_tpu.native import NativeChunkStore as JaxStore

    make = {"jax": JaxStore, "torch": NativeChunkStore}
    reader = "torch" if writer == "jax" else "jax"
    w = make[writer](str(tmp_path / "cas"))
    ids = [w.put(b) for b in BLOBS]
    w.close()
    files = sorted(p.relative_to(tmp_path).as_posix()
                   for p in (tmp_path / "cas").rglob("*") if p.is_file())
    r = make[reader](str(tmp_path / "cas"))
    assert [r.get(h) for h in ids] == BLOBS
    assert [r.put(b) for b in BLOBS] == ids
    r.close()
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in (tmp_path / "cas").rglob("*")
                  if p.is_file()) == files
    assert files == sorted(f"cas/{h[:2]}/{h[2:]}" for h in set(ids))


def test_native_blob_store_counts_and_deletes(tmp_path):
    """``NativeBlobStore``: the JAX package's counters, and ``delete``
    (the history plane's chunk GC) unlinks from the fan-out layout."""
    from fluidframework_tpu.service.blob_store import (
        NativeBlobStore as JaxBlobStore,
    )

    stores = [NativeBlobStore(str(tmp_path / "p")),
              JaxBlobStore(str(tmp_path / "j"))]
    for s in stores:
        ids = [s.put(b) for b in (b"x", b"y", b"x")]
        assert s.has(ids[0]) and s.get(ids[1]) == b"y"
        assert s.delete(ids[0]) and not s.delete(ids[0])
        assert not s.has(ids[0])
    assert stores[0].stats.as_dict() == stores[1].stats.as_dict() == {
        "puts": 3, "new_blobs": 2, "deduped": 1}
    for s in stores:
        s.close()


# ------------------------------------------------- GitStore, StorageService


def _gitstores(tmp_path):
    from fluidframework_tpu.native import NativeOpLog as JaxOpLog
    from fluidframework_tpu.service.blob_store import (
        NativeBlobStore as JaxBlobStore,
    )
    from fluidframework_tpu.service.git_store import GitStore as JaxGitStore

    from fluidframework_tpu_torch.native import NativeOpLog

    return {
        "jax": (JaxGitStore, JaxBlobStore, JaxOpLog),
        "torch": (GitStore, NativeBlobStore, NativeOpLog)}


def test_git_store_equals_jax(tmp_path):
    """The same commits and ref moves in both packages' ``GitStore``:
    equal commit ids, refs and history walks, and a reopen replays the
    reflog to the same refs."""
    out = {}
    for pkg, (Git, Blobs, OpLog) in _gitstores(tmp_path).items():
        d = tmp_path / pkg
        d.mkdir()
        blobs, refs = Blobs(str(d / "cas")), OpLog(str(d / "refs"))
        git = Git(blobs, refs_log=refs)
        t1 = blobs.put(b'{"t": "tree", "k": 1}')
        c1 = git.write_commit(t1, [], meta={"n": 0})
        c2 = git.write_commit(blobs.put(b"t2"), [c1], meta={"n": 1})
        c3 = git.write_commit(blobs.put(b"t3"), [c2, c1])
        git.set_ref(head_ref("t", "a"), c2)
        git.set_ref(head_ref("t", "b"), c1)
        git.set_ref(head_ref("t", "a"), c3)
        with pytest.raises(KeyError):
            git.read_commit(t1)
        run = {"ids": [c1, c2, c3], "refs": git.refs(),
               "history": git.history(head_ref("t", "a")),
               "limited": git.history(c3, limit=2)}
        refs.close()
        reopened = Git(blobs, refs_log=OpLog(str(d / "refs")))
        run["reopened"] = reopened.refs()
        out[pkg] = run
    assert out["torch"] == out["jax"]
    assert out["torch"]["reopened"] == out["torch"]["refs"]
    c1, c2, c3 = out["torch"]["ids"]
    first = min(c1, c2)  # parents are stored sorted; the walk takes [0]
    walk = [c3, first] + ([c1] if first == c2 else [])
    assert [c["id"] for c in out["torch"]["history"]] == walk


def _wire_tree(files: dict) -> dict:
    def node(v):
        if isinstance(v, dict):
            return {"__summary__": "tree",
                    "tree": {k: node(x) for k, x in v.items()}}
        if isinstance(v, tuple):  # ("handle", path)
            return {"__summary__": "handle", "handle": v[1]}
        return {"__summary__": "blob", "hex": json.dumps(v).encode().hex()}
    return node(files)


def _frames() -> list:
    """An RPC script: blob writes and reads, legacy and tree summaries
    chained by parent (one reusing a subtree by handle), ref moves,
    listings, trees, a dangling ref, an unknown RPC and the stats."""
    return [
        {"t": "write_blob", "hex": b"blob one".hex()},
        {"t": "read_blob", "id": hashlib.sha256(b"blob one").hexdigest()},
        {"t": "get_ref", "tenant": "t", "doc": "d"},
        {"t": "get_versions", "tenant": "t", "doc": "d"},
        {"t": "get_tree", "tenant": "t", "doc": "d"},
        {"t": "upload_summary", "tenant": "t", "doc": "d",
         "summary": {"root": {"a": 1}}, "parent": None},
        {"t": "commit_ref", "tenant": "t", "doc": "d", "id": "$0"},
        {"t": "upload_summary", "tenant": "t", "doc": "d",
         "summary": _wire_tree({".attributes": "attrs",
                                "default": {"text": "hello", "meta": "m"}}),
         "parent": "$0"},
        {"t": "commit_ref", "tenant": "t", "doc": "d", "id": "$1"},
        {"t": "upload_summary", "tenant": "t", "doc": "d",
         "summary": _wire_tree({".attributes": "attrs2",
                                "default": ("handle", "default")}),
         "parent": "$1"},
        {"t": "get_ref", "tenant": "t", "doc": "d"},
        {"t": "commit_ref", "tenant": "t", "doc": "d", "id": "$2"},
        {"t": "get_versions", "tenant": "t", "doc": "d", "count": 5},
        {"t": "history", "tenant": "t", "doc": "d"},
        {"t": "history", "tenant": "t", "doc": "d", "count": 2},
        {"t": "get_tree", "tenant": "t", "doc": "d"},
        {"t": "get_tree", "tenant": "t", "doc": "d",
         "version": "$versions1"},
        {"t": "get_ref", "tenant": "t", "doc": "other"},
        {"t": "commit_ref", "tenant": "t", "doc": "d", "id": "0" * 64},
        {"t": "nope"},
        {"t": "stats"},
    ]


def _drive(service) -> list:
    """Replies to ``_frames()``; ``$k`` names the k-th upload's id,
    ``$versions1`` the second entry of the newest version listing;
    errors become their type and message."""
    uploads, versions, replies = [], [], []
    for frame in _frames():
        frame = dict(frame)
        for key in ("id", "parent"):
            v = frame.get(key)
            if isinstance(v, str) and v.startswith("$"):
                frame[key] = uploads[int(v[1:])]
        if frame.get("version") == "$versions1":
            frame["version"] = versions[1]
        try:
            reply = service.handle(frame)
        except Exception as e:  # noqa: BLE001 — the reply under test
            reply = {"error": type(e).__name__, "message": str(e)}
        if reply.get("t") == "version_id":
            uploads.append(reply["id"])
        if reply.get("t") == "versions":
            versions = reply["versions"]
        replies.append(reply)
    return replies


def test_storage_service_replies_equal_jax(tmp_path):
    from fluidframework_tpu.service.storage_server import (
        StorageService as JaxService,
    )

    services = {"jax": JaxService(str(tmp_path / "jax")),
                "torch": StorageService(str(tmp_path / "torch"))}
    replies = {pkg: _drive(s) for pkg, s in services.items()}
    for pkg in replies:
        stats = replies[pkg][-1]["stats"]
        for key in ("hits", "misses", "cached"):  # the read cache's
            stats.pop(key)
    assert replies["torch"] == replies["jax"]
    r = replies["torch"]
    assert r[-2]["error"] == "ValueError"
    assert r[-3]["error"] == "KeyError"
    history = r[13]["commits"]
    assert [c["meta"]["n"] for c in history] == [2, 1, 0]
    assert r[15]["tree"]["default"]["text"] == "hello"
    assert r[-1]["stats"]["handles_reused"] >= 1
    # the same objects on disk, id for id
    on_disk = {pkg: sorted(
        p.relative_to(tmp_path / pkg).as_posix()
        for p in (tmp_path / pkg).rglob("*")
        if p.is_file() and "refs" not in p.parts)
        for pkg in services}
    assert on_disk["torch"] == on_disk["jax"] != []
    services["torch"].close()


# ------------------------------------------- the storage server in process


def test_commit_dag_and_history_walk(tmp_path):
    """Summary uploads build parent-linked commits; the ref advances only
    on commit_ref; history walks the chain."""
    with storage_server(tmp_path / "s") as srv, remote(srv.port) as st:
        v1 = st.upload_summary({"root": {"a": 1}}, None)
        assert st.get_ref() is None          # unacked: not yet a version
        assert st.get_versions() == []
        st.commit_ref(v1)
        assert st.get_ref() == v1
        v2 = st.upload_summary({"root": {"a": 2}}, v1)
        st.commit_ref(v2)
        v3 = st.upload_summary({"root": {"a": 3}}, v2)
        st.commit_ref(v3)

        commits = st.history()
        assert [c["id"] for c in commits] == [v3, v2, v1]
        assert [c["meta"]["n"] for c in commits] == [2, 1, 0]
        assert commits[0]["parents"] == [v2]
        assert commits[2]["parents"] == []
        assert [v["id"] for v in st.get_versions(2)] == [v3, v2]
        assert st.get_snapshot_tree() == {"root": {"a": 3}}


def test_refs_survive_storage_server_restart(tmp_path):
    data = tmp_path / "s"
    with storage_server(data) as srv, remote(srv.port, "t", "d") as st:
        v1 = st.upload_summary({"root": {"x": 1}}, None)
        st.commit_ref(v1)
    with storage_server(data) as srv, remote(srv.port, "t", "d") as st:
        assert st.get_ref() == v1            # reflog replayed
        assert st.get_snapshot_tree() == {"root": {"x": 1}}


def test_client_boots_from_ref_through_storage_server(tmp_path):
    """Client summary → scribe ack advances the ref in the storage server
    → a fresh client boots from it; blob reads hit the read cache; a
    second summary chains onto the first."""
    with storage_server(tmp_path / "store") as srv:
        server = LocalServer(storage_server=("127.0.0.1", srv.port))
        front = NetworkFrontEnd(server).start_background()
        try:
            loader = Loader(NetworkDocumentServiceFactory(
                "127.0.0.1", front.port))
            c1 = loader.resolve("t", "doc")
            sm = SummaryManager(c1, max_ops=3)
            s = c1.runtime.create_data_store("default").create_channel(
                "text", "shared-string")
            s.insert_text(0, "stored remotely")
            assert wait_for(lambda: sm.summaries_acked >= 1)

            with remote(srv.port) as st:
                head = st.get_ref()
                assert head is not None      # scribe advanced the ref
                assert st.history()[0]["id"] == head
                c2 = loader.resolve("t", "doc")
                assert c2._base_snapshot is not None
                assert wait_for(lambda: c2.runtime.get_data_store(
                    "default").get_channel("text").get_text()
                    == "stored remotely")
                assert st.stats()["hits"] > 0
                for i in range(4):
                    s.insert_text(0, f"{i}")
                assert wait_for(lambda: sm.summaries_acked >= 2)
                hist = st.history()
                assert len(hist) == 2 and hist[1]["id"] == head
            c1.close()
            c2.close()
        finally:
            front.stop()
            server._storage_conn.close()


def test_fork_over_storage_server_is_refused(tmp_path):
    with storage_server(tmp_path / "s") as srv:
        server = LocalServer(storage_server=("127.0.0.1", srv.port))
        c = Loader(LocalDocumentServiceFactory(server)).resolve("t", "d")
        c.runtime.create_data_store("default").create_channel(
            "text", "shared-string").insert_text(0, "x")
        with pytest.raises(ValueError, match="storage-process"):
            server.history.fork("t", "d", new_doc="f")
        server._storage_conn.close()


# ------------------------------------------------ what is not ported


@pytest.mark.parametrize("flag", [["--table-dir", "x"], ["--shards", "2"],
                                  ["--lease-ttl", "5"]])
def test_table_door_options_raise(monkeypatch, tmp_path, flag):
    """The placement table door is ported: ``--table-dir`` arms it on
    the storage socket (``--shards`` and ``--lease-ttl`` size it), and a
    door answers ``admin_table_*`` frames over the flock'd table."""
    from fluidframework_tpu_torch.service import storage_server as mod
    from fluidframework_tpu_torch.service.table_client import (
        TableDoorService,
    )

    served = []
    monkeypatch.chdir(tmp_path)  # the table dir "x" is relative
    monkeypatch.setattr(mod.StorageServer, "serve_forever",
                        lambda self: served.append(self))
    monkeypatch.setattr(sys, "argv", ["storage_server", "--dir",
                                      str(tmp_path / "s"), *flag])
    mod.main()
    (server,) = served
    assert (server.table_door is not None) == (flag[0] == "--table-dir")
    server.service.close()
    door = TableDoorService(str(tmp_path / "shard"), 2, ttl_s=5.0)
    reply = door.handle({"t": "admin_table_read", "rid": 1})
    assert reply["rec"]["epoch"] == 0
    server = StorageServer(str(tmp_path / "s2"), table_door=door)
    assert server.table_door is door
    server.service.close()


# ------------------------------------------------- the golden session


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLDEN, "expected.json")) as fh:
        return json.load(fh)


def test_durable_log_and_blobs_boot_round3_session(tmp_path, expected):
    """A port server restarted over the golden log directory and chunk
    store restores the doc: summary head, retained tail, live edits."""
    # copy: recovery may truncate/append; the committed fixture stays pristine
    logdir = str(tmp_path / "svclog")
    blobdir = str(tmp_path / "blobs")
    shutil.copytree(os.path.join(GOLDEN, "svclog"), logdir)
    shutil.copytree(os.path.join(GOLDEN, "blobs"), blobdir)

    server = LocalServer(log=DurableLog(logdir), storage_dir=blobdir)
    assert server._get_orderer("t", "doc").scribe.last_summary_head == \
        expected["summary_head"]
    assert server._get_orderer("t", "doc").deli.sequence_number \
        == expected["seq"]

    c = Loader(LocalDocumentServiceFactory(server)).resolve("t", "doc")
    assert c._base_snapshot is not None  # booted FROM the golden summary
    s = c.runtime.get_data_store("default").get_channel("text")
    assert s.get_text() == expected["text"]
    pos_o = expected["text"].index("olden")
    assert s.client.get_properties_at(pos_o).get("bold") is True
    assert s.client.get_properties_at(0).get("bold") is None
    s.insert_text(0, "r4 ")
    assert s.get_text() == "r4 " + expected["text"]
    server.log.close()
