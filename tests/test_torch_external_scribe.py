"""The external scribe: summary validation and acking out of the core,
in the port against the JAX package's.

A core ``LocalServer(log=DurableLog, external_scribe=True)`` announces
every summary upload on its log (``uploads/<tenant>/<doc>``, as
``front_end --external-scribe`` does), a ``stage_runner.ScribeStage``
stepped in process (``run_once``) validates and acks from the log, and
the core consumes the stage's backchannel through its front end's
handler. The same client edits through both packages give equal version
records, equal backchannel streams and equal stored state (timestamps
skipped: the scribe stamps its acks from the wall clock).
``LocalOrderer.commit_external_version`` and the front end's ``version``
record equal the JAX package's. Two tests run processes of the port: the
twin of ``tests/test_split_service.py::
test_summary_flow_through_external_scribe`` and of its
``test_full_production_composition`` (applier stages on ``--device cpu``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import canonical, stack, stored

from fluidframework_tpu_torch.driver.network import (
    NetworkDocumentServiceFactory,
)
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.runtime.summarizer import SummaryManager

ROOT = Path(__file__).resolve().parent.parent
PKG = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def wait_for(cond, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _mod(pkg: str, name: str):
    return import_module(f"{PKG[pkg]}.{name}")


def plain(obj):
    """A package-independent form with wall-clock fields left out
    (``timestamp``, ``ts``, trace hops)."""
    skip = {"timestamp", "ts", "traces"}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj) if f.name not in skip})
    if isinstance(obj, enum.Enum):
        return plain(obj.value)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items() if k not in skip}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


# ------------------------------------------- the scribe stage in process


def _external_scribe_run(pkg: str, tmp_path) -> dict:
    """Two summaries of one doc through a core with an external scribe
    stage stepped in process; returns what the core and the stage
    recorded."""
    st = stack(pkg)
    DurableLog = _mod(pkg, "service.durable_log").DurableLog
    runner = _mod(pkg, "service.stage_runner")
    FrontEnd = _mod(pkg, "service.front_end").NetworkFrontEnd
    log_dir, state_dir = tmp_path / pkg / "log", tmp_path / pkg / "scribe"
    log_dir.parent.mkdir()
    server = st.server(log=DurableLog(str(log_dir)), external_scribe=True)

    def announce_upload(tenant, doc, vid, rec):
        server.log.append(f"uploads/{tenant}/{doc}",
                          {"version_id": vid, "record": rec})
        server.log.flush()
    server.on_version_uploaded = announce_upload
    stage = runner.ScribeStage(str(log_dir), str(state_dir))
    front = FrontEnd(server)
    front.attach_backchannel(str(state_dir))

    def step():
        server.log.flush()
        stage.run_once()
        for bc in front._backchannels:
            if bc.poll():
                bc.drain()

    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    sm = st.SummaryManager(c1, max_ops=3)
    s = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s.insert_text(0, "abcdef")
    s.remove_text(0, 2)
    for _ in range(50):
        step()
        if sm.summaries_acked >= 1:
            break
    assert sm.summaries_acked == 1, pkg
    for i in range(4):
        s.insert_text(0, f"{i}")
    for _ in range(50):
        step()
        if sm.summaries_acked >= 2:
            break
    assert sm.summaries_acked == 2, pkg
    c2 = loader.resolve("t", "doc", connect=False)
    assert c2._base_snapshot is not None
    text = c2.runtime.get_data_store("default").get_channel(
        "text").get_text()
    bc = [stage.state.read(runner.BACKCHANNEL_TOPIC, i)
          for i in range(stage.state.length(runner.BACKCHANNEL_TOPIC))]
    versions = server.db.collection(
        st.summary_versions_collection("t", "doc"))
    out = {"text": text, "writer": s.get_text(),
           "head": server._get_orderer("t", "doc").scribe.last_summary_head,
           "versions": plain(dict(versions)), "backchannel": plain(bc),
           "db": plain({n: canonical(c)
                        for n, c in server.db.collections.items()}),
           "log": {t: plain([server.log.read(t, i)
                             for i in range(server.log.length(t))])
                   for t in sorted(server.log.list_topics())},
           "stage_scribe": plain(
               stage.scribes["t/doc"].checkpoint_state())}
    c1.close()
    for b in front._backchannels:
        b.close()
    stage.shared.close()
    stage.state.close()
    server.log.close()
    return out


def test_scribe_stage_in_process_equals_jax(tmp_path):
    got = _external_scribe_run("torch", tmp_path)
    want = _external_scribe_run("jax", tmp_path)
    assert got["writer"] == want["writer"] == "3210cdef"
    # the boot reads the newest acked summary (no tail: not connected)
    assert got["text"] == want["text"]
    assert got["writer"].endswith(got["text"])
    kinds = [r["kind"] for r in got["backchannel"]]
    assert kinds.count("version") == 2 and "raw" in kinds
    assert got["head"] == want["head"] == "v1"
    assert all(v["acked"] for v in got["versions"].values())
    for key in ("versions", "backchannel", "stage_scribe", "db", "log"):
        assert got[key] == want[key], key


def _commit_external(pkg: str) -> dict:
    st = stack(pkg)
    server = st.server()
    loader = st.Loader(st.LocalDocumentServiceFactory(server))
    loader.resolve("t", "doc").runtime.create_data_store(
        "default").create_channel("text", "shared-string").insert_text(
            0, "x")
    orderer = server._get_orderer("t", "doc")
    fired = []
    orderer._on_version_persisted = lambda h, v: fired.append((h, v))
    version = {"n": 0, "tree_id": "tree0", "parent": None, "acked": True,
               "seq": 3}
    orderer.commit_external_version("v0", version)
    orderer.commit_external_version("v0", version)  # already acked
    orderer.commit_external_version("v1", dict(version, n=1, parent="v0"))
    return {"head": orderer.scribe.last_summary_head, "fired": fired,
            "stored": plain(stored(server))}


def test_commit_external_version_equals_jax():
    """An external scribe's commit lands in the db, the versions topic and
    the scribe head; a repeated commit of an acked version is not
    persisted twice, and the ref hook fires once a persisted version."""
    got, want = _commit_external("torch"), _commit_external("jax")
    assert got == want
    assert got["head"] == "v1"
    assert [h for h, _ in got["fired"]] == ["v0", "v1"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_front_end_version_record_lands(pkg):
    """The backchannel's ``version`` record commits through the orderer
    (it used to raise in the port)."""
    st = stack(pkg)
    server = st.server()
    front = _mod(pkg, "service.front_end").NetworkFrontEnd(server)
    rec = {"kind": "version", "tenant": "t", "doc": "d", "handle": "v0",
           "version": {"n": 0, "tree_id": "x", "parent": None,
                       "acked": True}}
    front._on_backchannel_record(type("M", (), {"value": rec})())
    col = server.db.collection(st.summary_versions_collection("t", "d"))
    assert col["v0"]["acked"]
    assert server._get_orderer("t", "d").scribe.last_summary_head == "v0"
    assert server.log.length("versions/t/d") == 1


def test_external_scribe_core_does_not_subscribe_scribe(tmp_path):
    """With an external scribe the core's scribe is off the deltas topic:
    a summarize op is not validated in the core."""
    from fluidframework_tpu_torch.service.local_server import LocalServer

    server = LocalServer(external_scribe=True)
    orderer = server._get_orderer("t", "d")
    handlers = [h for _t, h, _o in orderer._subscriptions]
    assert orderer.scribe.handler not in handlers
    assert len(handlers) == 3
    assert len(LocalServer()._get_orderer("t", "d")._subscriptions) == 4


# --------------------------------------------------- processes of the port


def _spawn(args, ready, err):
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE, stderr=err,
        text=True, cwd=str(ROOT), env={**os.environ, "OMP_NUM_THREADS": "1"})
    line = proc.stdout.readline().strip()
    assert line.startswith(ready), (args, line)
    return proc, line


@contextlib.contextmanager
def processes(tmp_path):
    """Spawns ``python -m`` children of the port; dumps their stderr when
    the body fails and stops every one of them after."""
    procs = []
    err_path = tmp_path / "stderr.txt"
    with open(err_path, "w") as err:
        def spawn(args, ready):
            proc, line = _spawn(args, ready, err)
            procs.append(proc)
            return int(line.rsplit(":", 1)[1]) if ":" in line else proc
        try:
            yield spawn
        except BaseException:
            print(err_path.read_text())
            raise
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                    p.wait(timeout=10)


def _stage(stage, log_dir, state_dir, *extra):
    return ["fluidframework_tpu_torch.service.stage_runner", "--stage",
            stage, "--log-dir", str(log_dir), "--state-dir", str(state_dir),
            *extra]


def test_summary_flow_through_external_scribe(tmp_path):
    """Client summary validated and acked by the scribe PROCESS: upload →
    SUMMARIZE sequenced by the core → the stage validates against the
    announced upload → ack ordered back through the backchannel → a
    fresh client boots from the committed version."""
    log_dir, state = tmp_path / "log", tmp_path / "scribe-state"
    with processes(tmp_path) as spawn:
        spawn(_stage("scribe", log_dir, state), "READY")
        port = spawn(["fluidframework_tpu_torch.service.front_end",
                      "--port", "0", "--log-dir", str(log_dir),
                      "--storage-dir", str(tmp_path / "blobs"),
                      "--external-scribe",
                      "--consume-backchannel", str(state)], "LISTENING")
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        c1 = loader.resolve("t", "doc")
        sm = SummaryManager(c1, max_ops=3)
        s = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        s.insert_text(0, "abcdef")
        s.remove_text(0, 2)
        assert wait_for(lambda: sm.summaries_acked >= 1)
        c2 = loader.resolve("t", "doc")
        assert c2._base_snapshot is not None
        assert wait_for(lambda: c2.runtime.get_data_store("default")
                        .get_channel("text").get_text() == "cdef")
        c1.close()
        c2.close()
    # the blobs went to the native chunk store, not the core's db
    assert any(p.is_file() for p in (tmp_path / "blobs").rglob("*"))


def _applied_seq(state_dir, tenant, doc) -> int:
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.stage_runner import (
        BACKCHANNEL_TOPIC,
    )

    try:
        log = DurableLog(str(state_dir), readonly=True)
    except OSError:
        return 0
    try:
        n = log.refresh_topic(BACKCHANNEL_TOPIC)
        return max([log.read(BACKCHANNEL_TOPIC, i)["applied_seq"]
                    for i in range(n)
                    if log.read(BACKCHANNEL_TOPIC, i).get("kind")
                    == "applied"
                    and log.read(BACKCHANNEL_TOPIC, i)["doc"] == doc],
                   default=0)
    finally:
        log.close()


def test_full_production_composition(tmp_path):
    """EVERY tier at once, each its own process of the port: the storage
    server, the core over the durable log with an external scribe, the
    scribe stage, two partitioned applier stages and a native gateway. A
    client edits through the gateway, its summary is validated by the
    scribe PROCESS, the ref advances in the storage PROCESS, a fresh
    client boots from it, and the doc's applier stage (and only it)
    reports the doc applied to the stream tail."""
    from fluidframework_tpu_torch.service.stage_runner import doc_partition
    from fluidframework_tpu_torch.service.storage_client import (
        RemoteStorage,
        StorageConnection,
    )

    log_dir, sstate = tmp_path / "log", tmp_path / "scribe"
    astates = [tmp_path / "ap0", tmp_path / "ap1"]
    with processes(tmp_path) as spawn:
        sport = spawn(["fluidframework_tpu_torch.service.storage_server",
                       "--dir", str(tmp_path / "store")], "LISTENING")
        spawn(_stage("scribe", log_dir, sstate), "READY")
        for i, st in enumerate(astates):
            spawn(_stage("applier", log_dir, st, "--device", "cpu",
                         "--partition", f"{i}/2"), "READY")
        port = spawn(["fluidframework_tpu_torch.service.front_end",
                      "--port", "0", "--log-dir", str(log_dir),
                      "--storage-server", str(sport), "--external-scribe",
                      "--consume-backchannel", str(sstate),
                      "--consume-backchannel", str(astates[0]),
                      "--consume-backchannel", str(astates[1])],
                     "LISTENING")
        gport = spawn(["fluidframework_tpu_torch.service.gateway",
                       "--core-port", str(port)], "LISTENING")

        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", gport))
        c1 = loader.resolve("t", "doc")
        # 4 OPERATION messages (2 channel attaches + 2 inserts) reach it
        sm = SummaryManager(c1, max_ops=4)
        s = c1.runtime.create_data_store("default").create_channel(
            "text", "shared-string")
        for w in ("full ", "stack "):
            s.insert_text(0, w)
        assert wait_for(lambda: sm.summaries_acked >= 1, timeout=60)

        conn = StorageConnection("127.0.0.1", sport)
        st = RemoteStorage(conn, "t", "doc")
        head = st.get_ref()
        assert head is not None              # scribe→core→storage ref
        assert st.history()[0]["id"] == head
        c2 = loader.resolve("t", "doc")      # boots from the ref
        assert c2._base_snapshot is not None
        assert wait_for(lambda: c2.runtime.get_data_store("default")
                        .get_channel("text").get_text() == "stack full ")
        conn.close()
        owner = doc_partition("t", "doc", 2)
        tail = c1.delta_manager.last_processed_seq
        assert wait_for(
            lambda: _applied_seq(astates[owner], "t", "doc") >= tail,
            timeout=90)
        assert _applied_seq(astates[1 - owner], "t", "doc") == 0
        c1.close()
        c2.close()
