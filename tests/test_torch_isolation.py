"""The port stands alone: no JAX, no module of the JAX package, no silent
CPU fallback.

Every module of ``fluidframework_tpu_torch``, ``chip_smoke.py`` and
``driver_client_bench.py`` is parsed, and no import may name ``jax``, ``jaxlib`` or the module
``fluidframework_tpu`` (or a submodule of it), and no string a file could
run as a child's command line names a module of the JAX package. The op
log is built only from the port's own C++ source. The kernel path refuses
CPU tensors, and an entry point given no device refuses to run without a
card.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
import torch

import fluidframework_tpu_torch
from fluidframework_tpu_torch.ops import cuda_apply
from fluidframework_tpu_torch.ops.doc_state import DocState
from fluidframework_tpu_torch.service.gpu_applier import GpuDocumentApplier

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(fluidframework_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "fluidframework_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "driver_client_bench.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path) -> list:
    """Absolute module names a file imports (relative imports resolve
    inside the port and are skipped)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


#: the read side of the farm (summaries, the client stack that boots from
#: them, the replay tool): host modules copied from the JAX package
READ_SIDE = ("protocol/snapcols.py", "protocol/summary.py",
             "service/summary_trees.py", "service/service_summarizer.py",
             "driver/definitions.py", "driver/local.py", "driver/file.py",
             "dds/string.py", "dds/map.py", "runtime/container_runtime.py",
             "runtime/summarizer.py", "loader/container.py",
             "loader/delta_manager.py", "replay/tool.py")


#: the doc history plane and chaos soak phase A: host modules copied from
#: the JAX package
HISTORY_AND_CHAOS = ("protocol/refgraph.py", "obs/journal.py",
                     "service/history_plane.py", "driver/history.py",
                     "loader/history_boot.py", "chaos/__init__.py",
                     "chaos/plane.py", "chaos/monitor.py", "chaos/hooks.py",
                     "chaos/soak.py")


#: the parallel layer: the doc-sharded mesh and the giant-doc lane
PARALLEL = ("parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharded_apply.py", "parallel/long_doc.py",
            "parallel/placement.py")


#: the network tier: the socket front end and its small dependencies, the
#: relay (and its native binding), the network driver with its snapshot
#: cache and history client, the socket load and the fetch tool
NETWORK = ("service/front_end.py", "service/admission.py",
           "service/presence.py", "service/rehydrate.py", "obs/probe.py",
           "service/gateway.py", "native/gateway.py", "driver/network.py",
           "driver/snapshot_cache.py", "driver/history.py",
           "service/load_async.py", "service/load_gen.py", "replay/fetch.py",
           "replay/tool.py", "protocol/binwire.py")


#: the storage tier: the chunk store's binding, the commit/ref DAG, the
#: storage process and its client, and the modules that gained its options
STORAGE = ("native/chunkstore.py", "native/__init__.py",
           "service/blob_store.py", "service/git_store.py",
           "service/storage_server.py", "service/storage_client.py",
           "service/local_server.py", "service/local_orderer.py",
           "service/history_plane.py", "service/front_end.py",
           "service/stage_runner.py")


#: the sharded ordering core: tenants, the placement plane, the partition
#: runtime, the rebalancer, the topology spec, their two chaos campaigns,
#: and the modules that gained its hooks
SHARDED = ("service/tenants.py", "service/placement.py",
           "service/placement_plane.py", "service/table_client.py",
           "service/partitions.py", "service/rebalancer.py",
           "service/topology.py", "chaos/migrate.py", "chaos/rebalance.py",
           "service/deli.py", "service/local_orderer.py",
           "service/local_server.py", "service/front_end.py",
           "service/gateway.py", "service/storage_server.py")


#: the overload, health and recovery plane: the SLO and health engines
#: with the port's own copy of the doctor's rules, the three campaigns,
#: the foreman and the copier, and the modules that gained their seams
OVERLOAD_AND_HEALTH = ("obs/doctor_rules.py", "obs/slo.py", "obs/health.py",
                       "chaos/noisy.py", "chaos/coldstart.py",
                       "chaos/multihost.py", "service/foreman.py",
                       "service/copier.py", "chaos/hooks.py",
                       "chaos/soak.py", "service/front_end.py",
                       "service/admission.py", "driver/network.py",
                       "service/scriptorium.py")


#: the client application layer: the rest of the DDS catalog, the
#: framework, the agent scheduler and intel runner, the URL resolver, the
#: corpus recorder, and the seeded app documents of the smoke and tests
CLIENT_APPLICATION_LAYER = (
    "dds/cell.py", "dds/consensus.py", "dds/directory.py", "dds/ink.py",
    "dds/sequence.py", "dds/matrix.py", "framework/__init__.py",
    "framework/data_object.py", "framework/interceptions.py",
    "framework/undo_redo.py", "framework/last_edited.py",
    "framework/request_handler.py", "framework/synthesize.py",
    "runtime/agent_scheduler.py", "runtime/intel_runner.py",
    "loader/url_resolver.py", "replay/record.py", "testing/apps.py")


#: the operator and developer surface: the admin CLI, the dev host, the
#: seven example apps it loads by name and the offline bundle doctor
OPERATOR_SURFACE = (
    "admin.py", "host.py", "examples/__init__.py", "examples/shared_text.py",
    "examples/clicker.py", "examples/table_doc.py", "examples/todo.py",
    "examples/canvas.py", "examples/sudoku.py", "examples/album.py",
    "tools/doctor.py")
#: a module of the repo's ``examples/`` (an f-string part may end at the
#: dot)
REPO_APP = re.compile(r"(?<![\w/.])examples\.(\w|$)")


#: the merge-tree farms' sessions the smoke's ``farms`` phase feeds the
#: card, and the modules their twins repaired or completed
FARMS = ("testing/farm.py", "driver/network.py", "loader/delta_manager.py",
         "service/presence.py", "protocol/__init__.py",
         "service/__init__.py", "utils/__init__.py", "utils/telemetry.py")


def test_sources_cover_the_farm_generators():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(FARMS)
    assert ROOT / "chip_smoke.py" in SOURCES


def test_farm_generators_load_nothing_of_jax():
    """Each farm family's generator runs in a fresh interpreter with no
    module of JAX or of the JAX package loaded."""
    code = (
        "import sys\n"
        "from fluidframework_tpu_torch.testing import farm\n"
        "for name in ('conflict', 'inserts_removes', 'reconnect', "
        "'storm', 'growth'):\n"
        "    log, clients = getattr(farm, name + '_session')(1)\n"
        "    assert log and clients[0].text() == clients[-1].text()\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', "
        "'fluidframework_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_cover_the_operator_surface():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(OPERATOR_SURFACE)


@pytest.mark.parametrize("name", OPERATOR_SURFACE)
def test_operator_surface_names_no_repo_root_app(name):
    """No string of the operator surface names a module of the repo's
    ``examples/`` (apps that run on the JAX package): the dev host and the
    apps spawn and import only ``fluidframework_tpu_torch.examples``."""
    bad = [s for s in _strings(PORT / name) if REPO_APP.search(s)]
    assert not bad, f"{name} names {bad}"


def test_app_name_check_sees_the_jax_host():
    """The check is not vacuous: the JAX dev host's import of the repo's
    ``examples.<app>`` is what it refuses."""
    path = ROOT / "fluidframework_tpu" / "host.py"
    assert [s for s in _strings(path) if REPO_APP.search(s)]


def test_sources_cover_the_client_application_layer():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(CLIENT_APPLICATION_LAYER)
    assert ROOT / "chip_smoke.py" in SOURCES


def test_sources_cover_the_overload_and_health_plane():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(OVERLOAD_AND_HEALTH)
    assert ROOT / "chip_smoke.py" in SOURCES


def _reaches_outside(path: Path) -> list:
    """Imports of the repo's ``tools`` package, and any ``sys.path``
    edit, in one file."""
    bad = [n for n in _imports(path)
           if n == "tools" or n.startswith("tools.")]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Attribute) and node.attr == "path"
                and isinstance(node.value, ast.Name)
                and node.value.id == "sys"):
            bad.append(f"sys.path (line {node.lineno})")
    return bad


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_reach_into_tools(path):
    """The port keeps its own copy of what it needs (the doctor's rules
    are ``obs/doctor_rules.py``): no file imports the repo's ``tools``
    or edits ``sys.path`` to reach it."""
    bad = _reaches_outside(path)
    assert not bad, f"{path.relative_to(ROOT)} reaches {bad}"


def test_reach_check_sees_the_jax_health_engine():
    """The check is not vacuous: the JAX engine's ``sys.path`` insert
    into ``tools/`` is what it refuses."""
    bad = _reaches_outside(ROOT / "fluidframework_tpu" / "obs" / "health.py")
    assert "tools.doctor_rules" in bad
    assert any(b.startswith("sys.path") for b in bad)


def test_sources_cover_the_sharded_core():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(SHARDED)
    assert ROOT / "chip_smoke.py" in SOURCES


def test_sharded_core_spawns_the_ports_modules(tmp_path):
    """The fleet launcher's command lines name the port's modules."""
    from fluidframework_tpu_torch.service.topology import (
        GatewaySpec,
        default_spec,
        multihost_spec,
    )

    spec = default_spec(str(tmp_path / "f"), n_cores=2, n_partitions=2)
    spec.gateways = [GatewaySpec(name="g")]
    argv = [spec.core_argv(0, "s.json"), spec.gateway_argv(0, {0: 1}, {})]
    multi = multihost_spec(str(tmp_path / "m"), 2, 1, 2)
    multi.table_server = "h:1"
    argv += [multi.gateway_argv(i, {0: 1, 1: 2}, {})
             for i in range(len(multi.gateways))]
    modules = {a[a.index("-m") + 1] for a in argv}
    assert modules == {"fluidframework_tpu_torch.service.front_end",
                       "fluidframework_tpu_torch.service.gateway"}


def test_sources_cover_the_storage_tier():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(STORAGE)
    assert ROOT / "chip_smoke.py" in SOURCES


def test_sources_cover_the_network_tier():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(NETWORK)


def test_sources_cover_the_parallel_layer():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(PARALLEL)


def test_sources_cover_the_read_side():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(READ_SIDE)


def test_sources_cover_the_history_plane_and_the_soak():
    assert {str(p.relative_to(PORT)) for p in SOURCES
            if p.is_relative_to(PORT)} >= set(HISTORY_AND_CHAOS)
    assert ROOT / "chip_smoke.py" in SOURCES


def test_forbidden_names_match_exactly():
    assert _forbidden("jax.numpy") and _forbidden("fluidframework_tpu.ops")
    assert _forbidden("fluidframework_tpu")
    assert not _forbidden("fluidframework_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_path_refuses_cpu_tensors():
    state = DocState.empty(2, 8, device="cpu")
    ops = torch.zeros((2, 4, 12), dtype=torch.int32)
    before = cuda_apply.LAUNCHES
    with pytest.raises(ValueError, match="no kernel"):
        cuda_apply.launch(state, ops)
    assert cuda_apply.LAUNCHES == before


def test_mesh_step_refuses_cpu_kernel_launch():
    """On the card's path the mesh step launches B1 or raises: a CUDA
    state with CPU ops never falls back to the plain version."""
    from fluidframework_tpu_torch.parallel import make_mesh
    from fluidframework_tpu_torch.parallel.sharded_apply import apply_wave

    state = DocState.empty(2, 8, device="cpu")
    state.length = state.length.to("meta")
    before = cuda_apply.LAUNCHES
    with pytest.raises(ValueError):
        apply_wave(state, torch.zeros((2, 4, 12), dtype=torch.int32))
    assert cuda_apply.LAUNCHES == before
    assert make_mesh(devices=["cpu"]).shape == {"docs": 1, "seg": 1}


def test_no_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GpuDocumentApplier(max_docs=2, max_slots=8, ops_per_dispatch=4)
    app = GpuDocumentApplier(max_docs=2, max_slots=8, ops_per_dispatch=4,
                             device="cpu")
    assert app.state.device.type == "cpu"


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; it never falls back."""
    monkeypatch.setattr(cuda_apply.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_apply, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_apply.build()
    assert not list(tmp_path.rglob("*.so"))


def test_native_build_reads_only_port_sources(monkeypatch, tmp_path):
    """The op log is compiled from the port's own copy of its source."""
    import subprocess

    from fluidframework_tpu_torch.native import build as native_build

    commands = []

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build.subprocess, "run", fake_run)
    lib = native_build.build("oplog")
    assert lib.parent == tmp_path / "build" and lib.exists()
    (cmd,) = commands
    sources = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [PORT / "csrc" / "oplog.cpp"]
    assert native_build.source("oplog").is_relative_to(PORT)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_native_gateway_builds_only_from_port_sources(monkeypatch, tmp_path):
    """The gateway relay is compiled from the port's own copy of its
    source, through the port's loader (never the JAX package's)."""
    import subprocess

    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.native import gateway as native_gateway

    commands = []

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build.subprocess, "run", fake_run)
    lib = native_build.build("gateway")
    assert lib.parent == tmp_path / "build" and lib.exists()
    (cmd,) = commands
    sources = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [PORT / "csrc" / "gateway.cpp"]
    assert native_gateway.load_library is native_build.load_library


def test_chunk_store_builds_only_from_port_sources(monkeypatch, tmp_path):
    """The chunk store is compiled from the port's own copy of its source,
    and the port's blob store binds that build (never the JAX package's
    loader or an in-memory stand-in)."""
    import subprocess

    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.native import chunkstore
    from fluidframework_tpu_torch.service import blob_store

    commands = []

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build.subprocess, "run", fake_run)
    lib = native_build.build("chunkstore")
    assert lib.parent == tmp_path / "build" and lib.exists()
    (cmd,) = commands
    sources = [Path(a) for a in cmd if a.endswith((".cpp", ".cc", ".c"))]
    assert sources == [PORT / "csrc" / "chunkstore.cpp"]
    assert chunkstore.load_library is native_build.load_library
    assert blob_store.NativeChunkStore is chunkstore.NativeChunkStore


def test_chunk_store_build_failure_raises(monkeypatch, tmp_path):
    """Without g++ a storage directory cannot be opened: the server raises
    and never falls back to the db-backed blob store."""
    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.service.local_server import LocalServer

    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        LocalServer(storage_dir=str(tmp_path / "blobs"))


def test_native_build_needs_gxx(monkeypatch, tmp_path):
    from fluidframework_tpu_torch.native import build as native_build

    monkeypatch.setattr(native_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build("oplog")
    assert not list(tmp_path.rglob("*.so"))


def _strings(path: Path) -> list:
    """String constants of a file that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_package_in_command_strings(path):
    """No string a port file can run (a ``python -m`` or ``-c`` child's
    command line) names a module of the JAX package."""
    import re

    bad = [s for s in _strings(path)
           if re.search(r"(?<![\w/])fluidframework_tpu\.", s)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"
