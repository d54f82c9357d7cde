"""The port stands alone: no JAX, no module of the JAX package, no silent
CPU fallback.

Every module of ``fluidframework_tpu_torch`` and ``chip_smoke.py`` is
parsed, and no import may name ``jax``, ``jaxlib`` or the module
``fluidframework_tpu`` (or a submodule of it), and no string a file could
run as a child's command line names a module of the JAX package. The op
log is built only from the port's own C++ source. The kernel path refuses
CPU tensors, and an entry point given no device refuses to run without a
card.
"""

import ast
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
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    from fluidframework_tpu_torch.parallel.sharded_apply import _apply_local

    state = DocState.empty(2, 8, device="cpu")
    state.length = state.length.to("meta")
    before = cuda_apply.LAUNCHES
    with pytest.raises(ValueError):
        _apply_local(state, torch.zeros((2, 4, 12), dtype=torch.int32))
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
