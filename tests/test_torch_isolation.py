"""The port stands alone: no JAX, no module of the JAX package, no silent
CPU fallback.

Every module of ``fluidframework_tpu_torch`` and ``chip_smoke.py`` is
parsed, and no import may name ``jax``, ``jaxlib`` or the module
``fluidframework_tpu`` (or a submodule of it). The kernel path refuses CPU
tensors, and an entry point given no device refuses to run without a card.
"""

import ast
from pathlib import Path

import pytest
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
