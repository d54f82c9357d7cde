"""Wrapper of the hand-written CUDA apply kernel (``csrc/apply.cu``).

JAX counterpart: ``fluidframework_tpu/ops/pallas_apply.py::
pallas_apply_ops_batch``, the Pallas TPU kernel this replaces. Its plain
PyTorch version is ``ops/apply.py::apply_ops_batch_ref``.

``apply_ops_batch(state, ops)`` takes the plain version only for tensors
that lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. The kernel is built at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/torch_kernels/`` (keyed by a hash of the sources), and loaded with
``ctypes``. ``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from .apply import OP_FIELDS, apply_ops_batch_ref
from .doc_state import DEFAULT_MAX_PROPS, FIELDS, DocState

#: kernel launches since import (compare launches are counted too; callers
#: that need a path's own count reset it to 0 first)
LAUNCHES = 0

#: the prop-table capacity P the kernel is compiled for
KERNEL_PROPS = DEFAULT_MAX_PROPS
MAX_SLOTS = 1024  # one thread per slot, one block per doc

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("apply.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
#: what the last build printed (ptxas registers / spills)
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build csrc/apply.cu")


def build() -> Path:
    """Compile the kernel library from the sources in this checkout (a
    no-op when a library for these exact sources is already built)."""
    global BUILD_LOG
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libff_apply_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / n) for n in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ff_apply_ops_batch
        fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(state: DocState, ops: torch.Tensor) -> None:
    D, S, P = state.num_docs, state.max_slots, state.max_props
    if ops.dtype != torch.int32 or ops.ndim != 3 or ops.shape[0] != D \
            or ops.shape[2] != OP_FIELDS:
        raise ValueError(f"ops must be int32 [{D}, K, {OP_FIELDS}], got "
                         f"{ops.dtype} {tuple(ops.shape)}")
    if not 0 < S <= MAX_SLOTS:
        raise ValueError(f"max_slots {S} outside 1..{MAX_SLOTS}")
    if P != KERNEL_PROPS:
        raise ValueError(f"max_props {P}: the kernel is built for "
                         f"{KERNEL_PROPS}")
    shapes = {"prop_key": (D, S, P), "prop_val": (D, S, P), "count": (D,),
              "overflow": (D,)}
    for f in FIELDS:
        t = getattr(state, f)
        want_dtype = torch.bool if f == "overflow" else torch.int32
        if t.device != ops.device or t.dtype != want_dtype \
                or tuple(t.shape) != shapes.get(f, (D, S)) \
                or not t.is_contiguous():
            raise ValueError(
                f"state.{f}: want contiguous {want_dtype} "
                f"{shapes.get(f, (D, S))} on {ops.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not ops.is_contiguous():
        raise ValueError("ops must be contiguous")


def apply_ops_batch(state: DocState, ops: torch.Tensor) -> DocState:
    """Apply a NOOP-padded wave (int32 [D, K, OP_FIELDS]) to D docs.

    CPU tensors go to the plain version; CUDA tensors to the kernel,
    which writes a new state (the input state is left as it was)."""
    if ops.device.type == "cpu" and state.device.type == "cpu":
        return apply_ops_batch_ref(state, ops)
    return launch(state, ops)


def launch(state: DocState, ops: torch.Tensor) -> DocState:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    global LAUNCHES
    if ops.device.type != "cuda":
        raise ValueError(f"apply kernel: no kernel for {ops.device}")
    _check(state, ops)
    lib = load_library()
    out = DocState(**{f: torch.empty_like(getattr(state, f))
                      for f in FIELDS})
    D, S, P, K = (state.num_docs, state.max_slots, state.max_props,
                  ops.shape[1])
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream(ops.device).cuda_stream
        err = lib.ff_apply_ops_batch(
            ops.data_ptr(),
            *(getattr(state, f).data_ptr() for f in FIELDS),
            *(getattr(out, f).data_ptr() for f in FIELDS),
            D, S, P, K, stream)
    if err:
        raise RuntimeError(
            f"apply kernel launch failed: {lib.ff_error_string(err).decode()}")
    LAUNCHES += 1
    return out
