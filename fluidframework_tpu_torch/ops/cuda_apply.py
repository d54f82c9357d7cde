"""Wrapper of the hand-written CUDA apply kernel (``csrc/apply.cu``).

JAX counterpart: ``fluidframework_tpu/ops/pallas_apply.py::
pallas_apply_ops_batch``, the Pallas TPU kernel this replaces. Its plain
PyTorch version is ``ops/apply.py::apply_ops_batch_ref``.

``apply_ops_batch(state, ops)`` takes the plain version only for tensors
that lie on the CPU. For CUDA tensors it launches the kernel or raises;
nothing falls back. The kernel is built at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/torch_kernels/`` (keyed by a hash of the sources), and loaded with
``ctypes``. ``LAUNCHES`` counts the kernel's launches (under a lock: an
async applier launches from its worker thread).

Geometry (``launch_geometry``): up to 256 slots a doc, one warp per doc
with 1, 2, 4 or 8 consecutive slots a lane and ``DOCS_PER_CTA`` docs a
CTA; from 257 to 1024 slots, one CTA of ceil(S/256) warps per doc, 8
slots a lane. Each doc's prop rows, text_starts and flags (one row per
slot, inert slots past S included) and each warp's staged op rows sit in
shared memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from .apply import OP_FIELDS, apply_ops_batch_ref
from .doc_state import DEFAULT_MAX_PROPS, FIELDS, DocState

#: kernel launches since import (compare launches are counted too; callers
#: that need a path's own count reset it to 0 first)
LAUNCHES = 0
_LAUNCHES_LOCK = threading.Lock()

#: the prop-table capacity P the kernel is compiled for
KERNEL_PROPS = DEFAULT_MAX_PROPS
MAX_SLOTS = 1024  # at most 4 warps of 8 slots a lane per doc
#: docs a CTA holds when a doc is one warp (S <= 256)
DOCS_PER_CTA = 4
MAX_SHARED_BYTES = 232_448  # a block's dynamic shared memory on sm_90
MAX_THREADS = 128  # the kernel's __launch_bounds__
OP_CHUNK = 16  # op rows a warp stages into shared memory at once

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("apply.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
#: what the build of the loaded sources printed (ptxas registers / spills)
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


def build(sources: Optional[Sequence[Path]] = None,
          stem: str = "libff_apply") -> Path:
    """Compile the kernel library from the sources in this checkout (a
    no-op when a library for these exact sources is already built).
    ``sources`` and ``stem`` build another source of the kernel instead
    (an A/B baseline)."""
    global BUILD_LOG
    paths = ([CSRC / n for n in SOURCES] if sources is None
             else [Path(p) for p in sources])
    digest = hashlib.sha256()
    for path in paths:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    log.write_text(BUILD_LOG)
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ff_apply_ops_batch
        fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ff_error_string.argtypes = [ctypes.c_int]
        lib.ff_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch_geometry(S: int, P: int = KERNEL_PROPS) -> tuple[int, int, int,
                                                             int]:
    """``(slots_per_lane, warps_per_doc, docs_per_cta, smem_bytes)`` for
    docs of ``S`` slots and ``P`` prop entries a slot. ``csrc/apply.cu``
    takes these as arguments and checks them (``smem_needed`` there
    mirrors the byte count). Raises past the card's shared memory or the
    kernel's thread limit."""
    if not 0 < S <= MAX_SLOTS:
        raise ValueError(f"max_slots {S} outside 1..{MAX_SLOTS}")
    if S <= 256:
        spt = next(n for n in (1, 2, 4, 8) if 32 * n >= S)
        warps, docs = 1, DOCS_PER_CTA
    else:
        spt, warps, docs = 8, -(-S // 256), 1
    # per doc, for each of its 32 * spt * warps slots (inert ones past S
    # included): a prop row of 2P entries, a text_start and flags (padded
    # to 16 bytes); per warp: its staged op rows
    slots = 32 * spt * warps
    ints = (docs * (slots * 2 * P + -(-2 * slots // 4) * 4)
            + docs * warps * OP_CHUNK * OP_FIELDS)
    if warps > 1:  # cross-warp combine rows, and 4 rows a shift hands over
        ints += warps * 32 + 4
    smem = 4 * ints
    threads = 32 * warps * docs
    if threads > MAX_THREADS:
        raise ValueError(f"S={S}: {threads} threads a CTA, over "
                         f"{MAX_THREADS}")
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"S={S}, P={P}: {smem} bytes of shared memory a "
                         f"CTA, over {MAX_SHARED_BYTES}")
    return spt, warps, docs, smem


def _check(state: DocState, ops: torch.Tensor) -> None:
    D, S, P = state.num_docs, state.max_slots, state.max_props
    if ops.dtype != torch.int32 or ops.ndim != 3 or ops.shape[0] != D \
            or ops.shape[2] != OP_FIELDS:
        raise ValueError(f"ops must be int32 [{D}, K, {OP_FIELDS}], got "
                         f"{ops.dtype} {tuple(ops.shape)}")
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


def launch(state: DocState, ops: torch.Tensor,
           geometry: Optional[tuple[int, int, int, int]] = None) -> DocState:
    """Launch the kernel on CUDA tensors; raises on anything else.
    ``geometry`` replaces ``launch_geometry``'s choice (timing variants
    only; the kernel refuses one that does not fit)."""
    global LAUNCHES
    _check(state, ops)
    if ops.device.type != "cuda":
        raise ValueError(f"apply kernel: no kernel for {ops.device}")
    if geometry is None:
        geometry = launch_geometry(state.max_slots, state.max_props)
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
            D, S, P, K, *geometry, stream)
    if err:
        raise RuntimeError(
            f"apply kernel launch failed: {lib.ff_error_string(err).decode()}")
    with _LAUNCHES_LOCK:
        LAUNCHES += 1
    return out
