"""g++ build of the port's native C++ components, at first use.

JAX counterpart: ``fluidframework_tpu/native/build.py``. The sources are
read only from this package's ``csrc/`` directory; each library is built
into ``build/torch_kernels/`` under a name keyed by a hash of its source
and flags. Every build compiles to a name of its own (the process id in
it) and is renamed into place, so processes that build at once never load
a half-written library. A missing g++ or a failed compile raises: there is
no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source(name: str) -> Path:
    """The C++ source of component ``name`` (``csrc/<name>.cpp``)."""
    return CSRC / f"{name}.cpp"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` into a shared library (a no-op when a
    library for this exact source is already built); returns its path."""
    src = source(name)
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: cannot build {src}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of component ``name``, built if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib
