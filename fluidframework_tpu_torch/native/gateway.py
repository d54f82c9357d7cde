"""ctypes binding for the native gateway relay (csrc/gateway.cpp).

JAX counterpart: ``fluidframework_tpu/native/gateway.py``. The library
is the port's own g++ build of ``csrc/gateway.cpp`` (``build.py``, into
``build/torch_kernels/``); a build or load failure raises.

The C++ loop owns the sockets and runs without the GIL (ctypes releases
it for the blocking ``gateway_run`` call); the Python process is only the
deployment shell (argv, readiness line, signals) — the §2.9 "native
front-end" posture with the uniform ``python -m`` deployment story.
"""

from __future__ import annotations

import ctypes

from .build import load_library


class NativeGateway:
    def __init__(self, core_host: str, core_port: int,
                 host: str = "127.0.0.1", port: int = 0):
        self._lib = load_library("gateway")
        self._lib.gateway_create.restype = ctypes.c_void_p
        self._lib.gateway_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        self._lib.gateway_port.restype = ctypes.c_int
        self._lib.gateway_port.argtypes = [ctypes.c_void_p]
        self._lib.gateway_run.restype = ctypes.c_int
        self._lib.gateway_run.argtypes = [ctypes.c_void_p]
        self._lib.gateway_stop.argtypes = [ctypes.c_void_p]
        self._lib.gateway_destroy.argtypes = [ctypes.c_void_p]
        self._handle = self._lib.gateway_create(
            core_host.encode(), core_port, host.encode(), port)
        if not self._handle:
            raise OSError(
                f"cannot start native gateway (core {core_host}:{core_port})")
        self.port = self._lib.gateway_port(self._handle)

    def run(self) -> int:
        """Blocks in C++ until stop() or the core connection drops."""
        return self._lib.gateway_run(self._handle)

    def stop(self) -> None:
        if self._handle:
            self._lib.gateway_stop(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.gateway_destroy(self._handle)
            self._handle = None
