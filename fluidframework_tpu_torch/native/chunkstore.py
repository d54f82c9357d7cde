"""ctypes binding for the content-addressed store (``csrc/chunkstore.cpp``).

JAX counterpart: ``fluidframework_tpu/native/chunkstore.py``; the port's
copy, bound to the port's own build of the source. A failed build raises
(``build.py``): there is no in-memory stand-in."""

from __future__ import annotations

import ctypes

from .build import load_library


class NativeChunkStore:
    """sha256-addressed, dedup'd, crash-safe blob store (.git/objects
    layout)."""

    def __init__(self, directory: str):
        self._lib = load_library("chunkstore")
        self._lib.cas_open.restype = ctypes.c_void_p
        self._lib.cas_open.argtypes = [ctypes.c_char_p]
        self._lib.cas_close.argtypes = [ctypes.c_void_p]
        self._lib.cas_put.restype = ctypes.c_int
        self._lib.cas_put.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
        self._lib.cas_get.restype = ctypes.c_int64
        self._lib.cas_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
        self._lib.cas_has.restype = ctypes.c_int
        self._lib.cas_has.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        self._handle = self._lib.cas_open(directory.encode())
        if not self._handle:
            raise OSError(f"cannot open chunk store at {directory}")

    def put(self, data: bytes) -> str:
        out = ctypes.create_string_buffer(65)
        if self._lib.cas_put(self._handle, data, len(data), out) != 0:
            raise OSError("put failed")
        return out.value.decode()

    def get(self, blob_hash: str) -> bytes:
        size = 65536
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.cas_get(self._handle, blob_hash.encode(), buf, size)
            if n < 0:
                raise KeyError(blob_hash)
            if n <= size:
                return buf.raw[:n]
            size = n

    def has(self, blob_hash: str) -> bool:
        return bool(self._lib.cas_has(self._handle, blob_hash.encode()))

    def close(self) -> None:
        if self._handle:
            self._lib.cas_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
