"""ctypes binding for the durable op log (``csrc/oplog.cpp``).

JAX counterpart: ``fluidframework_tpu/native/oplog.py``; the port's copy,
bound to the port's own build of the source."""

from __future__ import annotations

import ctypes

from .build import load_library


class NativeOpLog:
    """Durable append-only partitioned log of byte records.

    ``readonly=True`` opens a CONSUMER handle for a directory another
    process is writing: it never creates or truncates files, and
    :meth:`refresh` tails records the producer has flushed
    (``flush()``) since the last call — the cross-process pipe the
    per-stage service composition rides (service/stage_runner.py)."""

    def __init__(self, directory: str, readonly: bool = False):
        self._lib = load_library("oplog")
        self._lib.oplog_open.restype = ctypes.c_void_p
        self._lib.oplog_open.argtypes = [ctypes.c_char_p]
        self._lib.oplog_open_readonly.restype = ctypes.c_void_p
        self._lib.oplog_open_readonly.argtypes = [ctypes.c_char_p]
        self._lib.oplog_close.argtypes = [ctypes.c_void_p]
        self._lib.oplog_append.restype = ctypes.c_int64
        self._lib.oplog_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64]
        self._lib.oplog_length.restype = ctypes.c_int64
        self._lib.oplog_length.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        self._lib.oplog_read.restype = ctypes.c_int64
        self._lib.oplog_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        self._lib.oplog_sync.restype = ctypes.c_int
        self._lib.oplog_sync.argtypes = [ctypes.c_void_p]
        self._lib.oplog_flush.restype = ctypes.c_int
        self._lib.oplog_flush.argtypes = [ctypes.c_void_p]
        self._lib.oplog_refresh.restype = ctypes.c_int64
        self._lib.oplog_refresh.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        self._lib.oplog_seg_config.restype = ctypes.c_int
        self._lib.oplog_seg_config.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        self._lib.oplog_seg_append.restype = ctypes.c_int64
        self._lib.oplog_seg_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        self._lib.oplog_seg_count.restype = ctypes.c_int64
        self._lib.oplog_seg_count.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        self._lib.oplog_seg_read.restype = ctypes.c_int64
        self._lib.oplog_seg_read.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        self._lib.oplog_seg_entry.restype = ctypes.c_int
        self._lib.oplog_seg_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64] + \
            [ctypes.POINTER(ctypes.c_int64)] * 6
        self._lib.oplog_seg_refresh.restype = ctypes.c_int64
        self._lib.oplog_seg_refresh.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        self._lib.oplog_seg_tear.restype = ctypes.c_int
        self._lib.oplog_seg_tear.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        self._lib.oplog_fd_cap.restype = ctypes.c_int
        self._lib.oplog_fd_cap.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        self._lib.oplog_open_files.restype = ctypes.c_int64
        self._lib.oplog_open_files.argtypes = [ctypes.c_void_p]
        self.readonly = readonly
        # topic-name encode cache: append/length/read run per record on
        # the durable hot path; str.encode is measurable there
        self._names: dict[str, bytes] = {}
        opener = (self._lib.oplog_open_readonly if readonly
                  else self._lib.oplog_open)
        self._handle = opener(directory.encode())
        if not self._handle:
            raise OSError(f"cannot open op log at {directory}")

    def _name(self, topic: str) -> bytes:
        b = self._names.get(topic)
        if b is None:
            b = self._names[topic] = topic.encode()
        return b

    def append(self, topic: str, record: bytes) -> int:
        off = self._lib.oplog_append(
            self._handle, self._name(topic), record, len(record))
        if off < 0:
            raise OSError(f"append to {topic!r} failed")
        return off

    def length(self, topic: str) -> int:
        n = self._lib.oplog_length(self._handle, self._name(topic))
        if n < 0:
            # readonly consumers race topic creation: a topic the
            # producer hasn't created yet has length 0, same contract as
            # refresh(). Writers auto-create, so -1 there is a real error.
            if self.readonly:
                return 0
            raise OSError(f"bad topic {topic!r}")
        return n

    def read(self, topic: str, offset: int) -> bytes:
        size = 4096
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.oplog_read(
                self._handle, self._name(topic), offset, buf, size)
            if n < 0:
                raise IndexError(f"no record {offset} in {topic!r}")
            if n <= size:
                return buf.raw[:n]
            size = n  # buffer too small: retry at the reported size

    # ---------------------------------------------------- segment streams

    def seg_config(self, seg_bytes: int) -> None:
        """Segment roll threshold for this handle (testing knob)."""
        if self._lib.oplog_seg_config(self._handle, seg_bytes) != 0:
            raise OSError("bad segment size")

    def fd_cap(self, cap: int) -> None:
        """Cap concurrently open FILE*s across this handle's topics and
        segment streams (0 = unlimited). Topic metadata stays resident;
        cold handles are flushed, closed, and reopened on demand — how a
        core holds 10k+ rehydrated docs inside RLIMIT_NOFILE."""
        if self._lib.oplog_fd_cap(self._handle, cap) != 0:
            raise OSError("bad fd cap")

    def open_files(self) -> int:
        """Currently open FILE*s (tests and fd budgeting)."""
        return int(self._lib.oplog_open_files(self._handle))

    def seg_append(self, stream: str, first_seq: int, last_seq: int,
                   block: bytes, btype: int) -> int:
        n = self._lib.oplog_seg_append(
            self._handle, self._name(stream), first_seq, last_seq,
            block, len(block), btype)
        if n < 0:
            raise OSError(f"segment append to {stream!r} failed")
        return n

    def seg_count(self, stream: str) -> int:
        n = self._lib.oplog_seg_count(self._handle, self._name(stream))
        if n < 0:
            if self.readonly:
                return 0  # producer hasn't created the stream yet
            raise OSError(f"bad segment stream {stream!r}")
        return n

    def seg_read(self, stream: str, ordinal: int) -> bytes:
        size = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.oplog_seg_read(
                self._handle, self._name(stream), ordinal, buf, size)
            if n < 0:
                raise IndexError(f"no block {ordinal} in {stream!r}")
            if n <= size:
                return buf.raw[:n]
            size = n

    def seg_entry(self, stream: str, ordinal: int) -> tuple:
        """Block metadata: (first_seq, last_seq, seg, off, len, btype)."""
        out = [ctypes.c_int64() for _ in range(6)]
        rc = self._lib.oplog_seg_entry(
            self._handle, self._name(stream), ordinal,
            *[ctypes.byref(o) for o in out])
        if rc != 0:
            raise IndexError(f"no block {ordinal} in {stream!r}")
        return tuple(o.value for o in out)

    def seg_refresh(self, stream: str) -> int:
        """Tail blocks another process appended; refreshed block count."""
        n = self._lib.oplog_seg_refresh(self._handle, self._name(stream))
        return 0 if n < 0 else n

    def seg_tear(self, stream: str, first_seq: int, last_seq: int,
                 block: bytes, btype: int, mode: int = 0) -> None:
        """Chaos seam: leave a deliberately torn tail on disk without
        admitting the block (mode 0 = half the block bytes and no index
        entry, mode 1 = full block but half an index entry)."""
        rc = self._lib.oplog_seg_tear(
            self._handle, self._name(stream), first_seq, last_seq,
            block, len(block), btype, mode)
        if rc != 0:
            raise OSError(f"segment tear on {stream!r} failed")

    def sync(self) -> None:
        if self._lib.oplog_sync(self._handle) != 0:
            raise OSError("sync failed")

    def flush(self) -> None:
        """Make buffered appends visible to consumer processes (fflush
        into the page cache — durability still requires sync())."""
        if self._lib.oplog_flush(self._handle) != 0:
            raise OSError("flush failed")

    def refresh(self, topic: str) -> int:
        """Tail records another process appended; returns the topic's
        refreshed length (0 if the producer hasn't created it yet)."""
        n = self._lib.oplog_refresh(self._handle, self._name(topic))
        return 0 if n < 0 else n

    def close(self) -> None:
        if self._handle:
            self._lib.oplog_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
