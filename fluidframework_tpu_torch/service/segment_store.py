"""mmap'd reader over the durable log's columnar segment streams.

JAX counterpart: ``fluidframework_tpu/service/segment_store.py``; the
port's copy.

The write side lives in csrc/oplog.cpp (``oplog_seg_append``: packed
column blocks into fixed-size ``<stream>.seg<k>`` files + one 32-byte
entry per block in ``<stream>.segidx``); this module is the read side:

- the index mmaps as ONE numpy structured array (``SEG_IDX_DTYPE``
  matches the C ``SegEntry`` layout bit for bit), so recovery replay and
  backfill never decode per-record framing — one ``np.frombuffer`` per
  stream, then integer slicing;
- a ``[from_seq, to_seq]``-overlap query is two ``np.searchsorted``
  calls over the sorted first/last columns plus raw byte-range copies of
  the already-encoded blocks (the Kafka segment+index trick, SURVEY
  §2.9) — zero re-encode, zero per-op materialization;
- tail validation mirrors ``oplog_seg_refresh``: an index entry is
  admitted only once its block bytes fully landed in the segment file,
  so tailing a live producer never surfaces a torn block.

Readers re-mmap lazily as files grow; admitted entries are stable (the
writer's torn-tail recovery only ever cuts entries whose bytes never
landed, which a reader by construction never admitted).
"""

from __future__ import annotations

import mmap
import os
from typing import Callable, Optional

import numpy as np

# bit-for-bit the C SegEntry (csrc/oplog.cpp): i64 first/last seq span,
# u32 segment ordinal / byte offset / byte length / block type
SEG_IDX_DTYPE = np.dtype([("first", "<i8"), ("last", "<i8"), ("seg", "<u4"),
                          ("off", "<u4"), ("len", "<u4"), ("btype", "<u4")])


class SegmentReader:
    """Zero-copy-indexed view over one segment stream.

    ``flush`` is the same-process producer's flush hook (page-cache
    visibility for bytes still in libc buffers); cross-process readers
    pass None and rely on the producer's drain-boundary flush contract.
    """

    def __init__(self, directory: str, stream: str,
                 flush: Optional[Callable[[], None]] = None):
        self.directory = directory
        self.stream = stream
        self._flush = flush
        self._idx_mm: Optional[mmap.mmap] = None
        self._idx: Optional[np.ndarray] = None
        self._n = 0  # validated (admitted) block count
        self._seg_mm: dict[int, mmap.mmap] = {}

    def _idx_path(self) -> str:
        return os.path.join(self.directory, self.stream + ".segidx")

    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.directory, f"{self.stream}.seg{seg}")

    @property
    def count(self) -> int:
        return self._n

    def refresh(self) -> int:
        """Admit newly landed blocks; returns the validated block count."""
        if self._flush is not None:
            self._flush()
        try:
            size = os.path.getsize(self._idx_path())
        except OSError:
            return self._n
        item = SEG_IDX_DTYPE.itemsize
        n_disk = size // item
        if n_disk <= self._n:
            return self._n
        if self._idx_mm is None or len(self._idx_mm) < n_disk * item:
            if self._idx_mm is not None:
                self._idx = None  # release the buffer export before close
                self._idx_mm.close()
            with open(self._idx_path(), "rb") as f:
                self._idx_mm = mmap.mmap(f.fileno(), n_disk * item,
                                         access=mmap.ACCESS_READ)
        idx = np.frombuffer(self._idx_mm, SEG_IDX_DTYPE, n_disk)
        n = self._n
        sized_seg, sized = -1, 0
        while n < n_disk:
            e = idx[n]
            seg = int(e["seg"])
            if seg != sized_seg:
                sized_seg = seg
                try:
                    sized = os.path.getsize(self._seg_path(seg))
                except OSError:
                    sized = 0
            if int(e["off"]) + int(e["len"]) > sized:
                break  # mid-write tail: invisible until the bytes land
            n += 1
        self._idx = idx
        self._n = n
        return n

    def _seg_map(self, seg: int, need: int) -> mmap.mmap:
        mm = self._seg_mm.get(seg)
        if mm is None or len(mm) < need:
            if mm is not None:
                mm.close()
            with open(self._seg_path(seg), "rb") as f:
                mm = mmap.mmap(f.fileno(), os.fstat(f.fileno()).st_size,
                               access=mmap.ACCESS_READ)
            self._seg_mm[seg] = mm
        return mm

    def entry(self, ordinal: int) -> tuple[int, int, int]:
        """(btype, first_seq, last_seq) of an admitted block."""
        e = self._idx[ordinal]
        return int(e["btype"]), int(e["first"]), int(e["last"])

    def block(self, ordinal: int) -> tuple[int, int, int, bytes]:
        """(btype, first_seq, last_seq, payload) — one raw byte-range
        copy out of the segment mmap, no decoding."""
        if not 0 <= ordinal < self._n:
            raise IndexError(f"no block {ordinal} in {self.stream!r}")
        e = self._idx[ordinal]
        off, ln = int(e["off"]), int(e["len"])
        mm = self._seg_map(int(e["seg"]), off + ln)
        return (int(e["btype"]), int(e["first"]), int(e["last"]),
                bytes(mm[off:off + ln]))

    def range_blocks(self, from_seq: int, to_seq: int) -> list[int]:
        """Ordinals of blocks holding any seq with from_seq < seq <
        to_seq (the REST /deltas exclusive-bounds contract): binary
        search over the seq-span columns, O(log blocks) + O(answer).

        Spans are ALMOST sorted by ordinal, but a deli crash-replay can
        re-append blocks whose spans regress below earlier entries
        (at-least-once duplicates), so plain searchsorted over the raw
        columns is unsound. Searching the running-max of ``last`` and
        the suffix-min of ``first`` — both sorted by construction —
        yields a tight superset, and the exact overlap mask trims it."""
        n = self._n
        if n == 0:
            return []
        first = self._idx["first"][:n].astype(np.int64, copy=False)
        last = self._idx["last"][:n].astype(np.int64, copy=False)
        last_cm = np.maximum.accumulate(last)
        first_sm = np.minimum.accumulate(first[::-1])[::-1]
        lo = int(np.searchsorted(last_cm, from_seq, side="right"))
        hi = int(np.searchsorted(first_sm, to_seq, side="left"))
        if hi <= lo:
            return []
        mask = (last[lo:hi] > from_seq) & (first[lo:hi] < to_seq)
        return [lo + int(i) for i in np.nonzero(mask)[0]]

    def first_covering(self, seq: int) -> int:
        """Ordinal of the first block that may hold any seq' ≥ ``seq``
        (0 when seq ≤ 1 or the stream is empty). Blocks below it have
        running-max ``last`` < seq, so a tail subscription starting
        here misses nothing — the lazy cold-boot replay entry point.
        Duplicate blocks above it (crash-replay span regressions) are
        redelivered and absorbed by the consumers' idempotent skip."""
        n = self._n
        if n == 0 or seq <= 1:
            return 0
        last = self._idx["last"][:n].astype(np.int64, copy=False)
        return int(np.searchsorted(np.maximum.accumulate(last), seq - 1,
                                   side="right"))

    def close(self) -> None:
        for mm in self._seg_mm.values():
            mm.close()
        self._seg_mm.clear()
        if self._idx_mm is not None:
            self._idx = None
            self._idx_mm.close()
            self._idx_mm = None
        self._n = 0
