"""Commit/ref codec for the doc history plane.

JAX counterpart: ``fluidframework_tpu/protocol/refgraph.py``; the port's copy,
imports rebased to this package.

Every service-summarizer commit becomes a **history commit**
``{id, version, base_seq, parents, chunk_ids, ts}`` — a node in a per-doc
commit graph over snapshot generations, where ``chunk_ids`` are the
content-addressed snapcols chunks the generation references (shared
across generations and across forked docs). **Refs** are named branch
heads (``refs/main``, ``fork/<doc>`` pins) pointing at commit ids.

Both record kinds live in one append-only per-doc history file. Each
record is framed ``u32 len | u32 crc32(payload) | payload`` so a torn
tail (crash mid-append) is detected by length/CRC and dropped — the
scan never raises on trailing garbage, it returns what decoded cleanly
plus the byte offset where the clean prefix ends. ``RefLog`` wraps the
file with an ``flock`` around appends so concurrent writers (summarizer
ticker vs. a fork door) serialize; readers never need the lock because
the clean-prefix scan is safe against a concurrent append.

The codec is pure protocol-layer: fixed fields ride structs, string
lists ride ``u16 len`` frames, and open-ended metadata (fork origin,
integrate provenance) rides a JSON tail — mirroring binwire's
fixed-header + JSON-fallback idiom.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Optional

_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_FRAME = struct.Struct(">II")      # record framing: payload len, crc32
_COMMIT_FIXED = struct.Struct(">qd")  # base_seq, ts
_F64 = struct.Struct(">d")

REC_COMMIT = 1
REC_REF = 2
REC_DISCARD = 3   # recovery marker: a pending fork commit was discarded

# A ref record with an empty commit id deletes the ref.
_MAX_STR = 0xFFFF


def _pack_str(s: str) -> bytes:
    b = s.encode()
    if len(b) > _MAX_STR:
        raise ValueError("refgraph string too long")
    return _U16.pack(len(b)) + b


def _read_str(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = _U16.unpack_from(buf, off)
    off += 2
    return buf[off:off + n].decode(), off + n


def encode_commit(commit: dict) -> bytes:
    """Commit dict → record payload (unframed)."""
    parents = commit.get("parents") or []
    chunk_ids = commit.get("chunk_ids") or []
    extra = commit.get("extra") or {}
    out = [bytes((REC_COMMIT,)),
           _COMMIT_FIXED.pack(int(commit["base_seq"]),
                              float(commit.get("ts") or 0.0)),
           _pack_str(commit["id"]),
           _pack_str(commit["version"]),
           _U16.pack(len(parents))]
    for p in parents:
        out.append(_pack_str(p))
    out.append(_U32.pack(len(chunk_ids)))
    for c in chunk_ids:
        out.append(_pack_str(c))
    eb = json.dumps(extra, separators=(",", ":")).encode() if extra else b""
    out.append(_U32.pack(len(eb)))
    out.append(eb)
    return b"".join(out)


def encode_ref(name: str, commit_id: Optional[str], ts: float = 0.0) -> bytes:
    """Ref update → record payload. ``commit_id=None`` deletes the ref."""
    return (bytes((REC_REF,)) + _F64.pack(float(ts))
            + _pack_str(name) + _pack_str(commit_id or ""))


def encode_discard(commit_id: str) -> bytes:
    """Recovery marker: ``commit_id`` was a pending fork, now discarded."""
    return bytes((REC_DISCARD,)) + _pack_str(commit_id)


def decode_record(payload: bytes) -> dict:
    """Record payload → tagged dict (``t`` = commit | ref | discard)."""
    kind = payload[0]
    if kind == REC_COMMIT:
        base_seq, ts = _COMMIT_FIXED.unpack_from(payload, 1)
        off = 1 + _COMMIT_FIXED.size
        cid, off = _read_str(payload, off)
        version, off = _read_str(payload, off)
        (np_,) = _U16.unpack_from(payload, off)
        off += 2
        parents = []
        for _ in range(np_):
            p, off = _read_str(payload, off)
            parents.append(p)
        (nc,) = _U32.unpack_from(payload, off)
        off += 4
        chunk_ids = []
        for _ in range(nc):
            c, off = _read_str(payload, off)
            chunk_ids.append(c)
        (ne,) = _U32.unpack_from(payload, off)
        off += 4
        extra = (json.loads(payload[off:off + ne].decode()) if ne else {})
        return {"t": "commit", "id": cid, "version": version,
                "base_seq": base_seq, "parents": parents,
                "chunk_ids": chunk_ids, "ts": ts, "extra": extra}
    if kind == REC_REF:
        (ts,) = _F64.unpack_from(payload, 1)
        off = 1 + 8
        name, off = _read_str(payload, off)
        target, off = _read_str(payload, off)
        return {"t": "ref", "name": name, "commit": target or None, "ts": ts}
    if kind == REC_DISCARD:
        cid, _ = _read_str(payload, 1)
        return {"t": "discard", "commit": cid}
    raise ValueError(f"unknown refgraph record kind {kind}")


def frame_record(payload: bytes) -> bytes:
    """Payload → ``u32 len | u32 crc32 | payload`` on-disk frame."""
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def scan_records(buf: bytes) -> tuple[list[dict], int]:
    """Decode the clean prefix of a history file.

    Returns ``(records, clean_end)``: every record that framed and
    CRC-checked, and the byte offset the clean prefix ends at. A torn
    tail — short frame, short payload, CRC mismatch, or a payload that
    fails structural decode — terminates the scan without raising;
    ``clean_end`` is where an appender should resume (after truncating
    the tail).
    """
    records: list[dict] = []
    off = 0
    n = len(buf)
    while off + _FRAME.size <= n:
        plen, crc = _FRAME.unpack_from(buf, off)
        start = off + _FRAME.size
        end = start + plen
        if plen > n or end > n:          # torn: length ran past EOF
            break
        payload = buf[start:end]
        if zlib.crc32(payload) != crc:   # torn or corrupt: drop the tail
            break
        try:
            records.append(decode_record(payload))
        except Exception:
            break
        off = end
    return records, off


class RefLog:
    """Flocked append-only per-doc history file of framed records.

    Appends hold an ``flock`` (best effort — degrades to plain append
    where ``fcntl`` is unavailable) and truncate any torn tail left by
    a previous crash before extending, so the file always grows from a
    clean prefix. Loading tolerates a torn tail by construction.
    """

    def __init__(self, path: str):
        self.path = path

    def load(self) -> list[dict]:
        try:
            with open(self.path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            return []
        records, _ = scan_records(buf)
        return records

    def append(self, *payloads: bytes) -> None:
        data = b"".join(frame_record(p) for p in payloads)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "ab") as f:
            try:
                import fcntl
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            except Exception:
                pass
            try:
                # heal a torn tail before extending past it
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size:
                    with open(self.path, "rb") as rf:
                        _, clean = scan_records(rf.read())
                    if clean != size:
                        f.truncate(clean)
                        f.seek(0, os.SEEK_END)
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            finally:
                try:
                    import fcntl
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
                except Exception:
                    pass

    def truncate_at(self, size: int) -> None:
        """Chop the file to ``size`` bytes (chaos/test helper: tear the
        tail mid-record the way a crash would)."""
        with open(self.path, "r+b") as f:
            f.truncate(size)


def replay_records(records: list[dict]) -> tuple[dict, dict, set]:
    """Fold a record stream into ``(commits, refs, discarded)``.

    ``commits`` maps commit id → commit dict, ``refs`` maps ref name →
    commit id, ``discarded`` is the set of commit ids recovery chose to
    abandon (their records stay in the file; the marker wins).
    """
    commits: dict[str, dict] = {}
    refs: dict[str, str] = {}
    discarded: set = set()
    for rec in records:
        t = rec["t"]
        if t == "commit":
            commits[rec["id"]] = {k: rec[k] for k in
                                  ("id", "version", "base_seq", "parents",
                                   "chunk_ids", "ts", "extra")}
        elif t == "ref":
            if rec["commit"] is None:
                refs.pop(rec["name"], None)
            else:
                refs[rec["name"]] = rec["commit"]
        elif t == "discard":
            discarded.add(rec["commit"])
    return commits, refs, discarded


def commit_to_json(commit: dict) -> dict:
    """Commit dict → JSON-safe dict for RPC replies (stable key order)."""
    return {"id": commit["id"], "version": commit["version"],
            "base_seq": commit["base_seq"], "parents": list(commit["parents"]),
            "chunk_ids": list(commit["chunk_ids"]), "ts": commit["ts"],
            "extra": dict(commit.get("extra") or {})}


__all__ = [
    "REC_COMMIT", "REC_REF", "REC_DISCARD",
    "encode_commit", "encode_ref", "encode_discard", "decode_record",
    "frame_record", "scan_records", "replay_records", "RefLog",
    "commit_to_json",
]
