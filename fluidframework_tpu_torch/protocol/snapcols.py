"""snapcols: the columnar merge-tree snapshot chunk codec.

JAX counterpart: ``fluidframework_tpu/protocol/snapcols.py``; the port's copy,
imports rebased to this package.

Encodes ``MergeTreeClient.snapshot()`` output (the canonical segment
list, wire string client ids) as packed little-endian column chunks —
the snapshot-side twin of the FT_COLS op lane in :mod:`binwire`.
Layout per chunk (all LE)::

    u16 ver (=1)
    u16 n                       segment count
    u16 k + k×(u16 len + utf8)  chunk client-id string table
    n  × u8  kind               bit flags (marker/props/ins/rem/remClients)
    n  × i32 ins_seq            valid iff KIND_INS
    n  × i32 ins_client         client-table index (-1 = null)
    n  × i32 rem_seq            valid iff KIND_REM
    n  × i32 rem_client         client-table index (-1 = null)
    (n+1) × i32 text_off        byte offsets into the text blob
    u32 tlen + text             concatenated utf-8 text runs
    u32 alen + aux              tagged-value records (props/marker/remClients)

The i32 columns decode with ``np.frombuffer`` — a booting client never
walks segments in Python to parse stamps. The aux section is a
hand-rolled binary tagged-value codec (None/bool/int/float/str/list/
dict with sorted keys), NOT json: this module sits on the snapshot hot
path and is covered by fluidlint's storage json ban; the legacy JSON
tree shim in ``summary_trees.py`` is the sole exempted twin.

Chunking is by fixed segment count — but ``snapshot()`` is CANONICAL
(adjacent text runs with identical stamps coalesce), so a quiet
single-writer doc collapses into one ever-growing segment and naive
segment-count chunking would re-encode everything each generation.
Encode therefore first SPLITS oversized text runs into fixed-size
pieces (``TEXT_SPLIT_CHARS``): an append-only doc changes only its
trailing partial piece, every earlier piece — and thus every earlier
chunk — re-encodes byte-identical, and the content-addressed chunk
store dedupes them. Decode re-coalesces adjacent same-stamp pieces,
restoring the exact canonical form, so round-trips are byte-identical.
"""

from __future__ import annotations

import struct

import numpy as np

SNAPCOLS_VER = 1

#: default segments per chunk: big enough that chunk-count overhead is
#: noise, small enough that a single edited segment dirties one chunk
SEGS_PER_CHUNK = 256

#: max characters per encoded text run: the dedupe granularity for
#: coalesced base content (see module docstring)
TEXT_SPLIT_CHARS = 1024

KIND_MARKER = 0x01
KIND_PROPS = 0x02
KIND_INS = 0x04
KIND_REM = 0x08
KIND_REMCLIENTS = 0x10

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# aux tagged-value codec tags
_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3
_T_FLOAT = 4
_T_STR = 5
_T_LIST = 6
_T_DICT = 7


# ------------------------------------------------------- aux value codec
def _enc_value(v, out: list) -> None:
    if v is None:
        out.append(bytes((_T_NONE,)))
    elif v is True:
        out.append(bytes((_T_TRUE,)))
    elif v is False:
        out.append(bytes((_T_FALSE,)))
    elif isinstance(v, int):
        out.append(bytes((_T_INT,)) + _I64.pack(v))
    elif isinstance(v, float):
        out.append(bytes((_T_FLOAT,)) + _F64.pack(v))
    elif isinstance(v, str):
        b = v.encode()
        out.append(bytes((_T_STR,)) + _U32.pack(len(b)) + b)
    elif isinstance(v, (list, tuple)):
        out.append(bytes((_T_LIST,)) + _U32.pack(len(v)))
        for item in v:
            _enc_value(item, out)
    elif isinstance(v, dict):
        # sorted keys: identical dicts → identical bytes → chunk dedupe
        out.append(bytes((_T_DICT,)) + _U32.pack(len(v)))
        for k in sorted(v):
            kb = str(k).encode()
            out.append(_U32.pack(len(kb)) + kb)
            _enc_value(v[k], out)
    else:
        raise TypeError(f"snapcols aux cannot encode {type(v).__name__}")


def _dec_value(buf: bytes, off: int):
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_INT:
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == _T_FLOAT:
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == _T_STR:
        (ln,) = _U32.unpack_from(buf, off)
        off += 4
        return buf[off:off + ln].decode(), off + ln
    if tag == _T_LIST:
        (cnt,) = _U32.unpack_from(buf, off)
        off += 4
        items = []
        for _ in range(cnt):
            item, off = _dec_value(buf, off)
            items.append(item)
        return items, off
    if tag == _T_DICT:
        (cnt,) = _U32.unpack_from(buf, off)
        off += 4
        d = {}
        for _ in range(cnt):
            (kl,) = _U32.unpack_from(buf, off)
            off += 4
            key = buf[off:off + kl].decode()
            off += kl
            d[key], off = _dec_value(buf, off)
        return d, off
    raise ValueError(f"snapcols aux: unknown tag {tag}")


# ---------------------------------------------------------- chunk codec
def encode_chunk(segs: list) -> bytes:
    """Encode one run of snapshot segment dicts as a snapcols chunk."""
    n = len(segs)
    kinds = bytearray(n)
    ins_seq = np.zeros(n, "<i4")
    ins_cli = np.full(n, -1, "<i4")
    rem_seq = np.zeros(n, "<i4")
    rem_cli = np.full(n, -1, "<i4")
    text_off = np.zeros(n + 1, "<i4")
    clients: dict = {}  # wire client id str → chunk-table index

    def cli_idx(c) -> int:
        if c is None:
            return -1
        if not isinstance(c, str):
            raise TypeError(
                f"snapcols client ids are wire strings, got {c!r}")
        return clients.setdefault(c, len(clients))

    texts: list[bytes] = []
    aux: list[bytes] = []
    tpos = 0
    for i, d in enumerate(segs):
        k = 0
        if "props" in d:
            k |= KIND_PROPS
            _enc_value(d["props"], aux)
        if "marker" in d:
            k |= KIND_MARKER
            _enc_value(d["marker"], aux)
        else:
            tb = d["text"].encode()
            texts.append(tb)
            tpos += len(tb)
        if "insSeq" in d:
            k |= KIND_INS
            ins_seq[i] = d["insSeq"]
            ins_cli[i] = cli_idx(d["insClient"])
        if "remSeq" in d:
            k |= KIND_REM
            rem_seq[i] = d["remSeq"]
            rem_cli[i] = cli_idx(d["remClient"])
            if "remClients" in d:
                k |= KIND_REMCLIENTS
                _enc_value(list(d["remClients"]), aux)
        kinds[i] = k
        text_off[i + 1] = tpos
    table = [_U16.pack(len(clients))]
    for c in clients:  # insertion order == index order
        cb = c.encode()
        table.append(_U16.pack(len(cb)) + cb)
    text = b"".join(texts)
    auxb = b"".join(aux)
    return b"".join((
        _U16.pack(SNAPCOLS_VER), _U16.pack(n), b"".join(table),
        bytes(kinds), ins_seq.tobytes(), ins_cli.tobytes(),
        rem_seq.tobytes(), rem_cli.tobytes(), text_off.tobytes(),
        _U32.pack(len(text)), text, _U32.pack(len(auxb)), auxb,
    ))


def decode_chunk(chunk: bytes) -> list:
    """Decode one snapcols chunk back to snapshot segment dicts."""
    (ver,) = _U16.unpack_from(chunk, 0)
    if ver != SNAPCOLS_VER:
        raise ValueError(f"snapcols: unknown chunk version {ver}")
    (n,) = _U16.unpack_from(chunk, 2)
    off = 4
    (nclients,) = _U16.unpack_from(chunk, off)
    off += 2
    table: list[str] = []
    for _ in range(nclients):
        (cl,) = _U16.unpack_from(chunk, off)
        off += 2
        table.append(chunk[off:off + cl].decode())
        off += cl

    def cli(idx: int):
        return None if idx < 0 else table[idx]

    kinds = chunk[off:off + n]
    off += n
    ins_seq = np.frombuffer(chunk, "<i4", n, off)
    off += 4 * n
    ins_cli = np.frombuffer(chunk, "<i4", n, off)
    off += 4 * n
    rem_seq = np.frombuffer(chunk, "<i4", n, off)
    off += 4 * n
    rem_cli = np.frombuffer(chunk, "<i4", n, off)
    off += 4 * n
    text_off = np.frombuffer(chunk, "<i4", n + 1, off)
    off += 4 * (n + 1)
    (tlen,) = _U32.unpack_from(chunk, off)
    off += 4
    # keep bytes: text_off are BYTE offsets (utf-8 runs decode per-slice)
    text = chunk[off:off + tlen]
    off += tlen
    (alen,) = _U32.unpack_from(chunk, off)
    off += 4
    if off + alen > len(chunk):
        raise ValueError("snapcols: truncated aux section")
    apos = off
    segs: list[dict] = []
    for i in range(n):
        k = kinds[i]
        d: dict = {}
        if k & KIND_PROPS:
            d["props"], apos = _dec_value(chunk, apos)
        if k & KIND_MARKER:
            d["marker"], apos = _dec_value(chunk, apos)
        else:
            d["text"] = text[int(text_off[i]):int(text_off[i + 1])].decode()
        if k & KIND_INS:
            d["insSeq"] = int(ins_seq[i])
            d["insClient"] = cli(int(ins_cli[i]))
        if k & KIND_REM:
            d["remSeq"] = int(rem_seq[i])
            d["remClient"] = cli(int(rem_cli[i]))
            if k & KIND_REMCLIENTS:
                d["remClients"], apos = _dec_value(chunk, apos)
        segs.append(d)
    return segs


# ------------------------------------------------------- snapshot level
def _split_segments(segs: list, text_split: int) -> list:
    """Split oversized text runs into ≤ ``text_split``-char pieces with
    identical stamps — semantically a no-op (adjacent same-stamp runs
    are one run), but it pins the piece boundaries so appends leave
    every full piece byte-stable."""
    out: list = []
    for d in segs:
        t = d.get("text")
        if t is None or len(t) <= text_split:
            out.append(d)
            continue
        attrs = {k: v for k, v in d.items() if k != "text"}
        for i in range(0, len(t), text_split):
            out.append({**attrs, "text": t[i:i + text_split]})
    return out


def _coalesce_segments(segs: list) -> list:
    """The exact canonicalization rule of ``MergeTree.snapshot()``:
    adjacent text runs whose non-text fields match merge — the inverse
    of :func:`_split_segments`, so round-trips are byte-identical."""
    out: list = []
    for d in segs:
        prev = out[-1] if out else None
        if (prev is not None and "text" in prev and "text" in d
                and {k: v for k, v in prev.items() if k != "text"}
                == {k: v for k, v in d.items() if k != "text"}):
            prev["text"] += d["text"]
        else:
            out.append(dict(d))
    return out


def encode_snapshot_chunks(snap: dict,
                           segs_per_chunk: int = SEGS_PER_CHUNK,
                           text_split: int = TEXT_SPLIT_CHARS) -> list:
    """``snapshot()`` dict → list of chunk byte strings.

    minSeq/seq ride the version header (the root record), NOT the
    chunks — keeping chunks pure content is what makes an unchanged
    snapshot prefix hash-stable across generations.
    """
    segs = _split_segments(snap["segments"], text_split)
    if not segs:
        return [encode_chunk([])]
    return [encode_chunk(segs[i:i + segs_per_chunk])
            for i in range(0, len(segs), segs_per_chunk)]


def decode_snapshot_chunks(chunks: list, min_seq: int, seq: int) -> dict:
    """Chunk byte strings (+ header seqs) → the snapshot dict twin."""
    segs: list = []
    for c in chunks:
        segs.extend(decode_chunk(c))
    return {"minSeq": min_seq, "seq": seq,
            "segments": _coalesce_segments(segs)}
