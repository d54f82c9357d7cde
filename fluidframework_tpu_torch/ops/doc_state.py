"""Device-resident document state: structure-of-arrays segment store.

JAX counterpart: ``fluidframework_tpu/ops/doc_state.py`` (``DocState``,
``PropTable``, ``TextArena``, ``encode_tree``, ``decode_state``). Here a
``DocState`` always carries a leading doc dimension D, and its tensors
live on one explicit device.

Per document, ``max_slots`` fixed-capacity int32 arrays (capacity
overflow raises a per-doc flag for host escalation):

- ``length``     segment length (0 ⇒ unused slot; markers have length 1)
- ``text_start`` offset into the host-side text arena; segment splits are
                 pure arithmetic, so the device never touches text bytes
- ``flags``      bit 0 = marker (out of band: the arena byte is not the
                 classifier)
- ``ins_seq``, ``ins_client``          insert stamp
- ``rem_seq``    earliest remove seq (NO_SEQ = never removed)
- ``rem_client_a``, ``rem_client_b``   up to two removing clients; a third
                 concurrent remover sets ``overflow``
- ``prop_key``, ``prop_val``  [S, P] per-slot annotation table of interned
                 (key, value) ids (key -1 = empty entry)
- ``count``      used slots (slots [0, count) are ordered and contiguous)
- ``overflow``   bool: capacity / remove-client / prop-table overflow

``state_from_numpy`` and ``state_to_numpy`` carry a state across from the
JAX package's ``DocState`` arrays (as numpy) and back; the parity tests
feed both packages the same input through them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Optional, Union

import numpy as np
import torch

from ..mergetree.mergetree import MergeTree
from ..mergetree.segments import NO_CLIENT, Segment

NO_SEQ = -1  # "never removed" sentinel
NO_KEY = -1  # empty property-table slot
FLAG_MARKER = 1  # flags bit 0

DEFAULT_MAX_PROPS = 8  # P: per-slot property-table capacity

#: the [D, S] int32 slot fields, in kernel argument order
SLOT_FIELDS = ("length", "text_start", "flags", "ins_seq", "ins_client",
               "rem_seq", "rem_client_a", "rem_client_b")
#: every field, in kernel argument order
FIELDS = SLOT_FIELDS + ("prop_key", "prop_val", "count", "overflow")


class PropTable:
    """Host-side interning of annotation keys and values to dense int32
    ids. Dense interning (not hashing) — no collisions by construction.
    Values are canonicalised through JSON so equal values share one id."""

    def __init__(self):
        self._keys: list[str] = []
        self._key_ids: dict[str, int] = {}
        self._vals: list[Any] = []
        self._val_ids: dict[str, int] = {}

    def intern_key(self, key: str) -> int:
        kid = self._key_ids.get(key)
        if kid is None:
            kid = len(self._keys)
            self._key_ids[key] = kid
            self._keys.append(key)
        return kid

    def intern_val(self, value: Any) -> int:
        canon = json.dumps(value, sort_keys=True)
        vid = self._val_ids.get(canon)
        if vid is None:
            vid = len(self._vals)
            self._val_ids[canon] = vid
            self._vals.append(value)
        return vid

    def key(self, kid: int) -> str:
        return self._keys[kid]

    def val(self, vid: int) -> Any:
        return self._vals[vid]

    def snapshot(self) -> dict:
        return {"keys": list(self._keys), "vals": list(self._vals)}

    @classmethod
    def load(cls, snap: dict) -> "PropTable":
        t = cls()
        for k in snap["keys"]:
            t.intern_key(k)
        for v in snap["vals"]:
            t.intern_val(v)
        return t


@dataclass
class DocState:
    """D documents: every tensor has the doc dimension first."""

    length: torch.Tensor  # [D, S] int32
    text_start: torch.Tensor  # [D, S] int32
    flags: torch.Tensor  # [D, S] int32 (bit 0: marker)
    ins_seq: torch.Tensor  # [D, S] int32
    ins_client: torch.Tensor  # [D, S] int32
    rem_seq: torch.Tensor  # [D, S] int32
    rem_client_a: torch.Tensor  # [D, S] int32
    rem_client_b: torch.Tensor  # [D, S] int32
    prop_key: torch.Tensor  # [D, S, P] int32 (NO_KEY = empty)
    prop_val: torch.Tensor  # [D, S, P] int32
    count: torch.Tensor  # [D] int32
    overflow: torch.Tensor  # [D] bool

    @property
    def num_docs(self) -> int:
        return self.length.shape[0]

    @property
    def max_slots(self) -> int:
        return self.length.shape[-1]

    @property
    def max_props(self) -> int:
        return self.prop_key.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.length.device

    @classmethod
    def empty(cls, num_docs: int, max_slots: int,
              max_props: int = DEFAULT_MAX_PROPS,
              device: Union[str, torch.device] = "cuda") -> "DocState":
        D, S, P = num_docs, max_slots, max_props

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.int32, device=device)

        return cls(
            length=full((D, S), 0),
            text_start=full((D, S), 0),
            flags=full((D, S), 0),
            ins_seq=full((D, S), 0),
            ins_client=full((D, S), NO_CLIENT),
            rem_seq=full((D, S), NO_SEQ),
            rem_client_a=full((D, S), NO_CLIENT),
            rem_client_b=full((D, S), NO_CLIENT),
            prop_key=full((D, S, P), NO_KEY),
            prop_val=full((D, S, P), 0),
            count=full((D,), 0),
            overflow=torch.zeros((D,), dtype=torch.bool, device=device),
        )

    def to(self, device: Union[str, torch.device]) -> "DocState":
        return DocState(**{f: getattr(self, f).to(device) for f in FIELDS})

    def rows(self, index) -> "DocState":
        """The docs selected by ``index`` along the doc dimension."""
        return DocState(**{f: getattr(self, f)[index] for f in FIELDS})


def state_from_numpy(arrays: dict, device: Union[str, torch.device]
                     ) -> DocState:
    """A ``DocState`` from numpy arrays named like its fields (the JAX
    package's ``DocState`` arrays through ``np.asarray``). A single doc
    (no leading dimension) gains a doc dimension of 1."""
    if arrays["length"].ndim == 1:
        arrays = {f: np.asarray(a)[None] for f, a in arrays.items()}
    out = {}
    for f in FIELDS:
        dtype = np.bool_ if f == "overflow" else np.int32
        out[f] = torch.from_numpy(np.array(arrays[f], dtype=dtype)).to(device)
    return DocState(**out)


def state_to_numpy(state: DocState) -> dict:
    """The inverse of ``state_from_numpy``: numpy arrays by field name."""
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


class TextArena:
    """Host-side append-only text store; the device sees only offsets."""

    def __init__(self):
        self._chunks: list[str] = []
        self._len = 0

    def append(self, text: str) -> int:
        start = self._len
        self._chunks.append(text)
        self._len += len(text)
        return start

    def text(self) -> str:
        if len(self._chunks) > 1:
            self._chunks = ["".join(self._chunks)]
        return self._chunks[0] if self._chunks else ""

    def slice(self, start: int, length: int) -> str:
        return self.text()[start : start + length]


def encode_tree(
    tree: MergeTree,
    arena: TextArena,
    max_slots: int,
    max_props: int = DEFAULT_MAX_PROPS,
    prop_table: Optional[PropTable] = None,
    device: Union[str, torch.device] = "cuda",
) -> DocState:
    """Encode a (fully-acked) oracle MergeTree into a one-doc DocState.

    Segment properties require a ``prop_table`` to intern into (omitted ⇒
    props raise)."""
    n = len(tree.segments)
    if n > max_slots:
        raise ValueError(f"{n} segments exceed {max_slots} slots")
    S, P = max_slots, max_props
    a = {f: np.zeros(S, np.int32) for f in SLOT_FIELDS}
    for f in ("ins_client", "rem_client_a", "rem_client_b"):
        a[f].fill(NO_CLIENT)
    a["rem_seq"].fill(NO_SEQ)
    a["prop_key"] = np.full((S, P), NO_KEY, np.int32)
    a["prop_val"] = np.zeros((S, P), np.int32)
    overflow = False
    for i, seg in enumerate(tree.segments):
        if seg.is_pending():
            raise ValueError("cannot encode pending local state")
        a["length"][i] = seg.length
        if seg.is_marker:
            # a 1-char placeholder keeps arena offsets consistent; the
            # flag, not the byte, marks it as a marker
            a["text_start"][i] = arena.append("￼")
            a["flags"][i] |= FLAG_MARKER
        else:
            a["text_start"][i] = arena.append(seg.text)
        a["ins_seq"][i] = seg.ins_seq
        a["ins_client"][i] = seg.ins_client
        if seg.rem_seq is not None:
            a["rem_seq"][i] = seg.rem_seq
            removers = sorted(seg.rem_clients)
            a["rem_client_a"][i] = removers[0]
            if len(removers) > 1:
                a["rem_client_b"][i] = removers[1]
            if len(removers) > 2:
                overflow = True
        if seg.props:
            if prop_table is None:
                raise ValueError("segment has props but no prop_table given")
            items = list(seg.props.items())
            if len(items) > P:
                overflow = True
                items = items[:P]
            for p, (k, v) in enumerate(items):
                a["prop_key"][i, p] = prop_table.intern_key(k)
                a["prop_val"][i, p] = prop_table.intern_val(v)
    a["count"] = np.asarray(n, np.int32)
    a["overflow"] = np.asarray(overflow)
    return state_from_numpy(a, device)


def decode_state(
    state: DocState,
    arena: TextArena,
    prop_table: Optional[PropTable] = None,
    doc: int = 0,
) -> MergeTree:
    """Decode doc ``doc`` of ``state`` back into an oracle MergeTree (for
    comparison, summaries and host escalation)."""
    a = {f: v[0] for f, v in
         state_to_numpy(state.rows(slice(doc, doc + 1))).items()}
    tree = MergeTree()
    prop_key, prop_val = a["prop_key"], a["prop_val"]
    for i in range(int(a["count"])):
        is_marker = bool(a["flags"][i] & FLAG_MARKER)
        text = "" if is_marker else arena.slice(int(a["text_start"][i]),
                                                 int(a["length"][i]))
        props = {}
        for p in range(prop_key.shape[1]):
            if prop_key[i, p] != NO_KEY:
                if prop_table is None:
                    raise ValueError("state has props but no prop_table given")
                props[prop_table.key(int(prop_key[i, p]))] = prop_table.val(
                    int(prop_val[i, p]))
        seg = Segment(
            text=text,
            marker={"refType": 1} if is_marker else None,
            props=props,
            ins_seq=int(a["ins_seq"][i]),
            ins_client=int(a["ins_client"][i]),
        )
        if a["rem_seq"][i] != NO_SEQ:
            seg.rem_seq = int(a["rem_seq"][i])
            seg.rem_client = int(a["rem_client_a"][i])
            seg.rem_clients = {int(a["rem_client_a"][i])}
            if a["rem_client_b"][i] != NO_CLIENT:
                seg.rem_clients.add(int(a["rem_client_b"][i]))
        tree.segments.append(seg)
    return tree


#: fill of an unused slot, field by field (``DocState.empty``)
SLOT_FILL = {"length": 0, "text_start": 0, "flags": 0, "ins_seq": 0,
             "ins_client": NO_CLIENT, "rem_seq": NO_SEQ,
             "rem_client_a": NO_CLIENT, "rem_client_b": NO_CLIENT,
             "prop_key": NO_KEY, "prop_val": 0}


def merge_settled_runs(rows: dict, msn: np.ndarray) -> dict:
    """Zamboni's merge of neighbours on R docs' rows, in numpy.

    ``rows`` holds the slot fields as [R, W] arrays (``prop_key`` and
    ``prop_val`` [R, W, P]) and ``count`` [R]; ``msn`` [R] is each doc's
    collaboration-window floor. Two adjacent used slots merge when both
    are settled — inserted at or below the msn, never removed, not a
    marker — and their property tables hold the same (key, value) pairs
    in any order: ``segments.py::can_append`` under
    ``MergeTree.update_min_seq`` (ref: mergeTree.ts:1455). A run of such
    slots becomes its first slot with the run's summed length, so it keeps
    that slot's ``ins_seq``, ``ins_client`` and properties, as
    ``Segment.append`` does. Every later op has a refSeq at or above the
    msn, so it sees each piece of a run exactly as it sees the whole.

    Returns the merged rows: the same shapes, unused slots at
    ``SLOT_FILL``, ``text_start`` left for the caller, who rebuilds the
    text."""
    count = rows["count"]
    R, W = rows["length"].shape
    i = np.arange(W)
    in_use = i[None, :] < count[:, None]
    settled = (in_use & (rows["flags"] & FLAG_MARKER == 0)
               & (rows["rem_seq"] == NO_SEQ)
               & (rows["ins_seq"] <= msn[:, None]))
    # property tables as sorted (key, value) pairs, over the entries any
    # slot uses: equal dicts compare equal whatever entries they sit in
    used = np.nonzero((rows["prop_key"] != NO_KEY).any(axis=(0, 1)))[0]
    same = settled[:, 1:] & settled[:, :-1]
    if len(used):
        keys = rows["prop_key"][..., :used[-1] + 1]
        vals = rows["prop_val"][..., :used[-1] + 1]
        empty = keys == NO_KEY
        keys = np.where(empty, np.iinfo(np.int32).max, keys)
        vals = np.where(empty, 0, vals)
        if keys.shape[-1] > 1:
            order = np.argsort(keys, axis=-1, kind="stable")
            keys = np.take_along_axis(keys, order, -1)
            vals = np.take_along_axis(vals, order, -1)
        same &= ((keys[:, 1:] == keys[:, :-1]).all(-1)
                 & (vals[:, 1:] == vals[:, :-1]).all(-1))
    join = np.zeros((R, W), bool)
    join[:, 1:] = same
    head = in_use & ~join
    new_count = head.sum(1).astype(np.int32)
    # the heads in row-major order, each with its new slot's flat index
    src = np.flatnonzero(head)
    rank = np.cumsum(head, axis=1) - 1
    dest = (src // W) * W + rank.ravel()[src]
    # a run's length: the used lengths from its head to the next head
    lengths = np.cumsum(np.where(in_use, rows["length"], 0).ravel())
    ends = np.append(src[1:], R * W) - 1
    before = np.where(src > 0, lengths[src - 1], 0)
    merged = {}
    length = np.zeros(R * W, np.int32)
    length[dest] = lengths[ends] - before
    merged["length"] = length.reshape(R, W)
    for f in ("text_start", "flags", "ins_seq", "ins_client", "rem_seq",
              "rem_client_a", "rem_client_b", "prop_key", "prop_val"):
        field = rows[f]
        flat = field.reshape(R * W, -1)
        out = np.full(flat.shape, SLOT_FILL[f], np.int32)
        out[dest] = flat[src]
        merged[f] = out.reshape(field.shape)
    merged["count"] = new_count
    return merged
