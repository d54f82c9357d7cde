"""The synthetic SharedString editor that makes the service cells' ops.

A frozen copy of the program's ``service/synthetic.py::SyntheticEditor``
(its array-lane half: ``next_boxcar``, ``observe`` and ``observe_abatch``),
kept here so that a change to the program cannot change the traffic it is
measured on. The op mix (remove, annotate, longest insert) comes from the
cell's traffic file. Boxcars are the program's ``ArrayBoxcar``, its input
type, handed in by the caller.

Ref: packages/test/service-load-test/src/nodeStressTest.ts (the
reference's synthetic client op source).
"""

from __future__ import annotations

import numpy as np

DS_ID = "default"
CHANNEL_ID = "text"
OPERATION = "op"  # MessageType.OPERATION's wire value

_TEXT_POOL = "abcdefgh" * 4  # payload source: slicing beats per-char joins


class SyntheticEditor:
    """One synthetic client's op source for one document.

    ``length`` is a lower bound on the visible length of this client's
    perspective, tracked from the broadcast stream, so every position it
    draws is one a replica can resolve."""

    __slots__ = ("rng", "length", "remove_fraction", "annotate_fraction",
                 "max_insert", "client_seq", "ref_seq", "boxcar_type")

    def __init__(self, rng, boxcar_type, remove_fraction: float,
                 annotate_fraction: float, max_insert: int):
        self.rng = rng
        self.boxcar_type = boxcar_type
        self.length = 0
        self.remove_fraction = remove_fraction
        self.annotate_fraction = annotate_fraction
        self.max_insert = max_insert
        self.client_seq = 0
        self.ref_seq = 0

    def observe(self, msg) -> None:
        """Track a broadcast sequenced message (anyone's, own included)."""
        self.ref_seq = msg.sequence_number
        if msg.type != OPERATION:
            return
        env = msg.contents
        if type(env) is not dict or env.get("kind") != "chanop":
            return
        op = env["contents"]["contents"]
        t = op["type"]
        if t == 0:
            self.length += len(op.get("text") or "x")
        elif t == 1:
            self.length = max(0, self.length - (op["end"] - op["start"]))

    def observe_abatch(self, batch) -> None:
        """Track another client's sequenced array batch."""
        self.ref_seq = batch.last_seq
        box = batch.boxcar
        ins = int(box.text_off[-1])
        rem = int(((box.b - box.a) * (box.kind == 1)).sum())
        self.length = max(0, self.length + ins - rem)

    def next_boxcar(self, count: int, tenant: str = "", doc: str = "",
                    client_id: str = ""):
        """One outbound boxcar of ``count`` ops as an ``ArrayBoxcar``."""
        kind: list = []
        a: list = []
        b: list = []
        text_off: list = [0]
        texts: list = []
        props = None
        rnd = self.rng.random
        rm, ann, mi = (self.remove_fraction, self.annotate_fraction,
                       self.max_insert)
        length = self.length
        off = 0
        for i in range(count):
            r = rnd()
            if length > 4 and r < rm:
                x = int(rnd() * (length - 1))
                y = x + 1 + int(rnd() * min(length - x - 1, mi - 1))
                kind.append(1)
                a.append(x)
                b.append(y)
                length -= y - x
            elif length > 1 and r < rm + ann:
                x = int(rnd() * (length - 1))
                y = x + 1 + int(rnd() * min(length - x - 1, mi - 1))
                kind.append(2)
                a.append(x)
                b.append(y)
                if props is None:
                    props = [None] * count
                props[i] = {"k": int(rnd() * 4)}
            else:
                n = 1 + int(rnd() * mi)
                o = int(rnd() * 8)
                kind.append(0)
                a.append(int(rnd() * (length + 1)))
                b.append(0)
                texts.append(_TEXT_POOL[o:o + n])
                off += n
                length += n
            text_off.append(off)
        base = self.client_seq
        self.client_seq = base + count
        self.length = length
        return self.boxcar_type(
            tenant_id=tenant, document_id=doc, client_id=client_id,
            ds_id=DS_ID, channel_id=CHANNEL_ID,
            kind=np.asarray(kind, np.int8),
            a=np.asarray(a, np.int32), b=np.asarray(b, np.int32),
            cseq=np.arange(base + 1, base + count + 1, dtype=np.int32),
            rseq=np.full(count, self.ref_seq, np.int32),
            text="".join(texts),
            text_off=np.asarray(text_off, np.int32), props=props)
