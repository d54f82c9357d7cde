"""Synthetic SharedString editor for load generation — import-light.

JAX counterpart: ``fluidframework_tpu/service/synthetic.py``; the port's copy,
imports rebased to this package.

Kept apart from load_gen.py so load workers import only the protocol
layer, not LocalServer and the stack behind it.

Ref: packages/test/service-load-test/src/nodeStressTest.ts (the
reference's synthetic client op source).
"""

from __future__ import annotations

import random

from ..protocol.messages import DocumentMessage, MessageType

DS_ID = "default"
CHANNEL_ID = "text"

_TEXT_POOL = "abcdefgh" * 4  # payload source: slicing beats per-char joins


class SyntheticEditor:
    """One synthetic client's op source for one document.

    Generation is deliberately cheap (single ``random()`` draws scaled to
    ranges, pooled payload text): at the north-star rate the generator
    runs inside the measured loop, so its cost is part of the headline.
    """

    def __init__(self, rng: random.Random, remove_fraction: float = 0.3,
                 annotate_fraction: float = 0.05, max_insert: int = 8):
        self.rng = rng
        self.length = 0  # lower bound on this perspective's visible length
        self.remove_fraction = remove_fraction
        self.annotate_fraction = annotate_fraction
        self.max_insert = max_insert
        self.client_seq = 0
        self.ref_seq = 0

    def observe(self, msg) -> None:
        """Track a broadcast sequenced message (anyone's, including own)."""
        self.ref_seq = msg.sequence_number
        if msg.type != MessageType.OPERATION:
            return
        env = msg.contents
        if type(env) is not dict or env.get("kind") != "chanop":
            return
        op = env["contents"]["contents"]
        self._track(op)

    def _track(self, op: dict) -> None:
        t = op["type"]
        if t == 0:
            self.length += len(op.get("text") or "￼")
        elif t == 1:
            self.length -= op["end"] - op["start"]
            if self.length < 0:
                self.length = 0

    def next_ops(self, count: int) -> list[DocumentMessage]:
        """Generate a submission batch (one outbound boxcar)."""
        rnd = self.rng.random
        rm, ann, mi = self.remove_fraction, self.annotate_fraction, self.max_insert
        ref_seq = self.ref_seq
        cseq = self.client_seq
        out = []
        for _ in range(count):
            r = rnd()
            length = self.length
            if length > 4 and r < rm:
                a = int(rnd() * (length - 1))
                b = a + 1 + int(rnd() * min(length - a - 1, mi - 1))
                op = {"type": 1, "start": a, "end": b}
                self.length = length - (b - a)
            elif length > 1 and r < rm + ann:
                a = int(rnd() * (length - 1))
                b = a + 1 + int(rnd() * min(length - a - 1, mi - 1))
                op = {"type": 2, "start": a, "end": b,
                      "props": {"k": int(rnd() * 4)}}
            else:
                n = 1 + int(rnd() * mi)
                off = int(rnd() * 8)
                op = {"type": 0, "pos": int(rnd() * (length + 1)),
                      "text": _TEXT_POOL[off:off + n]}
                self.length = length + n
            cseq += 1
            out.append(DocumentMessage(
                client_sequence_number=cseq,
                reference_sequence_number=ref_seq,
                type=MessageType.OPERATION,
                contents={"kind": "chanop", "address": DS_ID,
                          "contents": {"address": CHANNEL_ID, "contents": op}},
            ))
        self.client_seq = cseq
        return out

    def next_op(self) -> DocumentMessage:
        return self.next_ops(1)[0]

    def next_boxcar(self, count: int, tenant: str = "", doc: str = "",
                    client_id: str = ""):
        """Generate a submission batch as an ArrayBoxcar (the deli-tpu
        marshal lane): int arrays + one text blob, no per-op dicts. Same
        op mix and length-tracking contract as :meth:`next_ops`."""
        import numpy as np

        from .array_batch import ArrayBoxcar

        # build in python lists (numpy scalar writes cost ~5× a list
        # append), ONE array conversion per field at the end
        kind: list[int] = []
        a: list[int] = []
        b: list[int] = []
        text_off: list[int] = [0]
        texts: list[str] = []
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
        return ArrayBoxcar(
            tenant_id=tenant, document_id=doc, client_id=client_id,
            ds_id=DS_ID, channel_id=CHANNEL_ID,
            kind=np.asarray(kind, np.int8),
            a=np.asarray(a, np.int32), b=np.asarray(b, np.int32),
            cseq=np.arange(base + 1, base + count + 1, dtype=np.int32),
            rseq=np.full(count, self.ref_seq, np.int32),
            text="".join(texts),
            text_off=np.asarray(text_off, np.int32), props=props)

    def observe_abatch(self, batch) -> None:
        """Track another client's sequenced array batch (vectorized
        length deltas — the array-lane analog of :meth:`observe`)."""
        self.ref_seq = batch.last_seq
        box = batch.boxcar
        ins = int(box.text_off[-1])
        rem = int(((box.b - box.a) * (box.kind == 1)).sum())
        self.length = max(0, self.length + ins - rem)
