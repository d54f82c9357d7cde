"""Plain reference of the replica farm: a merge-tree segment list in Python.

This is the yardstick that decides ``correct`` for every cell whose
configuration names ``"reference": "mergetree"``. It imports nothing but
the standard library: no torch, no numpy, nothing of the program.

It applies a document's sequenced merge-tree ops, in sequence order, the
way a server-side replica does:

- each op is resolved at its own perspective: a segment is seen when the
  op's client inserted it or its insert seq is at or below the op's
  refSeq, and hidden when it was removed by the op's client or at or
  below the refSeq;
- an insert at a position strictly inside a seen segment splits it;
  otherwise it goes before the first segment whose seen prefix reaches
  the position (the earliest boundary);
- a remove or annotate splits at both ends and then touches every seen
  segment wholly inside the range: a remove keeps the earliest remove
  seq and adds the client to the segment's removers; an annotate writes
  each key (a value of None deletes it), the last write winning;
- at the op's minimum sequence number (msn) the list is compacted:
  segments removed at or below it are dropped, and neighbours settled
  below it with equal properties are merged. No later op can see either
  difference, so the text and its properties are what they would be
  without it.

The result of a document is its rich text: the visible text cut into runs
of equal properties, ``[(text, ((key, value), ...)), ...]``.
"""

from __future__ import annotations

# segment fields (a segment is a list, for speed)
TEXT, INS_SEQ, INS_CLIENT, REM_SEQ, REMOVERS, PROPS = range(6)

INSERT, REMOVE, ANNOTATE = 0, 1, 2  # wire op kinds

#: compaction runs at most once every this many ops
COMPACT_EVERY = 32


class Doc:
    """One document's segment list."""

    def __init__(self):
        self.segs: list = []
        self.seq = 0
        self._since_compact = 0

    # -- ops ---------------------------------------------------------------

    def apply(self, kind: int, a: int, b: int, text: str, props,
              seq: int, ref: int, client, msn: int) -> None:
        """Apply one sequenced op. Raises ValueError on an op that no
        replica could apply (a position past the seen text)."""
        if seq <= self.seq:
            raise ValueError(f"seq {seq} after {self.seq}: not in order")
        self.seq = seq
        segs = self.segs
        # what the op's perspective sees, and each segment's length
        seen = [(s[INS_CLIENT] == client or s[INS_SEQ] <= ref)
                and (s[REM_SEQ] is None
                     or (s[REM_SEQ] > ref and client not in s[REMOVERS]))
                for s in segs]
        lens = [len(s[TEXT]) for s in segs]
        total = sum(n for n, v in zip(lens, seen) if v)
        if kind == INSERT:
            if not text or a > total:
                raise ValueError(f"insert at {a} of {total} (seq {seq})")
            self._split(segs, seen, lens, a)
            cum = 0
            at = len(segs)
            for i, (n, v) in enumerate(zip(lens, seen)):
                if cum >= a:
                    at = i
                    break
                if v:
                    cum += n
            segs.insert(at, [text, seq, client, None, set(), {}])
        elif kind in (REMOVE, ANNOTATE):
            if b > total or b <= a:
                raise ValueError(f"range [{a}, {b}) of {total} (seq {seq})")
            self._split(segs, seen, lens, a)
            self._split(segs, seen, lens, b)
            cum = 0
            for s, n, v in zip(segs, lens, seen):
                if not v:
                    continue
                if cum >= a:
                    if cum + n > b:
                        break
                    if kind == REMOVE:
                        if s[REM_SEQ] is None:
                            s[REM_SEQ] = seq
                        s[REMOVERS].add(client)
                    else:
                        for k, val in props.items():
                            if val is None:
                                s[PROPS].pop(k, None)
                            else:
                                s[PROPS][k] = val
                cum += n
        else:
            raise ValueError(f"op kind {kind}")
        self._since_compact += 1
        if self._since_compact >= COMPACT_EVERY:
            self.compact(msn)

    @staticmethod
    def _split(segs: list, seen: list, lens: list, pos: int) -> None:
        """Split the seen segment that holds ``pos`` strictly inside,
        keeping ``seen`` and ``lens`` in step."""
        cum = 0
        for i, (n, v) in enumerate(zip(lens, seen)):
            if not v:
                continue
            if cum + n > pos:
                if cum < pos:
                    k = pos - cum
                    seg = segs[i]
                    tail = [seg[TEXT][k:], seg[INS_SEQ], seg[INS_CLIENT],
                            seg[REM_SEQ], set(seg[REMOVERS]),
                            dict(seg[PROPS])]
                    seg[TEXT] = seg[TEXT][:k]
                    segs.insert(i + 1, tail)
                    seen.insert(i + 1, True)
                    lens[i] = k
                    lens.insert(i + 1, n - k)
                return
            cum += n

    def compact(self, msn: int) -> None:
        """Drop segments removed at or below ``msn``; merge settled
        neighbours with equal properties."""
        self._since_compact = 0
        out: list = []
        for seg in self.segs:
            if seg[REM_SEQ] is not None and seg[REM_SEQ] <= msn:
                continue
            if out:
                last = out[-1]
                if (last[REM_SEQ] is None and seg[REM_SEQ] is None
                        and last[INS_SEQ] <= msn and seg[INS_SEQ] <= msn
                        and last[PROPS] == seg[PROPS]):
                    last[TEXT] += seg[TEXT]
                    last[INS_SEQ] = max(last[INS_SEQ], seg[INS_SEQ])
                    continue
            out.append(seg)
        self.segs = out

    # -- result ------------------------------------------------------------

    def rich_text(self) -> list:
        """The visible text as runs of equal properties."""
        return rich_runs((s[TEXT], s[PROPS]) for s in self.segs
                         if s[REM_SEQ] is None)


def rich_runs(pieces) -> list:
    """``[(text, props dict)]`` pieces in order → runs of equal
    properties, ``[(text, sorted (key, value) tuple)]``, empty pieces
    left out. Both sides of a comparison go through this."""
    runs: list = []
    for text, props in pieces:
        if not text:
            continue
        key = tuple(sorted(props.items()))
        if runs and runs[-1][1] == key:
            runs[-1] = (runs[-1][0] + text, key)
        else:
            runs.append((text, key))
    return runs


def replay(ops) -> list:
    """Rich text after ``ops``: an iterable of
    ``(kind, a, b, text, props, seq, ref, client, msn)`` in seq order."""
    doc = Doc()
    for op in ops:
        doc.apply(*op)
    return doc.rich_text()
