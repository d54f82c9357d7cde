"""Pieces the drivers share: host spans, the seeded sample of docs to
compare, and the comparison of the farm's docs with the reference."""

from __future__ import annotations

import time
from array import array

import numpy as np

from ..reference.mergetree import replay
from .streams import farm_rich_text, first_difference


class Spans:
    """The harness's host spans, by label, as two arrays of
    ``perf_counter`` stamps. Off (``enabled=False``) it records nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._s: dict = {}

    def add(self, label: str, start: float, end: float) -> None:
        pair = self._s.get(label)
        if pair is None:
            pair = self._s[label] = (array("d"), array("d"))
        pair[0].append(start)
        pair[1].append(end)

    def wrap(self, label: str, fn):
        """``fn`` with a span around each call (``fn`` itself when off)."""
        if not self.enabled:
            return fn
        add, clock = self.add, time.perf_counter

        def timed(*args):
            t = clock()
            try:
                return fn(*args)
            finally:
                add(label, t, clock())
        return timed

    def arrays(self) -> dict:
        return {k: (np.frombuffer(s, np.float64), np.frombuffer(e, np.float64))
                for k, (s, e) in self._s.items()}

    def total(self, label: str) -> float:
        pair = self._s.get(label)
        if pair is None:
            return 0.0
        return float(np.sum(np.frombuffer(pair[1], np.float64)
                            - np.frombuffer(pair[0], np.float64)))


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use (``stream``) of a run's seed; any
    whole number, negative or past 64 bits, is a seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


def sample_docs(sizes: dict, n: int, rng: np.random.Generator) -> list:
    """``n`` docs drawn from ``rng``, the largest by ``sizes`` among them."""
    names = sorted(sizes)
    if not names:
        return []
    largest = max(names, key=lambda d: (sizes[d], d))
    rest = [d for d in names if d != largest]
    picked = rng.choice(len(rest), size=min(n - 1, len(rest)),
                        replace=False) if rest and n > 1 else []
    return [largest] + [rest[int(i)] for i in picked]


def compare_docs(farm_texts: dict, streams: dict) -> tuple:
    """(docs whose farm rich text differs from the reference's replay of
    their stream, a note on the first). A doc whose stream the reference
    refuses (an op out of order or past the text) differs."""
    bad, first = 0, ""
    for doc, got in farm_texts.items():
        try:
            want = replay(streams[doc])
        except ValueError as exc:
            bad += 1
            first = first or f"{doc}: the reference refused its stream: {exc}"
            continue
        if got != want:
            bad += 1
            first = first or f"{doc}: {first_difference(want, got)}"
    return bad, first


def farm_texts(applier, tenant: str, docs: list) -> dict:
    """Each doc's rich text as the farm serves it."""
    return {d: farm_rich_text(applier.get_tree(tenant, d)) for d in docs}
