"""Sequenced-op stream generator for benchmarks and load tests.

Generates valid server-side op streams (seq strictly increasing, ref_seq =
previous seq, positions within the tracked visible length) without running
the oracle — the analytic twin of the reference's load generator
(packages/test/service-load-test/src/nodeStressTest.ts). Because every op's
ref_seq sees all prior ops, the visible length after each op is exact:
+text_len on insert, -(end-start) on remove, unchanged on annotate.

Each op carries an msn that trails its seq by ``msn_lag`` (deli's
collaboration-window floor), driving device zamboni in the benched step.

JAX counterpart: ``fluidframework_tpu/ops/opgen.py``, copied unchanged with its imports
rebased onto this package.
"""

from __future__ import annotations

import numpy as np

from .apply import OP_ANNOTATE, OP_FIELDS, OP_INSERT, OP_NOOP, OP_REMOVE, make_op


def generate_doc_ops(
    rng: np.random.Generator,
    n_ops: int,
    start_seq: int = 0,
    start_len: int = 0,
    n_clients: int = 4,
    remove_fraction: float = 0.3,
    annotate_fraction: float = 0.0,
    max_insert: int = 16,
    arena_base: int = 0,
    msn_lag: int = 16,
    n_prop_keys: int = 4,
    n_prop_vals: int = 8,
) -> tuple[np.ndarray, int, int]:
    """Return (ops[n_ops, OP_FIELDS], end_len, arena_used)."""
    ops = np.zeros((n_ops, OP_FIELDS), np.int32)
    length = start_len
    arena = arena_base
    seq = start_seq
    for k in range(n_ops):
        seq += 1
        msn = max(0, seq - msn_lag)
        client = int(rng.integers(0, n_clients))
        r = rng.random()
        do_remove = length > 4 and r < remove_fraction
        do_annotate = (
            not do_remove and length > 1 and r < remove_fraction + annotate_fraction
        )
        if do_remove:
            start = int(rng.integers(0, length - 1))
            end = int(rng.integers(start + 1, min(length, start + max_insert) + 1))
            ops[k] = make_op(
                OP_REMOVE, pos=start, end=end, seq=seq, ref_seq=seq - 1,
                client=client, msn=msn,
            )
            length -= end - start
        elif do_annotate:
            start = int(rng.integers(0, length - 1))
            end = int(rng.integers(start + 1, min(length, start + max_insert) + 1))
            ops[k] = make_op(
                OP_ANNOTATE, pos=start, end=end, seq=seq, ref_seq=seq - 1,
                client=client, msn=msn,
                key=int(rng.integers(0, n_prop_keys)),
                val=int(rng.integers(0, n_prop_vals)),
            )
        else:
            tlen = int(rng.integers(1, max_insert + 1))
            pos = int(rng.integers(0, length + 1))
            ops[k] = make_op(
                OP_INSERT,
                pos=pos,
                seq=seq,
                ref_seq=seq - 1,
                client=client,
                text_len=tlen,
                text_start=arena,
                msn=msn,
            )
            arena += tlen
            length += tlen
    return ops, length, arena - arena_base


def generate_batch_ops(
    rng: np.random.Generator,
    n_docs: int,
    ops_per_doc: int,
    **kw,
) -> np.ndarray:
    """[n_docs, ops_per_doc, OP_FIELDS] independent valid streams."""
    out = np.zeros((n_docs, ops_per_doc, OP_FIELDS), np.int32)
    for d in range(n_docs):
        out[d], _, _ = generate_doc_ops(rng, ops_per_doc, **kw)
    return out
