"""A/B timing of the apply kernel on one card.

    python3 -m fluidframework_tpu_torch.tools.apply_ab [--baseline OLD.cu]

Builds ``csrc/apply.cu`` and, with ``--baseline``, a second library from
another source of the kernel that has the earlier entry point
``ff_apply_ops_batch(25 pointers, D, S, P, K, stream)`` (for example an
earlier commit's ``csrc/apply.cu``, unpacked with ``git show``). On the
shapes of ``chip_smoke.py``'s first two kernel cases (the second wave of a
seeded opgen stream, applied to the state the first wave left), it holds
each library exactly against the plain version, then times them in turns
(baseline, kernel, kernel, baseline) by CUDA events, and the kernel at 1
and 2 docs per CTA beside its default. Prints one JSON line per shape and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import cuda_apply
from ..ops.apply import apply_ops_batch_ref, compact_batch, wave_min_seq
from ..ops.doc_state import FIELDS, DocState
from ..ops.opgen import generate_batch_ops

# chip_smoke.py's BENCH_MIX and its first two kernel cases
MIX = dict(remove_fraction=0.4, annotate_fraction=0.1, max_insert=8)
SHAPES = ((42, 1024, 256, 32), (42, 8192, 256, 64))


def cuda_ms(fn, reps: int, warmup: int = 2, queue: bool = True,
            sleep_cycles: int = 40_000_000) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events.
    With ``queue``, the stream first sleeps on the card (``sleep_cycles``,
    ~20 ms by default) while the host enqueues every run, so that host
    time between launches does not count as device time: the sleep must
    outlast the enqueue, and the runs' launches must fit the launch
    queue."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue:
        torch.cuda._sleep(sleep_cycles)  # 40M cycles: ~20 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def make_case(seed: int, D: int, S: int, K: int):
    rng = np.random.default_rng(seed)
    stream = generate_batch_ops(rng, D, 2 * K, **MIX)
    w1 = torch.from_numpy(stream[:, :K].copy()).cuda()
    w2 = torch.from_numpy(stream[:, K:].copy()).cuda()
    state = apply_ops_batch_ref(DocState.empty(D, S, device="cuda"), w1)
    return compact_batch(state, wave_min_seq(w1)), w2


def baseline_apply(source: str):
    """The apply of a kernel source with the earlier entry point."""
    lib = ctypes.CDLL(str(cuda_apply.build([source], "libff_apply_base")))
    fn = lib.ff_apply_ops_batch
    fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def apply(state: DocState, ops: torch.Tensor) -> DocState:
        out = DocState(**{f: torch.empty_like(getattr(state, f))
                          for f in FIELDS})
        err = fn(ops.data_ptr(),
                 *(getattr(state, f).data_ptr() for f in FIELDS),
                 *(getattr(out, f).data_ptr() for f in FIELDS),
                 state.num_docs, state.max_slots, state.max_props,
                 ops.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed ({err})")
        return out

    return apply


def exact(a: DocState, b: DocState) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="kernel source with the earlier "
                    "entry point")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("apply_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    base = baseline_apply(args.baseline) if args.baseline else None
    for seed, D, S, K in SHAPES:
        state, ops = make_case(seed, D, S, K)
        want = apply_ops_batch_ref(state, ops)
        spt, warps, docs, smem = cuda_apply.launch_geometry(S)
        variants = {n: (spt, warps, n, smem // docs * n)
                    for n in (1, 2, docs)} if warps == 1 else {docs: None}
        row = {"D": D, "S": S, "K": K, "card": card}
        for n, geo in variants.items():
            if not exact(cuda_apply.launch(state, ops, geo), want):
                raise SystemExit(f"kernel ({n} docs a CTA) differs")
        if base is not None and not exact(base(state, ops), want):
            raise SystemExit("baseline differs from the plain version")

        def kernel():
            return cuda_apply.launch(state, ops)

        order = ([base, kernel, kernel, base] if base is not None
                 else [kernel, kernel])
        times = [cuda_ms(lambda f=f: f(state, ops) if f is base else f(),
                         args.reps) for f in order]
        row["kernel_ms"] = [t for f, t in zip(order, times) if f is kernel]
        if base is not None:
            row["baseline_ms"] = [t for f, t in zip(order, times)
                                  if f is base]
        row["docs_per_cta_ms"] = {
            str(n): cuda_ms(lambda g=geo: cuda_apply.launch(state, ops, g),
                            args.reps)
            for n, geo in variants.items()}
        print(json.dumps(row), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
