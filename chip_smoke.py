"""Chip smoke of the PyTorch / CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``fluidframework_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds it exactly against its plain PyTorch
version on the card at the main path's shapes and on six more cases that
reach its other paths (S from 16 to 1024, overflow), then drives the
replica farm
(``GpuDocumentApplier`` at D=1024 docs, S=256 slots, K=32 ops per wave)
through its entry points and checks every doc's text, and finally drives
the service path: ``service/load_gen.run_inproc`` (clients → LocalServer →
deli → scriptorium, scribe, broadcaster) at 1024 docs × 2 clients × 48 ops
with the async, overlap-staged applier riding the broadcast, held against
a CPU applier, against itself with overlap off, and on the dict lane.
Each phase prints one JSON line; any failure exits nonzero. Before the last line it prints
the kernel table (``{"kernels": [...]}``) and the card's name and power
limit as ``nvidia-smi`` reports them; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

# the port's kernels, for the kernel table
REPLACES = {"apply_ops_batch": "fluidframework_tpu/ops/pallas_apply.py:355"}
SOURCES = {"apply_ops_batch": "fluidframework_tpu_torch/csrc/apply.cu"}

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): 3.35 TB/s of HBM;
# 67 TFLOP/s fp32 outside the tensor cores is 132 SMs x 128 lanes x 2 (an
# FMA) x 1.98 GHz, and an SM has 64 INT32 lanes at one op each, so the
# int32 rate is a quarter of it
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# int32 operations per slot for one real op, counted from the plain
# version's arithmetic: visibility 8, prefix sum 1, split tests 6, the
# nine block reductions 9, coverage 4, remove stamps 4
OPS_PER_SLOT = 32

BENCH_MIX = dict(remove_fraction=0.4, annotate_fraction=0.1, max_insert=8)
ANNOTATE_MIX = dict(remove_fraction=0.15, annotate_fraction=0.5, max_insert=4)
INSERT_MIX = dict(remove_fraction=0.0, annotate_fraction=0.1, max_insert=8)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def apply_bound(state, ops: torch.Tensor) -> tuple[float, str]:
    """Least time (ms) for the apply of ``ops`` to ``state``: each input
    and output byte moved once at the HBM rate, against the int32
    operations this wave's real ops need at the int32 rate."""
    from fluidframework_tpu_torch.ops.apply import OP_ANNOTATE, OP_INSERT
    from fluidframework_tpu_torch.ops.doc_state import FIELDS

    state_bytes = sum(getattr(state, f).numel() * getattr(state, f)
                      .element_size() for f in FIELDS)
    nbytes = 2 * state_bytes + ops.numel() * ops.element_size()
    S, P = state.max_slots, state.max_props
    typ = ops[..., 0]
    n_real = int((typ != 0).sum())
    n_ins = int((typ == OP_INSERT).sum())
    n_ann = int((typ == OP_ANNOTATE).sum())
    # an insert also shifts every field (8 + 2P) once; an annotate also
    # matches and writes its slot's P-entry prop table (2P)
    n_ops = S * (n_real * OPS_PER_SLOT + n_ins * (8 + 2 * P)
                 + n_ann * 2 * P)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_abs_err(a, b) -> int:
    from fluidframework_tpu_torch.ops.doc_state import FIELDS

    return max(int((getattr(a, f).to(torch.int64)
                    - getattr(b, f).to(torch.int64)).abs().max())
               for f in FIELDS)


def phase_kernel(name, seed, D, S, K, mix, expect_overflow):
    """The kernel against its plain version on one opgen stream: a first
    wave from empty docs, then a second wave on the state the first left
    (after zamboni). Every field must match exactly."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.ops.apply import (
        apply_ops_batch_ref,
        compact_batch,
        unpack_wave16,
        wave_min_seq,
    )
    from fluidframework_tpu_torch.ops.doc_state import DocState
    from fluidframework_tpu_torch.ops.opgen import generate_batch_ops
    from fluidframework_tpu_torch.tools.apply_ab import cuda_ms

    rng = np.random.default_rng(seed)
    stream = generate_batch_ops(rng, D, 2 * K, **mix)
    w1 = torch.from_numpy(stream[:, :K].copy()).cuda()
    w2 = torch.from_numpy(stream[:, K:].copy()).cuda()
    state = DocState.empty(D, S, device="cuda")
    err = 0
    for wave in (w1, w2):
        state_in = state
        got = cuda_apply.apply_ops_batch(state_in, wave)
        want = apply_ops_batch_ref(state_in, wave)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got, want))
        if err:
            fail(f"{name}: kernel differs from its plain version by {err}")
        state = compact_batch(want, wave_min_seq(wave))
    overflow = int(want.overflow.sum())
    if expect_overflow and not overflow:
        fail(f"{name}: the stream was meant to overflow")
    if not expect_overflow and overflow:
        fail(f"{name}: {overflow} docs overflowed and would skip work")
    # timed on the second wave, whose input state holds segments
    ms = cuda_ms(lambda: cuda_apply.apply_ops_batch(state_in, w2), reps=20)
    plain_ms = cuda_ms(lambda: apply_ops_batch_ref(state_in, w2), reps=3,
                       queue=False,
                       warmup=1)
    bound_ms, bound_by = apply_bound(state_in, w2)
    # the other two stages of the applier's device step, on this wave
    wave16, bases = w2.to(torch.int16), torch.zeros((D, 2), dtype=torch.int32,
                                                    device="cuda")
    unpack_ms = cuda_ms(lambda: unpack_wave16(wave16, bases), reps=20)
    compact_ms = cuda_ms(lambda: compact_batch(want, wave_min_seq(w2)),
                         reps=20)
    row = {"phase": "kernel", "case": name, "D": D, "S": S, "K": K,
           "max_abs_err": err, "overflow_docs": overflow, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "unpack_ms": unpack_ms,
           "compact_ms": compact_ms}
    emit(row)
    return row


def make_opgen_docs(n_docs: int, n_ops: int, seed: int):
    from fluidframework_tpu_torch.ops.opgen import generate_doc_ops

    rng = np.random.default_rng(seed)
    return [generate_doc_ops(rng, n_ops, **BENCH_MIX)[0]
            for _ in range(n_docs)]


def opgen_feeds(docs, seed: int) -> list:
    """The docs' rows as what a service hands the applier: half the docs
    as (message, wire op) pairs for ``ingest_batch`` (16 ops a call), half
    as array boxcars for ``ingest_array_batch``. Returns
    [(doc, method name, list of call arguments)]."""
    from fluidframework_tpu_torch.testing.streams import (
        array_batches,
        wire_pairs,
    )

    rng = np.random.default_rng(seed)
    feeds = []
    for d, rows in enumerate(docs):
        doc = f"doc{d}"
        if d % 2 == 0:
            pairs = wire_pairs(rows, rng)
            feeds.append((doc, "ingest_batch",
                          [pairs[i:i + 16] for i in range(0, len(pairs), 16)]))
        else:
            feeds.append((doc, "ingest_array_batch",
                          array_batches(rows, rng, "t", doc)))
    return feeds


def feed(applier, feeds) -> None:
    for doc, method, calls in feeds:
        ingest = getattr(applier, method)
        for arg in calls:
            ingest("t", doc, arg)


def device_rows(wire_op: dict) -> int:
    """Device op rows the applier stages for one wire op: one per insert
    or remove, one per prop key of an annotate or an insert's props."""
    if wire_op["type"] == 3:  # group
        return sum(device_rows(sub) for sub in wire_op["ops"])
    base = 0 if wire_op["type"] == 2 else 1
    return base + len(wire_op.get("props") or {})


def phase_main_path(power: str):
    """The replica farm at full width on the card, against a CPU applier
    fed the same streams and against the farm sessions' oracle texts."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.testing.farm import run_session

    D, S, K, N_OPS = 1024, 256, 32, 96
    geo = dict(max_docs=D, max_slots=S, ops_per_dispatch=K)
    docs = make_opgen_docs(D, N_OPS, seed=11)
    sessions = [run_session(seed, n_clients=2, n_ops=64)
                for seed in range(64)]

    feeds = opgen_feeds(docs, seed=12)
    submitted = sum(len(rows) for rows in docs)

    cuda_apply.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = GpuDocumentApplier(device="cuda", **geo)
    feed(gpu, feeds)
    t1 = time.perf_counter()
    gpu.finalize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    seconds = t2 - t0
    farm = GpuDocumentApplier(device="cuda", **geo)
    farm_ops = 0
    for s, (log, _text) in enumerate(sessions):
        farm.ingest_batch("t", f"farm{s}", [(m, m.contents) for m in log])
        farm_ops += sum(device_rows(m.contents) for m in log)
    farm.finalize()
    launches = cuda_apply.LAUNCHES

    cpu = GpuDocumentApplier(device="cpu", **geo)
    feed(cpu, feeds)
    cpu.finalize()
    bad = [d for d in range(D)
           if gpu.get_text("t", f"doc{d}") != cpu.get_text("t", f"doc{d}")]
    if bad:
        fail(f"main path: {len(bad)} docs differ from the CPU applier "
             f"(first doc{bad[0]})")
    bad = [s for s, (_log, text) in enumerate(sessions)
           if farm.get_text("t", f"farm{s}") != text]
    if bad:
        fail(f"main path: farm docs {bad} differ from the oracle")
    for name, app, n in (("opgen", gpu, submitted), ("farm", farm,
                                                      farm_ops)):
        if app.host_escalations:
            fail(f"main path: {app.host_escalations} {name} escalations")
        if app.ops_applied != n:
            fail(f"main path: {name} applied {app.ops_applied} of {n} ops")
    if launches != gpu.dispatches + farm.dispatches or launches == 0:
        fail(f"main path: {launches} kernel launches for "
             f"{gpu.dispatches + farm.dispatches} dispatches")
    emit({"phase": "main_path", "docs": D, "slots": S, "K": K,
          "ops": submitted, "dispatches": gpu.dispatches,
          "seconds": seconds, "ops_per_sec": submitted / seconds,
          "ingest_seconds": t1 - t0, "finalize_seconds": t2 - t1,
          "ms_per_dispatch": seconds * 1e3 / gpu.dispatches,
          "farm_docs": len(sessions), "farm_ops": farm_ops,
          "launches": launches, "host_escalations": 0, "card": power})
    return launches


def phase_escalation():
    """One doc whose prop table overflows on the card (P + 1 keys on one
    character): the overflow poll escalates it, the replay source rebuilds
    it on the oracle, and its text and properties stay right."""
    from fluidframework_tpu_torch.mergetree.client import MergeTreeClient
    from fluidframework_tpu_torch.protocol import (
        MessageType,
        SequencedDocumentMessage,
    )
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    def msg(seq, contents):
        return SequencedDocumentMessage(
            client_id="a", sequence_number=seq, minimum_sequence_number=0,
            client_sequence_number=seq, reference_sequence_number=seq - 1,
            type=MessageType.OPERATION, contents=contents)

    log = [msg(1, {"type": 0, "pos": 0, "text": "escalate me"})]
    log += [msg(2 + k, {"type": 2, "start": 0, "end": 1,
                        "props": {f"key{k}": k}}) for k in range(9)]
    oracle = MergeTreeClient("oracle")
    for m in log:
        oracle.apply_msg(m, local=False)
    app = GpuDocumentApplier(device="cuda", max_docs=8, max_slots=256,
                             ops_per_dispatch=32)
    app.set_replay_source(lambda t, d: log)
    app.ingest_batch("t", "hot", [(m, m.contents) for m in log])
    app.finalize()
    if app.host_escalations != 1:
        fail(f"escalation: {app.host_escalations} escalations, want 1")
    if app.get_text("t", "hot") != oracle.get_text() or \
            app.get_properties_at("t", "hot", 0) != \
            oracle.get_properties_at(0):
        fail("escalation: the escalated doc differs from the oracle")
    emit({"phase": "escalation", "host_escalations": 1, "ok": True})


SERVICE_RUN = dict(n_docs=1024, clients_per_doc=2, ops_per_client=48,
                   batch_size=24, flush_every=4096, seed=3)
SERVICE_GEO = dict(max_docs=1024, max_slots=256, ops_per_dispatch=32)


def _timed(fn, name: str, into: dict):
    def timed(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
    return timed


def service_run(device: str, array_lane: bool = True, run=None, **applier):
    """One ``run_inproc`` with a fresh applier riding the broadcast.
    Returns (load stats, applier, every doc's text); fails the phase on an
    escalation, an unacked op or an op the applier did not apply."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.service.load_gen import run_inproc

    run = dict(SERVICE_RUN, **(run or {}))
    app = GpuDocumentApplier(device=device, **SERVICE_GEO, **applier)
    # host seconds the caller's thread spends inside the applier during
    # the run: its ingest entry points, and finalize (the final drain)
    seconds = {"ingest_batch": 0.0, "ingest_array_batch": 0.0}
    for method in ("ingest_batch", "ingest_array_batch", "finalize"):
        setattr(app, method, _timed(getattr(app, method), method, seconds))
    try:
        stats = run_inproc(applier=app, array_lane=array_lane, **run)
        app.caller_seconds = dict(seconds)
        texts = [app.get_text("bench", f"doc{d}")
                 for d in range(run["n_docs"])]
    finally:
        if applier.get("async_dispatch"):
            app.close()  # re-raises a worker exception: the phase fails
    what = f"service ({device}, array_lane={array_lane}, {applier})"
    if stats.applier_escalations:
        fail(f"{what}: {stats.applier_escalations} escalations")
    if stats.ops_acked != stats.ops_submitted:
        fail(f"{what}: {stats.ops_acked} of {stats.ops_submitted} acked")
    if stats.applier_ops != stats.ops_submitted:
        fail(f"{what}: the applier applied {stats.applier_ops} of "
             f"{stats.ops_submitted} ops")
    return stats, app, texts


def phase_service(name: str, power: str):
    """The service path at bench_service's geometry: the async applier
    (min_wave_ops=32768) on the array lane, timed, with its stage/execute
    split; then the same seed through a synchronous CPU applier, a
    synchronous card applier, the card with overlap off, and the card on
    the dict lane — every doc's text must agree with the CPU run. Returns B1's launches
    in the timed run."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.load_gen import run_inproc

    card = dict(async_dispatch=True, min_wave_ops=32768)
    # warm-up: CUDA context, the kernel library, pinned buffers
    service_run("cuda", run=dict(n_docs=16), **card)
    # the ordering pipeline alone, no applier: the host's share
    host_only = run_inproc(array_lane=True, **SERVICE_RUN)

    torch.cuda.synchronize()
    cuda_apply.LAUNCHES = 0
    stats, app, texts = service_run("cuda", **card)
    launches = cuda_apply.LAUNCHES
    if launches != app.dispatches or launches == 0:
        fail(f"service: {launches} kernel launches for {app.dispatches} "
             "dispatches")
    if app.waves_staged != app.dispatches:
        fail(f"service: {app.waves_staged} waves staged, "
             f"{app.dispatches} dispatched")

    # the CPU reference stages everything and flushes once at the end:
    # the flush cadence does not change what the applier computes
    _, cpu, cpu_texts = service_run(
        "cpu", run=dict(flush_every=10**9))
    checks = {"card": texts}
    sync_stats, sync_app, checks["sync_card"] = service_run("cuda")
    checks["overlap_off"] = service_run("cuda", overlap=False, **card)[2]
    dict_stats, _, checks["dict_lane"] = service_run(
        "cuda", array_lane=False, **card)
    for what, got in checks.items():
        bad = [d for d in range(len(cpu_texts)) if got[d] != cpu_texts[d]]
        if bad:
            fail(f"service: {what}: {len(bad)} docs differ from the CPU "
                 f"applier (first doc{bad[0]})")
    if not any(texts):
        fail("service: every doc is empty")

    row = {"phase": "service", "docs": SERVICE_RUN["n_docs"],
           "clients_per_doc": SERVICE_RUN["clients_per_doc"],
           "ops_per_client": SERVICE_RUN["ops_per_client"],
           "boxcar": SERVICE_RUN["batch_size"], "ops": stats.ops_submitted,
           "seconds": stats.seconds, "ops_per_sec": stats.ops_per_sec,
           "p50_ack_ms": stats.latency_ms(0.50),
           "p99_ack_ms": stats.latency_ms(0.99),
           "pipeline_only_seconds": host_only.seconds,
           "pipeline_only_ops_per_sec": host_only.ops_per_sec,
           "ingest_seconds": app.caller_seconds["ingest_array_batch"],
           "finalize_seconds": app.caller_seconds["finalize"],
           "stage_seconds": app.stage_seconds,
           "stage_bytes": app.stage_bytes,
           "exec_seconds": app.exec_seconds,
           "exec_device_seconds": app.exec_device_seconds,
           # a lower bound: a step's event span also counts the host's
           # gaps between its eager launches (tools/profile_service.py
           # measures the card's busy time itself)
           "card_idle_share_min": 1 - app.exec_device_seconds / stats.seconds,
           "stage_overlap_ratio": app.stage_overlap_ratio(),
           "dispatches": app.dispatches, "launches": launches,
           "host_escalations": 0,
           "sync_card_ops_per_sec": sync_stats.ops_per_sec,
           "sync_card_dispatches": sync_app.dispatches,
           "sync_card_stage_seconds": sync_app.stage_seconds,
           "sync_card_exec_seconds": sync_app.exec_seconds,
           "dict_lane_ops_per_sec": dict_stats.ops_per_sec,
           "dict_lane_p99_ack_ms": dict_stats.latency_ms(0.99),
           "cpu_dispatches": cpu.dispatches,
           "texts_match_cpu": list(checks),
           "name": name, "card": power}
    emit(row)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    from fluidframework_tpu_torch.ops import cuda_apply

    name = torch.cuda.get_device_name(0)
    power = nvidia_smi()
    emit({"phase": "device", "name": name, "nvidia_smi": power,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_apply.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in cuda_apply.BUILD_LOG.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]})

    rows = [
        phase_kernel("opgen_d1024_k32", 42, 1024, 256, 32, BENCH_MIX, False),
        phase_kernel("opgen_d8192_k64", 42, 8192, 256, 64, BENCH_MIX, False),
        phase_kernel("seed4_overflow", 4, 8, 16, 32, BENCH_MIX, True),
        # S not a multiple of 32 or 256 (inert lanes past S)
        phase_kernel("opgen_s200", 43, 256, 200, 32, BENCH_MIX, False),
        # the multi-warp path, at tests/test_replay.py's geometry and at
        # the largest S
        phase_kernel("opgen_s640", 44, 64, 640, 32, BENCH_MIX, False),
        phase_kernel("opgen_s1024_k64", 45, 32, 1024, 64, BENCH_MIX, False),
        # many prop-row copies on splits and prop-table writes
        phase_kernel("annotate_d1024_k32", 46, 1024, 256, 32, ANNOTATE_MIX,
                     False),
        # inserts only: counts cross the first warp's 256 slots and the
        # docs overflow
        phase_kernel("insert_overflow_s288", 47, 8, 288, 256, INSERT_MIX,
                     True),
    ]
    launches = phase_main_path(power)
    phase_escalation()
    launches += phase_service(name, power)

    main_row = rows[0]  # the main path's shape: D=1024, S=256, K=32
    print(json.dumps({"kernels": [{
        "name": "apply_ops_batch", "route": "cuda",
        "source": SOURCES["apply_ops_batch"],
        "replaces": REPLACES["apply_ops_batch"], "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}]}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
