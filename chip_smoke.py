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
Then the crash-safe applier stage: the service applier is checkpointed,
loaded back onto the card and onto the CPU, and fed a further tail
(``checkpoint``); a core writes the service run into a ``DurableLog`` and
an in-process ``ApplierStage`` on the card drains it (``stage``); and the
split deployment runs the stage as a child process on the card tailing
the core's log live, then kills it with SIGKILL mid-stream and restarts it
over the same directories (``split``).
Then the farm's read side: ``summary`` fills a held server's farm with the
service run, writes every doc's summary from the card with
``ServiceSummarizer.summarize_all`` (chunks held byte for byte against a
CPU applier's), boots every doc from its summary through the port's
``Loader``, lets real containers write a tail on 64 docs and runs an
incremental pass; ``history`` goes on with that server and its open card
applier: the history plane's commit graph of every doc, time travel,
forks of 64 docs inside their tail, edits on the forks integrated back
into the parents (B1 applies them on the card), a third pass and chunk
GC; ``soak`` runs chaos soak phase A at seeds 0, 7 and 42 with its
device stage on the card; ``replay`` replays the three recorded docs of
``tests/corpus`` through the farm on the card and through the client
stack.
Then the parallel layer: ``mesh`` drives the main path's farm (D=1024,
S=256, K=32, seed 42) on a mesh of 4 docs shards (on 4 cards where the
machine has them, else all on the first card; the phase prints which),
held against a CPU applier's texts and the dense card applier's state
rows, with its staging counters, a one-doc wave, the async applier, flat
device memory over 100 small waves, a re-sharded checkpoint and its
refusal by a 2-shard mesh, and soak phase A on a 2-shard mesh; it times
the mesh step against the dense step and the 1-shard mesh against the
dense lane. ``long_doc`` runs one giant doc through the segment-sharded
apply at 8 x 128 slots (against B1 at S=1024 and the plain version) and
8 x 4096 (against the plain version).
Each phase prints one JSON line (the last one, each phase's seconds); any
failure exits nonzero. Before the last line it prints
the kernel table (``{"kernels": [...]}``) and the card's name and power
limit as ``nvidia-smi`` reports them; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# The durable logs of the stage phases hold 1024 docs of 8 native handles
# each, all written at once. The default handle cap (2048, sized for cores
# of 10k mostly idle docs) would cycle a handle on nearly every append, so
# these runs lift it, as a deployment of this size would (the stage child
# inherits the setting). tools/profile_durable_log.py measures both.
os.environ.setdefault("FLUID_LOG_FD_CAP", "0")

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
    return launches, app, cpu_texts, row


def _tail_pairs(app, docs: list, n_ops: int, seed: int) -> dict:
    """{doc: [(message, wire op)]}: ``n_ops`` random inserts and removes a
    doc from a new client, valid against the doc's current text and
    sequenced after everything ``app`` has applied."""
    from fluidframework_tpu_torch.protocol import (
        MessageType,
        SequencedDocumentMessage,
    )

    rng = random.Random(seed)
    out = {}
    for doc in docs:
        length = len(app.get_text("bench", doc))
        seq = app.applied_seq("bench", doc)
        pairs = []
        for _ in range(n_ops):
            seq += 1
            if length and rng.random() < 0.4:
                start = rng.randrange(length)
                end = min(length, start + 1 + rng.randrange(4))
                op = {"type": 1, "start": start, "end": end}
                length -= end - start
            else:
                text = "xyz"[:1 + rng.randrange(3)]
                op = {"type": 0, "pos": rng.randrange(length + 1),
                      "text": text}
                length += len(text)
            pairs.append((SequencedDocumentMessage(
                client_id="tail", sequence_number=seq,
                minimum_sequence_number=seq - 1,
                client_sequence_number=seq, reference_sequence_number=seq - 1,
                type=MessageType.OPERATION, contents=op), op))
        out[doc] = pairs
    return out


def phase_checkpoint(app, power: str, device: str = "cuda"):
    """The service phase's card applier, checkpointed after ``finalize``
    (``save_applier_checkpoint``), loaded back onto the card and onto the
    CPU: every doc's text and applied seq must equal the saved applier's,
    before and after the same further waves. Returns B1's launches on
    those waves."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
        save_applier_checkpoint,
    )

    docs = [f"doc{d}" for d in range(SERVICE_RUN["n_docs"])]
    with _scratch_dir() as tmp:
        path = os.path.join(tmp, "farm")
        t0 = time.perf_counter()
        save = save_applier_checkpoint(app, path)
        save_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_applier_checkpoint(path, device=device,
                                         ops_per_dispatch=app.K)
        if device == "cuda":
            torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        on_cpu = load_applier_checkpoint(path, device="cpu",
                                         ops_per_dispatch=app.K)
    for what, other in (("loaded", loaded), ("cpu", on_cpu)):
        bad = [d for d in docs
               if other.get_text("bench", d) != app.get_text("bench", d)
               or other.applied_seq("bench", d)
               != app.applied_seq("bench", d)]
        if bad:
            fail(f"checkpoint: {what}: {len(bad)} docs differ from the "
                 f"saved applier (first {bad[0]})")
    tail = _tail_pairs(app, docs, 2 * app.K, seed=21)
    dispatched = app.dispatches + loaded.dispatches
    cuda_apply.LAUNCHES = 0
    for target in (app, loaded):
        for doc, pairs in tail.items():
            target.ingest_batch("bench", doc, pairs)
        target.finalize()
    launches = cuda_apply.LAUNCHES
    dispatched = app.dispatches + loaded.dispatches - dispatched
    for doc, pairs in tail.items():
        on_cpu.ingest_batch("bench", doc, pairs)
    on_cpu.finalize()
    if launches != dispatched or launches == 0:
        fail(f"checkpoint: {launches} kernel launches for {dispatched} "
             "dispatches")
    for what, other in (("loaded", loaded), ("cpu", on_cpu)):
        bad = [d for d in docs
               if other.get_text("bench", d) != app.get_text("bench", d)]
        if bad:
            fail(f"checkpoint: after the tail, {what}: {len(bad)} docs "
                 f"differ (first {bad[0]})")
    if app.host_escalations or loaded.host_escalations:
        fail("checkpoint: the tail escalated a doc")
    emit({"phase": "checkpoint", "docs": len(docs), "slots": app.max_slots,
          "K": app.K, "save_seconds": save_seconds,
          "readback_seconds": save["readback_seconds"],
          "savez_seconds": save["write_seconds"],
          "npz_bytes": save["npz_bytes"], "load_seconds": load_seconds,
          "tail_ops": sum(len(p) for p in tail.values()),
          "launches": launches, "texts_match": ["loaded", "cpu"],
          "card": power})
    return launches


def _last_seqs(log, docs: list) -> dict:
    """Each doc's last sequenced seq, from its deltas topic."""
    out = {}
    for doc in docs:
        topic = f"deltas/bench/{doc}"
        rec = log.read(topic, log.length(topic) - 1)
        out[doc] = (rec["abatch"].last_seq if "abatch" in rec
                    else (rec.get("boxcar") or [rec.get("message")])[-1]
                    .sequence_number)
    return out


def phase_stage(cpu_texts: list, power: str, device: str = "cuda"):
    """The service run written into a ``DurableLog`` by a core, then
    drained by an in-process ``ApplierStage`` on the card with
    ``run_once``: texts equal to the CPU applier's, B1 launched once a
    dispatch, the backchannel's newest ``applied`` record at each doc's
    last seq, and no doc escalated in the saved checkpoint."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.load_gen import run_inproc
    from fluidframework_tpu_torch.service.stage_runner import (
        BACKCHANNEL_TOPIC,
        ApplierStage,
    )

    docs = [f"doc{d}" for d in range(SERVICE_RUN["n_docs"])]
    with _scratch_dir() as tmp:
        log_dir, state_dir = (os.path.join(tmp, "log"),
                              os.path.join(tmp, "state"))
        os.makedirs(log_dir)
        log = DurableLog(log_dir)
        core = run_inproc(array_lane=True, log=log, **SERVICE_RUN)
        log.flush()
        last = _last_seqs(log, docs)
        log.close()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        stage = ApplierStage(log_dir, state_dir,
                             max_docs=SERVICE_GEO["max_docs"],
                             max_slots=SERVICE_GEO["max_slots"],
                             device=device)
        t1 = time.perf_counter()
        rounds = 1
        while stage.run_once():
            rounds += 1
        seconds = time.perf_counter() - t1
        launches = cuda_apply.LAUNCHES
        app = stage.applier
        newest = {}
        for i in range(stage.state.length(BACKCHANNEL_TOPIC)):
            rec = stage.state.read(BACKCHANNEL_TOPIC, i)
            if rec["kind"] == "applied":
                newest[rec["doc"]] = rec["applied_seq"]
        with open(os.path.join(state_dir, "applier.json")) as f:
            host_docs = json.load(f)["host_docs"]
        texts = [app.get_text("bench", d) for d in docs]
    bad = [d for d in range(len(docs)) if texts[d] != cpu_texts[d]]
    if bad:
        fail(f"stage: {len(bad)} docs differ from the CPU applier (first "
             f"doc{bad[0]})")
    if launches != app.dispatches or launches == 0:
        fail(f"stage: {launches} kernel launches for {app.dispatches} "
             "dispatches")
    lagging = [d for d in docs if newest.get(d) != last[d]]
    if lagging:
        fail(f"stage: {len(lagging)} docs' applied records lag their last "
             f"seq (first {lagging[0]})")
    if host_docs or app.host_escalations:
        fail(f"stage: {len(host_docs)} escalated docs in the checkpoint")
    emit({"phase": "stage", "docs": len(docs), "ops": core.ops_submitted,
          "core_seconds": core.seconds, "core_ops_per_sec": core.ops_per_sec,
          "open_seconds": t1 - t0, "drain_seconds": seconds,
          "drain_ops_per_sec": core.ops_submitted / seconds,
          "run_once_rounds": rounds, "dispatches": app.dispatches,
          "launches": launches, "ops_applied": app.ops_applied,
          "stage_seconds": app.stage_seconds, "exec_seconds": app.exec_seconds,
          "last_save": stage.last_save, "host_escalations": 0,
          "log_fd_cap": int(os.environ["FLUID_LOG_FD_CAP"]), "card": power})
    return launches


#: the split deployment's stage process: an ApplierStage at the service
#: geometry (the command line's ``main`` builds 64 docs)
STAGE_CHILD = """
import sys
from fluidframework_tpu_torch.service.stage_runner import ApplierStage
ApplierStage(sys.argv[1], sys.argv[2], max_docs=int(sys.argv[3]),
             max_slots=int(sys.argv[4]), device=sys.argv[5]).run_forever()
"""
#: core records between flushes: a stage process sees only flushed records
SPLIT_FLUSH_EVERY = 64
CHILD_TIMEOUT_S = 120.0


def _scratch_dir():
    """A temporary directory inside the checkout (``build/smoke/``), where
    the stage phases keep their logs and checkpoints."""
    root = os.path.join(HERE, "build", "smoke")
    os.makedirs(root, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=root)


def _deltas_records() -> int:
    """Records the service run writes to its deltas topics: each client's
    join and its boxcars."""
    run = SERVICE_RUN
    per_client = 1 + run["ops_per_client"] // run["batch_size"]
    return run["n_docs"] * run["clients_per_doc"] * per_client


def _flushing_log(directory: str, every: int):
    """A ``DurableLog`` that flushes every ``every`` appends, so a
    reader process tails the core while it runs."""
    from fluidframework_tpu_torch.service.durable_log import DurableLog

    class FlushingLog(DurableLog):
        def append(self, topic, value, partition=0):
            offset = super().append(topic, value, partition)
            self.appends_since_flush = getattr(
                self, "appends_since_flush", 0) + 1
            if self.appends_since_flush >= every:
                self.appends_since_flush = 0
                self.flush()
            return offset

    return FlushingLog(directory)


class _StageProcess:
    """The stage child on the card, its readiness, and a reader of its
    backchannel (the newest ``applied`` seq per doc)."""

    def __init__(self, log_dir: str, state_dir: str, device: str,
                 err_path: str):
        self.state_dir = state_dir
        self.started = time.perf_counter()
        self.err = open(err_path, "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", STAGE_CHILD, log_dir, state_dir,
             str(SERVICE_GEO["max_docs"]), str(SERVICE_GEO["max_slots"]),
             device],
            cwd=HERE,
            stdout=subprocess.PIPE, stderr=self.err, text=True)
        ready = []
        reader = threading.Thread(
            target=lambda: ready.append(self.proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(CHILD_TIMEOUT_S)
        if not ready or ready[0].strip() != "READY":
            self.kill()
            fail(f"split: the stage process did not print READY "
                 f"(got {ready}, rc {self.proc.poll()}); stderr in "
                 f"{err_path}")
        self.ready = time.perf_counter()
        self.log = None
        self.pos = 0
        self.newest: dict = {}

    def poll(self) -> dict:
        from fluidframework_tpu_torch.service.durable_log import DurableLog
        from fluidframework_tpu_torch.service.stage_runner import (
            BACKCHANNEL_TOPIC,
        )

        if self.proc.poll() is not None:
            fail(f"split: the stage process exited ({self.proc.returncode})")
        if self.log is None:
            self.log = DurableLog(self.state_dir, readonly=True)
        n = self.log.refresh_topic(BACKCHANNEL_TOPIC)
        for i in range(self.pos, n):
            rec = self.log.read(BACKCHANNEL_TOPIC, i)
            if rec["kind"] == "applied":
                self.newest[rec["doc"]] = rec["applied_seq"]
        self.pos = n
        return self.newest

    def wait_caught_up(self, last: dict) -> float:
        """Seconds until every doc's newest applied seq is its last (the
        backchannel's records from the start: a restarted stage reports
        only the docs it had to replay)."""
        t0 = time.perf_counter()
        while True:
            newest = self.poll()
            if all(newest.get(d) == s for d, s in last.items()):
                return time.perf_counter() - t0
            if time.perf_counter() - t0 > CHILD_TIMEOUT_S:
                self.kill()
                fail(f"split: the stage did not catch up in "
                     f"{CHILD_TIMEOUT_S} s")
            time.sleep(0.005)

    def kill(self, sig=signal.SIGKILL) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
        self.proc.wait(timeout=60)
        if self.log is not None:
            self.log.close()
            self.log = None
        self.err.close()


def _farm_texts(state_dir: str, docs: list, device: str) -> list:
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )

    farm = load_applier_checkpoint(os.path.join(state_dir, "applier"),
                                   device=device)
    if farm.host_escalations or farm._host_docs:
        fail("split: the stage escalated docs")
    return [farm.get_text("bench", d) for d in docs]


def phase_split(cpu_texts: list, service_row: dict, power: str,
                device: str = "cuda"):
    """The split deployment: this process is the core (the service run
    into a log that flushes every SPLIT_FLUSH_EVERY appends) and the
    ApplierStage is a child process on the card tailing it. Reports the
    core's ops/s and ack latency beside the in-process appliers', and the
    catch-up lag from the core's last ack to the stage's last ``applied``
    record. A second run holds the child to half the deltas records (its
    ``ctl.json`` stepping control), kills it with SIGKILL after its first
    ``applied`` record, restarts it over the same directories without the
    hold, and times its catch-up; both farms' final checkpoints must hold
    the CPU texts."""
    from fluidframework_tpu_torch.service.load_gen import run_inproc

    docs = [f"doc{d}" for d in range(SERVICE_RUN["n_docs"])]
    row = {"phase": "split", "docs": len(docs),
           "flush_every_records": SPLIT_FLUSH_EVERY,
           "log_fd_cap": int(os.environ["FLUID_LOG_FD_CAP"])}
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    err_path = os.path.join(out_dir, "split_stage_stderr.txt")
    children = []
    try:
        for run in ("live", "killed"):
            with _scratch_dir() as tmp:
                log_dir, state_dir = (os.path.join(tmp, "log"),
                                      os.path.join(tmp, "state"))
                os.makedirs(log_dir)
                log = _flushing_log(log_dir, SPLIT_FLUSH_EVERY)
                ctl = os.path.join(state_dir, "ctl.json")
                if run == "killed":
                    # the stage's stepping control holds it to half the
                    # deltas records, so the kill lands mid-stream
                    os.makedirs(state_dir)
                    with open(ctl, "w") as f:
                        json.dump({"mode": "pause",
                                   "steps": _deltas_records() // 2}, f)
                child = _StageProcess(log_dir, state_dir, device, err_path)
                children.append(child)
                killed = []
                if run == "killed":
                    def killer():
                        while not child.poll():
                            time.sleep(0.002)
                        child.proc.send_signal(signal.SIGKILL)
                        killed.append(time.perf_counter())

                    watcher = threading.Thread(target=killer, daemon=True)
                    watcher.start()
                stats = run_inproc(array_lane=True, log=log, **SERVICE_RUN)
                last_ack = time.perf_counter()
                log.flush()
                last = _last_seqs(log, docs)
                if stats.ops_acked != stats.ops_submitted:
                    fail(f"split: {stats.ops_acked} of "
                         f"{stats.ops_submitted} acked")
                if run == "live":
                    child.wait_caught_up(last)
                    row.update(
                        core_ops_per_sec=stats.ops_per_sec,
                        core_seconds=stats.seconds,
                        p50_ack_ms=stats.latency_ms(0.50),
                        p99_ack_ms=stats.latency_ms(0.99),
                        catch_up_lag_seconds=time.perf_counter() - last_ack,
                        stage_start_seconds=child.ready - child.started)
                    child.kill(signal.SIGTERM)
                else:
                    watcher.join(CHILD_TIMEOUT_S)
                    if not killed:
                        fail("split: the stage never reported an applied "
                             "record")
                    child.kill()
                    # whether the kill landed mid-stream: docs the killed
                    # stage had not reported through their last seq
                    row["lagging_docs_at_kill"] = sum(
                        child.newest.get(d) != s for d, s in last.items())
                    row["killed_before_last_ack"] = killed[0] < last_ack
                    os.remove(ctl)
                    child = _StageProcess(log_dir, state_dir, device,
                                          err_path)
                    children.append(child)
                    row["restart_ready_seconds"] = child.ready - child.started
                    catch_up = child.wait_caught_up(last)
                    row["restart_catch_up_seconds"] = catch_up
                    row["restart_catch_up_from_spawn_seconds"] = (
                        child.ready - child.started + catch_up)
                    child.kill(signal.SIGTERM)
                log.close()
                texts = _farm_texts(state_dir, docs, device)
            bad = [d for d in range(len(docs)) if texts[d] != cpu_texts[d]]
            if bad:
                fail(f"split ({run}): {len(bad)} docs differ from the CPU "
                     f"applier (first doc{bad[0]})")
    finally:
        for child in children:
            if child.proc.poll() is None:
                child.proc.kill()
                child.proc.wait(timeout=60)
    row.update(service_async_ops_per_sec=service_row["ops_per_sec"],
               service_sync_card_ops_per_sec=service_row[
                   "sync_card_ops_per_sec"],
               service_p50_ack_ms=service_row["p50_ack_ms"],
               service_p99_ack_ms=service_row["p99_ack_ms"],
               pipeline_only_ops_per_sec=service_row[
                   "pipeline_only_ops_per_sec"],
               texts_match_cpu=["live", "killed"], card=power)
    emit(row)


SUMMARY_STAGES = ("finalize", "readback_decode", "encode", "upload_commit")
#: docs whose real containers write a tail between the summary passes
SUMMARY_TAIL_DOCS = 64


class _PassClock:
    """Seconds of summary passes by stage, from wrappers installed on the
    objects a pass calls (``with clock.installed(...)``): the applier's
    ``finalize`` (the pass's fence and the one before each doc's read),
    its ``get_tree`` less the fences inside it (readback and decode), the
    replica's ``snapshot`` with the chunk encoder (encode), and the
    storage's writes with scribe's commit (upload with commit). What a
    pass spends elsewhere (the refusal gate's log scan) is its total less
    these."""

    def __init__(self):
        self.seconds = dict.fromkeys(SUMMARY_STAGES, 0.0)

    def wrap(self, fn, stage: str):
        def timed(*args, **kwargs):
            t0, fenced = time.perf_counter(), self.seconds["finalize"]
            try:
                out = fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                if stage != "finalize":
                    dt -= self.seconds["finalize"] - fenced
                self.seconds[stage] += dt
            if stage == "readback_decode":
                out.snapshot = self.wrap(out.snapshot, "encode")
            return out
        return timed

    def installed(self, server, applier):
        import contextlib

        from fluidframework_tpu_torch.protocol import snapcols

        @contextlib.contextmanager
        def scope():
            encode = snapcols.encode_snapshot_chunks
            storage = server.storage

            def timed_storage(tenant, doc):
                st = storage(tenant, doc)
                st.write_blob = self.wrap(st.write_blob, "upload_commit")
                st.upload_summary = self.wrap(st.upload_summary,
                                              "upload_commit")
                return st

            scribes = [o.scribe for o in server._orderers.values()]
            applier.finalize = self.wrap(applier.finalize, "finalize")
            applier.get_tree = self.wrap(applier.get_tree, "readback_decode")
            snapcols.encode_snapshot_chunks = self.wrap(encode, "encode")
            server.storage = timed_storage
            for s in scribes:
                s.commit_version = self.wrap(s.commit_version,
                                             "upload_commit")
            try:
                yield self
            finally:
                del applier.finalize, applier.get_tree, server.storage
                snapcols.encode_snapshot_chunks = encode
                for s in scribes:
                    del s.commit_version
        return scope()


def _stored_chunks(server, tenant: str, doc: str) -> list:
    """The chunk bytes of the doc's newest acked summary."""
    storage = server.storage(tenant, doc)
    root = json.loads(storage.read_blob(
        storage.get_versions(1)[0]["tree_id"]).decode())
    return [storage.read_blob(h) for h in root["chunks"]]


def _summary_pass(svc, server, app, docs: list) -> dict:
    """One ``summarize_all`` over every doc, timed by stage; fails on a
    refusal, a skipped doc or an escalation."""
    counts0 = svc.counters.snapshot()
    clock = _PassClock()
    with clock.installed(server, app):
        t0 = time.perf_counter()
        n = svc.summarize_all("bench", docs)
        seconds = time.perf_counter() - t0
    if svc.refusals:
        fail(f"summary: {len(svc.refusals)} refusals, first "
             f"{svc.refusals[0]}")
    if n != len(docs):
        fail(f"summary: {n} of {len(docs)} docs summarized")
    if app.host_escalations:
        fail(f"summary: {app.host_escalations} escalations")
    counts = svc.counters.snapshot()
    split = {f"{k}_seconds": v for k, v in clock.seconds.items()}
    return {"docs": n, "seconds": seconds, "docs_per_sec": n / seconds,
            **split, "other_seconds": seconds - sum(split.values()),
            "chunks_written": counts.get("storage.snapshot.chunks_written", 0)
            - counts0.get("storage.snapshot.chunks_written", 0),
            "chunks_reused": counts.get("storage.snapshot.chunks_reused", 0)
            - counts0.get("storage.snapshot.chunks_reused", 0)}


def _write_tail(loader, docs: list, seed: int) -> dict:
    """Real containers on ``docs`` (booted from the summary, connected)
    write a few inserts, removes and annotates each. Returns {doc: the
    container's text}."""
    rng = random.Random(seed)
    texts = {}
    for doc in docs:
        c = loader.resolve("bench", doc)
        if c._base_snapshot is None:
            fail(f"summary: the tail writer of {doc} did not boot from "
                 "the summary")
        s = c.runtime.get_data_store("default").get_channel("text")
        for k in range(6):
            n = len(s.get_text())
            if k % 3 == 0 or n < 2:
                s.insert_text(rng.randrange(n + 1), f"<tail{k}>")
            elif k % 3 == 1:
                a = rng.randrange(n)
                s.remove_text(a, min(n, a + 1 + rng.randrange(3)))
            else:
                a = rng.randrange(n)
                s.annotate_range(a, min(n, a + 4), {"tail": k})
        texts[doc] = s.get_text()
        c.close()
    return texts


def phase_summary(power: str, device: str = "cuda", run=None):
    """The farm's read side at the service geometry. The service run
    (``run_inproc_on`` a server this phase holds, the async card applier
    riding the broadcast) fills the farm; ``ServiceSummarizer.
    summarize_all`` writes every doc's summary from the card; every doc's
    stored chunks must equal, byte for byte, those built from a CPU
    applier fed the same channel stream; every doc boots through the
    port's ``Loader`` from its summary and holds the CPU text. Real
    containers on 64 docs then write a tail, which the card applier
    ingests, and a second pass must reuse chunks and write fewer. Returns
    B1's launches in the phase, its row, and what the ``history`` phase
    goes on with: the held server, its summarizer and loader, the CPU
    applier and the card applier, still open (the caller closes it; this
    phase closes it only when it fails)."""
    from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.protocol import snapcols
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
        channel_stream,
    )
    from fluidframework_tpu_torch.service.load_gen import run_inproc_on
    from fluidframework_tpu_torch.service.local_server import LocalServer
    from fluidframework_tpu_torch.service.service_summarizer import (
        ServiceSummarizer,
    )

    run = dict(SERVICE_RUN, **(run or {}))
    docs = [f"doc{d}" for d in range(run["n_docs"])]
    server = LocalServer()
    card = GpuDocumentApplier(device=device, async_dispatch=True,
                              min_wave_ops=32768, **SERVICE_GEO)
    cpu = GpuDocumentApplier(device="cpu", **SERVICE_GEO)
    cpu.set_replay_source(lambda t, d: [])

    def feed_cpu():
        for doc in docs:
            pairs = [(m, m.contents) for m in channel_stream(
                server, "bench", doc, "default", "text",
                from_seq=cpu.applied_seq("bench", doc))]
            if pairs:
                cpu.ingest_batch("bench", doc, pairs)
        cpu.finalize()

    def check_chunks(which: list, when: str) -> None:
        bad = [d for d in which if _stored_chunks(server, "bench", d)
               != snapcols.encode_snapshot_chunks(
                   cpu.get_tree("bench", d).snapshot())]
        if bad:
            fail(f"summary: {when}: {len(bad)} docs' chunks differ from "
                 f"the CPU applier's (first {bad[0]})")

    try:
        if device == "cuda":
            torch.cuda.synchronize()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        stats = run_inproc_on(server, applier=card, array_lane=True, **run)
        feed_seconds = time.perf_counter() - t0
        if stats.ops_acked != stats.ops_submitted or \
                stats.applier_ops != stats.ops_submitted:
            fail(f"summary: {stats.ops_acked} acked, {stats.applier_ops} "
                 f"applied of {stats.ops_submitted}")
        svc = ServiceSummarizer(server, card)
        first = _summary_pass(svc, server, card, docs)

        feed_cpu()
        check_chunks(docs, "first pass")
        loader = Loader(LocalDocumentServiceFactory(server))
        t0 = time.perf_counter()
        booted = [loader.resolve("bench", d, connect=False) for d in docs]
        boot_seconds = time.perf_counter() - t0
        bad = [d for d, c in zip(docs, booted) if c._base_snapshot is None
               or c.runtime.get_data_store("default").get_channel("text")
               .get_text() != cpu.get_text("bench", d)]
        if bad:
            fail(f"summary: {len(bad)} booted containers differ from the "
                 f"CPU applier or did not boot from the summary (first "
                 f"{bad[0]})")

        tail_docs = docs[:SUMMARY_TAIL_DOCS]
        tail_texts = _write_tail(loader, tail_docs, seed=31)
        second = _summary_pass(svc, server, card, docs)
        card.finalize()  # re-raises a worker exception: the phase fails
        launches = cuda_apply.LAUNCHES
        dispatches = card.dispatches
        if launches != dispatches or launches == 0:
            fail(f"summary: {launches} kernel launches for {dispatches} "
                 "dispatches")
        feed_cpu()
        check_chunks(tail_docs, "second pass")
        bad = [d for d in tail_docs
               if tail_texts[d] != cpu.get_text("bench", d)
               or card.get_text("bench", d) != tail_texts[d]]
        if bad:
            fail(f"summary: {len(bad)} tail docs differ between the writer, "
                 f"the card and the CPU (first {bad[0]})")
    except BaseException:
        card.close()
        raise
    if not second["chunks_reused"] or \
            second["chunks_written"] >= first["chunks_written"]:
        card.close()
        fail(f"summary: the second pass reused {second['chunks_reused']} "
             f"chunks and wrote {second['chunks_written']} (first pass "
             f"{first['chunks_written']})")
    row = {"phase": "summary", "docs": len(docs), "slots": card.max_slots,
           "K": card.K, "feed_seconds": feed_seconds,
           "ops": stats.ops_submitted,
           "first_pass": first, "boot_seconds": boot_seconds,
           "boot_docs_per_sec": len(docs) / boot_seconds,
           "tail_docs": len(tail_docs), "second_pass": second,
           "launches": launches, "dispatches": dispatches,
           "host_escalations": 0, "refusals": 0,
           "chunks_match_cpu": True, "card": power}
    emit(row)
    held = SimpleNamespace(server=server, card=card, cpu=cpu, svc=svc,
                           loader=loader, docs=docs, tail_docs=tail_docs,
                           feed_cpu=feed_cpu)
    return launches, row, held


#: fork edits a doc: inserts at positions both the fork's and the parent's
#: head text hold, and an annotate
FORK_INSERTS = 3


def _text(container) -> str:
    return container.runtime.get_data_store("default").get_channel(
        "text").get_text()


def _closed(container):
    """A booted container (snapshot plus the backfilled tail), closed."""
    container.close()
    return container


def _cpu_texts_at(server, seqs: dict) -> dict:
    """{doc: text} of a CPU applier fed each doc's channel stream up to
    and including ``seqs[doc]``."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
        channel_stream,
    )

    ref = GpuDocumentApplier(device="cpu", **dict(SERVICE_GEO,
                                                  max_docs=len(seqs)))
    ref.set_replay_source(lambda t, d: [])
    for doc, seq in seqs.items():
        pairs = [(m, m.contents) for m in channel_stream(
            server, "bench", doc, "default", "text")
            if m.sequence_number <= seq]
        if pairs:
            ref.ingest_batch("bench", doc, pairs)
    ref.finalize()
    return {doc: ref.get_text("bench", doc) for doc in seqs}


def _fork_edits(loader, fork: str, boot_text: str, bound: int, rng) -> tuple:
    """A real container on ``fork``, which must boot from the fork's v0
    with ``boot_text``, inserts FORK_INSERTS markers at positions below
    ``bound`` and annotates a range; returns (the fork's text, the
    inserts as (position, text))."""
    c = loader.resolve("bench", fork)
    if c._base_snapshot is None or _text(c) != boot_text:
        fail(f"history: the fork {fork} did not boot from its v0 with its "
             f"parent's text at the fork seq")
    s = c.runtime.get_data_store("default").get_channel("text")
    inserts = []
    for k in range(FORK_INSERTS):
        pos, ins = rng.randrange(bound + 1), f"<fork{k}>"
        s.insert_text(pos, ins)
        inserts.append((pos, ins))
    a = rng.randrange(max(bound - 1, 1))
    s.annotate_range(a, min(a + 2, len(s.get_text())), {"fork": 1})
    text = s.get_text()
    c.close()
    return text, inserts


def phase_history(held, power: str, device: str = "cuda"):
    """The doc history plane over the summary phase's held server and its
    open card applier (1024 docs, two passes). Every doc's ``history.log``
    holds the two passes' commits, chained, each naming the chunks its
    version's root record lists, ``refs/main`` at the second. For the 64
    tail docs: ``Loader.resolve_at`` at the first pass's base, inside the
    tail and at the head gives the text of a CPU applier fed the channel
    stream up to that seq; a fork inside the tail (an explicit name)
    copies no blob and boots through ``Loader.resolve`` with the parent's
    text there; real containers edit each fork, ``integrate`` replays
    the edits into the parent, and the card applier, the CPU applier and
    a fresh boot of the parent agree with the parent's head text plus
    the fork's inserts. A third pass over the 64 parents adds a commit a
    doc, and ``gc_chunks`` keeps every chunk a branch head or a fork pin
    names and sweeps exactly the superseded ones; forks and parents boot
    after it. Returns B1's launches in the phase."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.core import (
        summary_versions_collection,
    )
    from fluidframework_tpu_torch.service.history_plane import MAIN_REF

    server, card, loader = held.server, held.card, held.loader
    plane = server.history
    docs, tail_docs = held.docs, held.tail_docs
    if device == "cuda":
        torch.cuda.synchronize()
    cuda_apply.LAUNCHES = 0
    dispatched = card.dispatches

    t0 = time.perf_counter()
    first_base = {}
    for doc in docs:
        log = plane.log("bench", doc)
        if len(log) != 2 or log[0]["parents"] != [log[1]["id"]] \
                or log[1]["parents"] != [] \
                or plane.refs("bench", doc) != {MAIN_REF: log[0]["id"]}:
            fail(f"history: {doc}'s commits are not the two passes "
                 f"chained under {MAIN_REF}: {log}")
        for c in log:
            rec = server.db.find_one(
                summary_versions_collection("bench", doc), c["version"])
            root = json.loads(server.blob_store.get(rec["tree_id"]))
            if root["chunks"] != c["chunk_ids"] or \
                    root["sequence_number"] != c["base_seq"]:
                fail(f"history: {doc}'s commit {c['id']} does not name "
                     f"the chunks of {c['version']}")
        first_base[doc] = log[1]["base_seq"]
    graph_seconds = time.perf_counter() - t0

    heads = {d: server._get_orderer("bench", d).deli.sequence_number
             for d in tail_docs}
    points = {"base": {d: first_base[d] for d in tail_docs},
              "mid": {d: (first_base[d] + heads[d]) // 2
                      for d in tail_docs},
              "head": heads}
    if any(not first_base[d] < points["mid"][d] < heads[d]
           for d in tail_docs):
        fail("history: a tail doc's tail is too short to travel into")
    want = {name: _cpu_texts_at(server, seqs)
            for name, seqs in points.items()}
    t0 = time.perf_counter()
    for name, seqs in points.items():
        for doc in tail_docs:
            c = loader.resolve_at("bench", doc, seqs[doc])
            if _text(c) != want[name][doc] or not c.readonly:
                fail(f"history: {doc} at its {name} seq {seqs[doc]} "
                     "differs from the CPU applier")
    travel_seconds = time.perf_counter() - t0

    blobs = len(server.db.collection("blobs"))
    t0 = time.perf_counter()
    forks = {d: plane.fork("bench", d, at_seq=points["mid"][d],
                           new_doc=f"{d}-fork") for d in tail_docs}
    fork_seconds = time.perf_counter() - t0
    if len(server.db.collection("blobs")) != blobs or \
            any(f["shared_chunks"] <= 0 for f in forks.values()):
        fail("history: a fork copied blobs or shares no chunk")
    rng = random.Random(41)
    fork_texts, expect = {}, {}
    for doc in tail_docs:
        bound = min(len(want["mid"][doc]), len(want["head"][doc]))
        fork_texts[doc], inserts = _fork_edits(
            loader, f"{doc}-fork", want["mid"][doc], bound, rng)
        text = want["head"][doc]
        for pos, ins in inserts:
            text = text[:pos] + ins + text[pos:]
        expect[doc] = text

    t0 = time.perf_counter()
    integrated = sum(plane.integrate("bench", f"{d}-fork")["ops"]
                     for d in tail_docs)
    integrate_seconds = time.perf_counter() - t0
    if integrated != len(tail_docs) * (FORK_INSERTS + 1):
        fail(f"history: integrate replayed {integrated} ops")
    held.feed_cpu()
    for doc in tail_docs:
        got = {"card": card.get_text("bench", doc),
               "cpu": held.cpu.get_text("bench", doc),
               "boot": _text(_closed(loader.resolve("bench", doc)))}
        if set(got.values()) != {expect[doc]}:
            fail(f"history: after integrate {doc} reads {got}, want "
                 f"{expect[doc]!r}")

    third = _summary_pass(held.svc, server, card, tail_docs)
    card.finalize()
    launches = cuda_apply.LAUNCHES
    dispatches = card.dispatches - dispatched
    if launches != dispatches or launches == 0:
        fail(f"history: {launches} kernel launches for {dispatches} "
             "dispatches")
    live, named = set(), set()
    every = docs + [f"{d}-fork" for d in tail_docs]
    commits = 0
    for doc in every:
        log = {c["id"]: c for c in plane.log("bench", doc)}
        commits += len(log)
        for c in log.values():
            named.update(c["chunk_ids"])
        for cid in plane.refs("bench", doc).values():
            # a fork pin on a parent names the parent's own commit
            live.update(log[cid]["chunk_ids"])
    if commits != 2 * len(docs) + 2 * len(tail_docs):
        fail(f"history: {commits} commits recorded")
    t0 = time.perf_counter()
    gc = plane.gc_chunks("bench")
    gc_seconds = time.perf_counter() - t0
    dead = named - live
    store = server.blob_store
    if not dead or gc["deleted"] != len(dead) \
            or any(store.has(c) for c in dead) \
            or not all(store.has(c) for c in live):
        fail(f"history: gc {gc} against {len(dead)} superseded chunks "
             f"and {len(live)} live ones")
    for doc in tail_docs:
        if _text(_closed(loader.resolve("bench", f"{doc}-fork"))) \
                != fork_texts[doc] or \
                _text(_closed(loader.resolve("bench", doc))) != expect[doc]:
            fail(f"history: {doc} or its fork does not boot after gc")
    row = {"phase": "history", "docs": len(docs),
           "tail_docs": len(tail_docs), "commits": commits,
           "graph_check_seconds": graph_seconds,
           "time_travel_boots": 3 * len(tail_docs),
           "time_travel_seconds": travel_seconds,
           "forks": len(forks), "fork_seconds": fork_seconds,
           "fork_tail_ops": sum(f["tail_ops"] for f in forks.values()),
           "shared_chunks": sum(f["shared_chunks"] for f in forks.values()),
           "integrate_ops": integrated,
           "integrate_seconds": integrate_seconds, "third_pass": third,
           "gc": gc, "gc_seconds": gc_seconds, "chunks_swept": gc["deleted"],
           "chunks_kept": len(live), "launches": launches,
           "dispatches": dispatches, "texts_match": ["card", "cpu", "boot"],
           "card": power}
    emit(row)
    return launches


MESH_SHARDS = 4
MESH_GEO = dict(max_docs=1024, max_slots=256, ops_per_dispatch=32)


def mesh_devices(device: str = "cuda") -> tuple[list, str]:
    """The mesh phase's shard devices: one card a shard where the machine
    has MESH_SHARDS cards, else every shard on the first card (or, in a
    CPU rehearsal, on the CPU). Returns (devices, how)."""
    if device == "cuda" and torch.cuda.device_count() >= MESH_SHARDS:
        return ([torch.device("cuda", i) for i in range(MESH_SHARDS)],
                f"{MESH_SHARDS} cards, one shard each")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    return [dev] * MESH_SHARDS, f"{MESH_SHARDS} shards on {dev}"


def _sync_all(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _texts(app, n_docs: int) -> list:
    return [app.get_text("t", f"doc{d}") for d in range(n_docs)]


def _state_rows(app, n_docs: int) -> dict:
    """Every doc's state row, read back once: field -> [n_docs, ...]."""
    from fluidframework_tpu_torch.ops.doc_state import FIELDS

    app.finalize()
    rows = np.array([app.slot_of("t", f"doc{d}") for d in range(n_docs)])
    state = app.state
    return {f: getattr(state, f).cpu().numpy()[rows] for f in FIELDS}


def _mesh_step_ms(mesh, feeds_docs, devices) -> dict:
    """Device ms a wave of the mesh step (unpack → B1 → zamboni a shard,
    and the stats) against the dense step on the same packed wave: the
    second K-op wave of the phase's opgen docs, on the state the first
    left."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.ops.apply import (
        OP_FIELDS,
        apply_ops_batch_ref,
        compact_batch,
        pack_wave_rows,
        unpack_wave16,
        wave_min_seq,
    )
    from fluidframework_tpu_torch.ops.doc_state import DocState
    from fluidframework_tpu_torch.parallel.sharded_apply import (
        make_sharded_packed_step,
        shard_state,
    )
    from fluidframework_tpu_torch.tools.apply_ab import cuda_ms

    D, S, K = MESH_GEO["max_docs"], MESH_GEO["max_slots"], \
        MESH_GEO["ops_per_dispatch"]
    stream = np.stack([rows[:2 * K] for rows in feeds_docs])
    w1 = torch.from_numpy(stream[:, :K].copy()).to(devices[0])
    state = apply_ops_batch_ref(DocState.empty(D, S, device=devices[0]), w1)
    state = compact_batch(state, wave_min_seq(w1))
    flat = stream[:, K:].reshape(-1, OP_FIELDS)
    packed, sb, tb = pack_wave_rows(flat, np.arange(D) * K, np.full(D, K))
    w16 = torch.from_numpy(packed.reshape(D, K, OP_FIELDS).astype(np.int16))
    bases = torch.from_numpy(np.stack([sb, tb], 1).astype(np.int32))
    packed_fn, _ = make_sharded_packed_step(mesh)
    shards = shard_state(state, mesh)
    n = MESH_SHARDS
    w16_s = [b.to(mesh.shard_device(i)) for i, b in enumerate(
        torch.chunk(w16, n))]
    bases_s = [b.to(mesh.shard_device(i)) for i, b in enumerate(
        torch.chunk(bases, n))]
    w16_d, bases_d = w16.to(devices[0]), bases.to(devices[0])

    def mesh_step():
        return packed_fn(shards, w16_s, bases_s)

    def dense_step():
        wave = unpack_wave16(w16_d, bases_d)
        return compact_batch(cuda_apply.apply_ops_batch(state, wave),
                             wave_min_seq(wave))

    if len(set(devices)) == 1:
        # the host's enqueue of one step (eager launches, ~50 a shard)
        for _ in range(2):
            mesh_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            mesh_step()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
        torch.cuda.synchronize()
        # dense, mesh, mesh, dense, by CUDA events behind a ~100 ms sleep
        # that outlasts the enqueue of 3 steps (~600 launches, inside the
        # launch queue), so only device time counts
        times = [cuda_ms(f, reps=3, sleep_cycles=200_000_000)
                 for f in (dense_step, mesh_step, mesh_step, dense_step)]
        return {"mesh_step_ms": min(times[1:3]),
                "dense_step_ms": min(times[0], times[3]),
                "step_times_ms": times, "mesh_enqueue_ms": enqueue_ms,
                "timed_by": "cuda events"}
    # shards on several cards: one host-clock span a wave, fenced
    for _ in range(2):
        mesh_step()
    _sync_all(devices)
    t0 = time.perf_counter()
    for _ in range(20):
        mesh_step()
    _sync_all(devices)
    return {"mesh_step_ms": (time.perf_counter() - t0) * 1e3 / 20,
            "dense_step_ms": None, "timed_by": "host clock, fenced"}


def _timed_feed(make, feeds, devices) -> tuple[float, object]:
    """Seconds of building an applier, feeding it and finalizing, fenced."""
    _sync_all(devices)
    t0 = time.perf_counter()
    app = make()
    feed(app, feeds)
    app.finalize()
    _sync_all(devices)
    return time.perf_counter() - t0, app


def phase_mesh(power: str, device: str = "cuda"):
    """The main path's hand-fed farm on a mesh of MESH_SHARDS docs shards
    (D=1024, S=256, K=32, the bench_kernel opgen mix, seed 42): texts
    against a CPU applier, every state row against the dense card
    applier, staging bytes per active shard, a one-doc wave staging one
    shard, the async applier with min_wave_ops, flat device memory over
    100 small mesh waves, a checkpoint that reloads onto a 4-shard mesh
    and is refused by a 2-shard one, and chaos soak phase A with its
    stage on a 2-shard mesh. Returns B1's launches on the mesh run and
    the mesh soak."""
    from fluidframework_tpu_torch.chaos.soak import (
        BOUNDARY_REQUIRED,
        run_soak,
    )
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.ops.apply import OP_FIELDS
    from fluidframework_tpu_torch.ops.doc_state import FIELDS
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
        load_applier_checkpoint,
        save_applier_checkpoint,
    )

    D, K = MESH_GEO["max_docs"], MESH_GEO["ops_per_dispatch"]
    devices, how = mesh_devices(device)
    mesh = make_mesh(MESH_SHARDS, devices=devices)
    docs = make_opgen_docs(D, 96, seed=42)
    feeds = opgen_feeds(docs, seed=43)
    submitted = sum(len(rows) for rows in docs)

    _sync_all(devices)
    cuda_apply.LAUNCHES = 0
    seconds, app = _timed_feed(
        lambda: GpuDocumentApplier(mesh=mesh, **MESH_GEO), feeds, devices)
    launches = cuda_apply.LAUNCHES
    if app.mesh_waves != app.dispatches or app.dispatches == 0:
        fail(f"mesh: {app.mesh_waves} mesh waves, {app.dispatches} "
             "dispatches")
    if launches != app.dispatches * MESH_SHARDS:
        fail(f"mesh: {launches} kernel launches for {app.dispatches} waves "
             f"of {MESH_SHARDS} shards")
    if app.host_escalations or app.ops_applied != submitted:
        fail(f"mesh: {app.host_escalations} escalations, "
             f"{app.ops_applied} of {submitted} ops applied")
    sps = app.placement.slots_per_shard
    per_shard = sps * K * OP_FIELDS * 2 + sps * 2 * 4
    if app.wide_dispatches or \
            app.mesh_staged_bytes != app.mesh_active_shards * per_shard:
        fail(f"mesh: staged {app.mesh_staged_bytes} bytes for "
             f"{app.mesh_active_shards} active shards of {per_shard}")

    cpu = GpuDocumentApplier(device="cpu", **MESH_GEO)
    feed(cpu, feeds)
    cpu_texts = _texts(cpu, D)
    bad = [d for d, t in enumerate(_texts(app, D)) if t != cpu_texts[d]]
    if bad:
        fail(f"mesh: {len(bad)} docs differ from the CPU applier "
             f"(first doc{bad[0]})")
    dense = GpuDocumentApplier(device=device, **MESH_GEO)
    feed(dense, feeds)
    want, got = _state_rows(dense, D), _state_rows(app, D)
    bad = [f for f in FIELDS if not np.array_equal(want[f], got[f])]
    if bad or dense.host_escalations:
        fail(f"mesh: state fields {bad} differ from the dense card "
             "applier's")

    one = GpuDocumentApplier(mesh=mesh, **MESH_GEO)
    feed(one, feeds[:1])
    one.finalize()
    if one.mesh_active_shards != one.mesh_waves or one.mesh_waves == 0 \
            or one.mesh_staged_bytes != one.mesh_waves * per_shard \
            or one.get_text("t", "doc0") != cpu_texts[0]:
        fail(f"mesh: one active doc staged {one.mesh_active_shards} shards "
             f"and {one.mesh_staged_bytes} bytes in {one.mesh_waves} waves")

    async_app = GpuDocumentApplier(mesh=mesh, async_dispatch=True,
                                   min_wave_ops=32768, **MESH_GEO)
    try:
        feed(async_app, feeds)
        async_app.finalize()
        bad = [d for d, t in enumerate(_texts(async_app, D))
               if t != cpu_texts[d]]
    finally:
        async_app.close()
    if bad:
        fail(f"mesh: the async applier differs on {len(bad)} docs")

    memory = _mesh_memory_flat(mesh, devices)

    with _scratch_dir() as tmp:
        path = os.path.join(tmp, "mesh")
        save_applier_checkpoint(app, path)
        loaded = load_applier_checkpoint(path, mesh=mesh)
        bad = [d for d, t in enumerate(_texts(loaded, D))
               if t != cpu_texts[d]]
        if bad:
            fail(f"mesh: the reloaded checkpoint differs on {len(bad)} docs")
        try:
            load_applier_checkpoint(
                path, mesh=make_mesh(2, devices=devices[:2]))
            fail("mesh: a 2-shard mesh loaded a 4-shard checkpoint")
        except ValueError as err:
            refusal = str(err)

    _sync_all(devices)
    cuda_apply.LAUNCHES = 0
    t0 = time.perf_counter()
    out = run_soak(0, quick=True, phases="a", mesh_shards=2, device=device)
    soak_seconds = time.perf_counter() - t0
    soak_launches = cuda_apply.LAUNCHES
    missing = set(BOUNDARY_REQUIRED) - set(out["coverage"])
    if missing or soak_launches == 0:
        fail(f"mesh soak: classes {sorted(missing)} not covered, "
             f"{soak_launches} kernel launches")

    timing = (_mesh_step_ms(mesh, docs, devices) if device == "cuda"
              else {})
    # the 1-shard mesh lane against the dense lane, same geometry and
    # feed, in turns (dense, mesh, mesh, dense); recorded, not gated
    tax = []
    for make in ("dense", "mesh1", "mesh1", "dense"):
        kw = ({"device": device} if make == "dense" else
              {"mesh": make_mesh(1, devices=devices[:1])})
        tax.append(_timed_feed(
            lambda kw=kw: GpuDocumentApplier(**kw, **MESH_GEO), feeds,
            devices)[0])
    emit({"phase": "mesh", "shards": MESH_SHARDS, "placement": how,
          "devices": [str(d) for d in devices], "docs": D,
          "slots": MESH_GEO["max_slots"], "K": K, "ops": submitted,
          "dispatches": app.dispatches, "seconds": seconds,
          "ops_per_sec": submitted / seconds, "launches": launches,
          "active_shards": app.mesh_active_shards,
          "staged_bytes": app.mesh_staged_bytes,
          "staged_bytes_per_shard": per_shard,
          "one_doc_staged_bytes": one.mesh_staged_bytes,
          "one_doc_waves": one.mesh_waves,
          "stage_seconds": app.mesh_stage_seconds,
          "exec_seconds": app.exec_seconds,
          "exec_device_seconds": app.exec_device_seconds,
          "state_rows_match_dense": True, "texts_match_cpu": True,
          "async_texts_match": True, "checkpoint_refusal": refusal,
          **memory, **timing,
          "tax_seconds_dense_mesh1_mesh1_dense": tax,
          "mesh1_over_dense": (tax[1] + tax[2]) / (tax[0] + tax[3]),
          "soak": {"seed": 0, "mesh_shards": 2, "coverage": out["coverage"],
                   "observed": out["observed"], "seconds": soak_seconds,
                   "launches": soak_launches},
          "card": power})
    return launches + soak_launches


def _mesh_memory_flat(mesh, devices) -> dict:
    """Device memory of a small mesh applier (the JAX test's geometry)
    across 100 waves of 4 docs × 2 ops: allocated bytes behind a fence
    after wave 10 and after wave 100 must be equal."""
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )

    def allocated():
        _sync_all(devices)
        return sum(torch.cuda.memory_allocated(d)
                   for d in dict.fromkeys(devices) if d.type == "cuda")

    app = GpuDocumentApplier(mesh=mesh, max_docs=8, max_slots=32,
                             ops_per_dispatch=4)
    seq, baseline = 0, None
    for wave in range(100):
        for i in range(4):
            for op in ({"type": 0, "pos": 0, "text": "x"},
                       {"type": 1, "start": 0, "end": 1}):
                seq += 1
                msg = SimpleNamespace(
                    sequence_number=seq,
                    reference_sequence_number=max(seq - 1, 0),
                    minimum_sequence_number=max(seq - 4, 0),
                    client_id="c0")
                app.ingest("t", f"d{i}", msg, op)
        app.flush()
        if wave == 9:
            baseline = allocated()
    app.finalize()
    end = allocated()
    if app.mesh_waves < 100 or end > baseline or app.host_escalations:
        fail(f"mesh: device memory {baseline} -> {end} bytes over "
             f"{app.mesh_waves} waves")
    return {"memory_waves": app.mesh_waves,
            "memory_bytes_after_10_and_100": [baseline, end]}


LONG_DOC_SEG = 8
#: (S_LOCAL, ops, remove fraction): the first at B1's largest S in all,
#: the second a doc past one shard's 4096 slots
LONG_DOC_CASES = ((128, 600, 0.15), (4096, 3600, 0.08))
LONG_DOC_CHUNK = 8  # tests/test_long_doc_apply.py's chunk and watermark


def _live_rows(state) -> list:
    """Live slot rows (the slot fields) in logical order, shard-major."""
    from fluidframework_tpu_torch.ops.doc_state import SLOT_FIELDS

    a = {f: getattr(state, f).cpu().numpy() for f in SLOT_FIELDS}
    counts = state.count.cpu().numpy()
    return [tuple(int(a[f][s, i]) for f in SLOT_FIELDS)
            for s in range(len(counts)) for i in range(int(counts[s]))]


def _giant_doc(ops: torch.Tensor, s_local: int) -> tuple:
    """The segment-sharded apply of ``ops`` over LONG_DOC_SEG shards of
    ``s_local`` slots on the ops' device, chunked, rebalanced on the host
    past the watermark. Returns (state, rebalances)."""
    from fluidframework_tpu_torch.ops.doc_state import (
        FIELDS,
        DocState,
        state_from_numpy,
    )
    from fluidframework_tpu_torch.parallel.long_doc import (
        rebalance_shards,
        sharded_apply_ops,
    )

    state = DocState.empty(LONG_DOC_SEG, s_local, device=ops.device)
    watermark = s_local - 3 * LONG_DOC_CHUNK
    rebalances = 0
    for i in range(0, len(ops), LONG_DOC_CHUNK):
        state = sharded_apply_ops(state, ops[i:i + LONG_DOC_CHUNK])
        counts = state.count.cpu().numpy()
        if bool(state.overflow.any()):
            fail(f"long_doc: overflow at op {i}")
        if counts.max() > watermark:
            arrays = {f: getattr(state, f).cpu().numpy() for f in FIELDS
                      if f not in ("count", "overflow")}
            arrays, new_counts = rebalance_shards(arrays, counts)
            arrays.update(count=new_counts,
                          overflow=np.zeros(LONG_DOC_SEG, np.bool_))
            state = state_from_numpy(arrays, ops.device)
            rebalances += 1
    return state, rebalances


def phase_long_doc(power: str, device: str = "cuda"):
    """One giant doc through the segment-sharded apply (PyTorch on the
    card; no kernel of its own) in two cases: 8 x 128 slots against B1
    on one doc at S=1024 and against the plain version, and 8 x 4096
    (32,768 slots, the doc past one shard's budget) against the plain
    single-doc apply."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.ops.apply import (
        apply_ops_batch_ref,
        compact_batch,
        wave_min_seq,
    )
    from fluidframework_tpu_torch.ops.doc_state import DocState
    from fluidframework_tpu_torch.ops.opgen import generate_batch_ops

    def fence():
        if device == "cuda":
            torch.cuda.synchronize()

    cases = []
    for s_local, n_ops, remove in LONG_DOC_CASES:
        ops_np = generate_batch_ops(
            np.random.default_rng(42), 1, n_ops, remove_fraction=remove,
            annotate_fraction=0.05, max_insert=6)[0]
        ops = torch.from_numpy(ops_np).to(device)
        S = LONG_DOC_SEG * s_local
        fence()
        t0 = time.perf_counter()
        state, rebalances = _giant_doc(ops, s_local)
        fence()
        sharded_seconds = time.perf_counter() - t0
        rows = _live_rows(state)

        def single(apply):
            out = apply(DocState.empty(1, S, device=device), ops[None])
            out = compact_batch(out, wave_min_seq(ops[None]))
            if bool(out.overflow[0]):
                fail(f"long_doc: the single-doc reference at S={S} "
                     "overflowed")
            return _live_rows(out)

        t0 = time.perf_counter()
        plain = single(apply_ops_batch_ref)
        plain_seconds = time.perf_counter() - t0
        row = {"seg_shards": LONG_DOC_SEG, "s_local": s_local, "S": S,
               "ops": n_ops, "live_rows": len(rows),
               "max_shard_count": int(state.count.max()),
               "rebalances": rebalances, "sharded_seconds": sharded_seconds,
               "plain_seconds": plain_seconds}
        if rows != plain:
            fail(f"long_doc S={S}: the sharded apply differs from the "
                 "plain single-doc apply")
        if S <= cuda_apply.MAX_SLOTS:
            t0 = time.perf_counter()
            if single(cuda_apply.apply_ops_batch) != rows:
                fail(f"long_doc S={S}: the sharded apply differs from B1")
            row["b1_seconds"] = time.perf_counter() - t0
        elif len(rows) <= s_local:
            fail(f"long_doc S={S}: {len(rows)} live rows fit one shard")
        if rebalances == 0:
            fail(f"long_doc S={S}: the stream never rebalanced")
        cases.append(row)
    emit({"phase": "long_doc", "cases": cases, "card": power})


SOAK_SEEDS = (0, 7, 42)


def phase_soak(power: str, device: str = "cuda"):
    """Chaos soak phase A (quick) at seeds 0, 7 and 42 with the device
    stage's applier on ``device``: each run must end green, cover every
    class phase A injects and show a recovery for each injected fault
    (``run_soak`` raises otherwise), and launch B1. Returns B1's
    launches over the three runs."""
    from fluidframework_tpu_torch.chaos.soak import (
        BOUNDARY_REQUIRED,
        run_soak,
    )
    from fluidframework_tpu_torch.ops import cuda_apply

    runs, total = [], 0
    for seed in SOAK_SEEDS:
        if device == "cuda":
            torch.cuda.synchronize()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run_soak(seed, quick=True, phases="a", device=device)
        seconds = time.perf_counter() - t0
        launches = cuda_apply.LAUNCHES
        missing = set(BOUNDARY_REQUIRED) - set(out["coverage"])
        if missing or launches == 0:
            fail(f"soak seed {seed}: classes {sorted(missing)} not "
                 f"covered, {launches} kernel launches")
        counters = out["counters"]
        runs.append({"seed": seed, "coverage": out["coverage"],
                     "observed": out["observed"],
                     "redelivered": out["redelivered"],
                     "injected": {k[len("chaos.injected."):]: v
                                  for k, v in counters.items()
                                  if k.startswith("chaos.injected.")},
                     "recovered": {k[len("chaos.recovered."):]: v
                                   for k, v in counters.items()
                                   if k.startswith("chaos.recovered.")},
                     "launches": launches, "seconds": seconds})
        total += launches
    emit({"phase": "soak", "runs": runs, "launches": total,
          "card": power})
    return total


def phase_replay(power: str, device: str = "cuda"):
    """The replay tool on the three recorded docs of ``tests/corpus``:
    ``replay_through_applier`` on the card (its default farm: S=512, so
    B1's multi-warp path) must give each ``expect.json``'s final text, and
    ``replay_and_compare`` (the client stack) its fingerprints. Returns
    B1's launches."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.replay import (
        replay_and_compare,
        replay_through_applier,
    )

    corpus = os.path.join(HERE, "tests", "corpus", "corpus")
    names = sorted(os.listdir(corpus))
    if not names:
        fail("replay: the corpus is empty")
    expect = {}
    for name in names:
        with open(os.path.join(corpus, name, "expect.json")) as f:
            expect[name] = json.load(f)
    if device == "cuda":
        torch.cuda.synchronize()
    cuda_apply.LAUNCHES = 0
    t0 = time.perf_counter()
    texts = {n: replay_through_applier(os.path.join(corpus, n),
                                       device=device) for n in names}
    applier_seconds = time.perf_counter() - t0
    launches = cuda_apply.LAUNCHES
    bad = [n for n in names if texts[n] != expect[n]["final_text"]]
    if bad:
        fail(f"replay: the farm's text of {bad} differs from expect.json")
    if launches < len(names):
        fail(f"replay: {launches} kernel launches for {len(names)} docs")
    t0 = time.perf_counter()
    problems = {n: replay_and_compare(os.path.join(corpus, n), expect[n])
                for n in names}
    stack_seconds = time.perf_counter() - t0
    problems = {n: p for n, p in problems.items() if p}
    if problems:
        fail(f"replay: fingerprints differ from expect.json: {problems}")
    row = {"phase": "replay", "docs": names,
           "ops": {n: expect[n]["last_seq"] for n in names},
           "applier_seconds": applier_seconds,
           "client_stack_seconds": stack_seconds, "launches": launches,
           "texts_match": True, "fingerprints_match": True, "card": power}
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
    seconds = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        try:
            return phase(*args)
        finally:
            seconds[phase.__name__[len("phase_"):]] = \
                time.perf_counter() - t0

    launches = timed(phase_main_path, power)
    timed(phase_escalation)
    service_launches, app, cpu_texts, service_row = timed(
        phase_service, name, power)
    launches += service_launches
    launches += timed(phase_checkpoint, app, power)
    launches += timed(phase_stage, cpu_texts, power)
    timed(phase_split, cpu_texts, service_row, power)
    summary_launches, _, held = timed(phase_summary, power)
    launches += summary_launches
    try:
        launches += timed(phase_history, held, power)
    finally:
        held.card.close()  # re-raises a worker exception: the run fails
    launches += timed(phase_soak, power)
    launches += timed(phase_replay, power)
    launches += timed(phase_mesh, power)
    timed(phase_long_doc, power)
    emit({"phase": "seconds", **seconds})

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
