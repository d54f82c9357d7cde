"""Chip smoke of the PyTorch / CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``fluidframework_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds it exactly against its plain PyTorch
version on the card at the main path's shapes and on six more cases that
reach its other paths (S from 16 to 1024, overflow), then drives the
replica farm
(``GpuDocumentApplier`` at D=1024 docs, S=256 slots, K=32 ops per wave)
through its entry points and checks every doc's text. ``farms`` then
feeds the same farm width 1,024 docs of the merge-tree convergence farms'
sessions (conflict, inserts and removes, reconnect, reconnect storm,
long-document growth; six spawned host processes make them and hold a
CPU reference farm) and holds every doc, text and rich text, against its
session's clients and the CPU farm, escalations doc by doc. Then it
drives the service path: ``service/load_gen.run_inproc`` (clients →
LocalServer → deli → scriptorium, scribe, broadcaster) at 1024 docs × 2
clients × 48 ops
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
Then the client application layer: ``apps`` makes 1024 app documents
(BASELINE config 1: the shared-text ``DataObject`` with a root
``SharedDirectory``, a title ``SharedCell``, a body ``SharedString`` and
a ``SharedCounter``) of 2 clients each, whose body streams the async card
farm (D=1024, S=256, K=32) ingests round by round, held row for row
against a CPU applier and text for text against both clients; the
service summarizer refuses every app doc, and each doc's client summary
boots a third container. It then runs BASELINE config 3 (a 1000 x 1000
``SharedMatrix``, 8 clients, concurrent cell edits and a row insert, an
undo and a redo) and the corpus recorder (``replay.record``) with its
three replays on the card, whose ``expect.json`` files must equal the
committed corpus's.
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
Then the network tier: ``network`` runs the production composition as
processes of the port (the core ``service.front_end --log-dir
--consume-backchannel``, two native ``service.gateway`` relays, the
applier stage child on the card at D=1024, S=256) under four
``service.load_async`` workers (1024 docs x 2 clients, half through the
gateways, 98,304 ops at 4 Hz), then holds the stage's farm against a CPU
applier fed the core's durable log, boots 64 summarized docs over the
network and replays three fetched live docs on the card and the CPU.
Then the storage tier: ``storage`` runs the service run on a
``LocalServer`` over a ``DurableLog`` and the native chunk store, writes
1024 summaries from the card, and reopens both directories in a fresh
server (heads, 1024 boots, the history plane's ``.hist`` files, object
ids equal to a CPU-written store); then the full production composition
as processes of the port (``service.storage_server``, the core with
``--storage-server --external-scribe``, the scribe stage, two applier
stage children on the card at ``--partition k/2``, a native gateway)
under the socket load at 0.4 Hz and 8 real containers that summarize:
the scribe process acks, the refs advance in the storage process and
survive its restart, and both stages reach their tails with farms equal
to a CPU applier's.
Then the overload, health and recovery plane: ``overload`` runs a core
with a rated flood tenant, the SLO engine and the canary prober
(``--tenant-rate --slo --probe``) beside the applier stage child on the
card, the steady tenant's socket load in three windows and, ten seconds
into the second, 8 driver clients flooding at ten times their budget; it
checks health ``ok`` before and after, the flood tenant's SLO going from
ok to violated during the flood, sheds on the flood tenant only, every op of both tenants acked, the farm
against a CPU applier fed the whole log and every doc's log through the
invariant monitor. ``campaigns`` runs ``chaos.noisy``, ``coldstart``,
``multihost`` and soak phase B in full at seed 0.
Then the operator and developer surface: ``host_admin`` runs the
port's dev host (``python -m fluidframework_tpu_torch.host``) for each
of the seven apps on its topology, and beside it one core with its
admin secret, journal and health engine and the applier stage child on
the card (D=1024, S=256) under one round of the network phase's load,
read through the port's ``admin`` CLI (``monitor`` while ops are in
flight and until every doc's applier lag is 0, ``docs``, ``status``,
tenant CRUD with and without the secret, ``metrics``, ``journal``,
``slo``, ``health``, ``flight dump``, ``bundle``) and the port's offline
doctor; the stage's farm is held against a CPU applier.
Each phase prints one JSON line (the last one, each phase's seconds); any
failure exits nonzero. Before the last line it prints
the kernel table (``{"kernels": [...]}``) and the card's name and power
limit as ``nvidia-smi`` reports them; the last line is
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import shutil
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


FARM_DOCS = 1024
FARM_GROWTH_DOCS = 16
FARM_GEO = dict(max_docs=1024, max_slots=256, ops_per_dispatch=32)
# past the JAX farm tests' own seeds (conflict 1-7, inserts/removes 0-7,
# reconnect 0-5, storm 0-5, growth 42)
FARM_FIRST_SEED = 100
# a worker past this many seconds of generation makes no new session:
# its other docs repeat its earlier sessions under their own doc ids
FARM_GEN_BUDGET_S = 45.0
# host processes that make the sessions and hold the CPU reference farm
FARM_WORKERS = 6
FARM_FAMILIES = ("conflict", "inserts_removes", "reconnect", "storm")


def farm_plan(n_docs: int, n_growth: int) -> list:
    """[(doc, family, seed)]: ``n_growth`` growth docs, the rest dealt in
    turn to the conflict, inserts and removes, reconnect and
    reconnect-storm farms."""
    plan = [(f"farm{i}", "growth", FARM_FIRST_SEED + i)
            for i in range(n_growth)]
    for k in range(n_docs - n_growth):
        plan.append((f"farm{n_growth + k}",
                     FARM_FAMILIES[k % len(FARM_FAMILIES)],
                     FARM_FIRST_SEED + k // len(FARM_FAMILIES)))
    return plan


def _farm_worker(conn, plan: list, budget_s: float) -> None:
    """One host process of the farms phase: make the sessions of ``plan``
    and send (doc, family, seed, log, text, rich text, repeat) for each,
    then feed the same logs to a CPU applier and send its docs' text,
    rich text and escalations, its applied rows and seconds."""
    torch.set_num_threads(1)
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.testing import farm

    t0 = time.perf_counter()
    made = []
    for doc, family, seed in plan:
        if len(made) and time.perf_counter() - t0 > budget_s:
            _, family, seed, log, text, rich, _ = made[len(made) % len(
                [m for m in made if not m[-1]])]
            made.append((doc, family, seed, log, text, rich, True))
            continue
        log, clients = getattr(farm, f"{family}_session")(seed)
        made.append((doc, family, seed, log, clients[0].text(),
                     clients[0].rich_text(), False))
    conn.send((made, time.perf_counter() - t0))
    t1 = time.perf_counter()
    logs = {m[0]: m[3] for m in made}
    app = GpuDocumentApplier(device="cpu", max_docs=len(plan),
                             max_slots=FARM_GEO["max_slots"],
                             ops_per_dispatch=FARM_GEO["ops_per_dispatch"])
    app.set_replay_source(lambda t, d: logs[d])
    for doc, log in logs.items():
        app.ingest_batch("t", doc, [(m, m.contents) for m in log])
    app.finalize()
    docs = {}
    for doc in logs:
        tree = app.get_tree("t", doc)
        docs[doc] = (tree.get_text(), farm.rich_text(tree),
                     app.slot_of("t", doc) in app._host_docs)
    conn.send({"docs": docs, "ops_applied": app.ops_applied,
               "seconds": time.perf_counter() - t1})
    conn.close()


def phase_farms(power: str, device: str = "cuda"):
    """The merge-tree farms' streams (conflict, inserts and removes,
    reconnect, reconnect storm, long-document growth) through the card
    farm at the main path's width: every doc equals its session's
    converged clients (text and rich text) and a CPU applier fed the same
    logs (held by ``FARM_WORKERS`` host processes, which also make the
    sessions), with the same escalations doc by doc."""
    import multiprocessing

    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
    )
    from fluidframework_tpu_torch.testing.farm import rich_text

    t_phase = time.perf_counter()
    plan = farm_plan(FARM_DOCS, FARM_GROWTH_DOCS)
    ctx = multiprocessing.get_context("spawn")
    workers = []
    try:
        for w in range(FARM_WORKERS):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_farm_worker, daemon=True, args=(
                theirs, plan[w::FARM_WORKERS], FARM_GEN_BUDGET_S))
            proc.start()
            theirs.close()
            workers.append((proc, ours))
        sessions, worker_gen = {}, []
        for _, conn in workers:
            made, seconds = conn.recv()
            worker_gen.append(seconds)
            sessions.update((m[0], m) for m in made)
        gen_seconds = time.perf_counter() - t_phase
        docs = [doc for doc, _, _ in plan]
        logs = {doc: sessions[doc][3] for doc in docs}
        rows = {doc: sum(device_rows(m.contents) for m in logs[doc])
                for doc in docs}

        cuda_apply.LAUNCHES = 0
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = GpuDocumentApplier(device=device, **FARM_GEO)
        card.set_replay_source(lambda t, d: logs[d])
        for doc in docs:
            card.ingest_batch("t", doc,
                              [(m, m.contents) for m in logs[doc]])
        t1 = time.perf_counter()
        card.finalize()
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = cuda_apply.LAUNCHES

        ref, cpu_applied, cpu_seconds = {}, 0, []
        for _, conn in workers:
            out = conn.recv()
            ref.update(out["docs"])
            cpu_applied += out["ops_applied"]
            cpu_seconds.append(out["seconds"])
        t3 = time.perf_counter()
    finally:
        for proc, conn in workers:
            conn.close()
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    if any(proc.exitcode != 0 for proc, _ in workers):
        fail(f"farms: a host worker exited "
             f"{[proc.exitcode for proc, _ in workers]}")

    esc_card = set()
    for doc in docs:
        _, family, seed, _, want_text, want_rich, _ = sessions[doc]
        tree = card.get_tree("t", doc)
        got = (tree.get_text(), rich_text(tree))
        if got != (want_text, want_rich):
            fail(f"farms: {doc} ({family} seed {seed}) on the card "
                 "differs from its session's clients")
        if ref[doc][:2] != got:
            fail(f"farms: {doc} ({family} seed {seed}) on the card "
                 "differs from the CPU applier")
        if card.slot_of("t", doc) in card._host_docs:
            esc_card.add(doc)
    esc_cpu = {doc for doc in docs if ref[doc][2]}
    if esc_card != esc_cpu or card.host_escalations != len(esc_card):
        fail(f"farms: escalations differ: card {sorted(esc_card)}, cpu "
             f"{sorted(esc_cpu)}")
    total_rows = sum(rows.values())
    if card.ops_applied != total_rows or cpu_applied != total_rows:
        fail(f"farms: the card applied {card.ops_applied} rows, the CPU "
             f"applier {cpu_applied}, of {total_rows} fed")
    if device == "cuda" and (launches != card.dispatches or launches == 0):
        fail(f"farms: {launches} kernel launches for {card.dispatches} "
             "dispatches")
    families, esc_families = {}, {}
    for doc, family, _ in plan:
        families[family] = families.get(family, 0) + 1
        if doc in esc_card:
            esc_families[family] = esc_families.get(family, 0) + 1
    msgs = [m for log in logs.values() for m in log]
    emit({"phase": "farms", "docs": len(docs),
          "slots": FARM_GEO["max_slots"], "K": FARM_GEO["ops_per_dispatch"],
          "sessions": families,
          "distinct_sessions": sum(not s[-1] for s in sessions.values()),
          "ops": len(msgs), "rows": total_rows,
          "group_ops": sum(m.contents.get("type") == 3 for m in msgs),
          "stale_refseq_ops": sum(m.reference_sequence_number
                                  < m.sequence_number - 1 for m in msgs),
          "generate_seconds": gen_seconds,
          "worker_generate_seconds": max(worker_gen),
          "feed_seconds": t1 - t0, "finalize_seconds": t2 - t1,
          "cpu_reference_wait_seconds": t3 - t2,
          "cpu_reference_seconds": max(cpu_seconds),
          "check_seconds": time.perf_counter() - t3,
          "dispatches": card.dispatches, "launches": launches,
          "host_escalations": card.host_escalations,
          "escalated_by_family": esc_families, "ops_applied":
          card.ops_applied, "phase_seconds": time.perf_counter() - t_phase,
          "card": power})
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
                 err_path: str, what: str = "split"):
        self.state_dir, self.what = state_dir, what
        self.started = time.perf_counter()
        self.err = open(err_path, "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "fluidframework_tpu_torch.service.stage_runner", "--stage",
             "applier", "--log-dir", log_dir, "--state-dir", state_dir,
             "--device", device,
             "--max-docs", str(SERVICE_GEO["max_docs"]),
             "--max-slots", str(SERVICE_GEO["max_slots"])],
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
            fail(f"{what}: the stage process did not print READY "
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
            fail(f"{self.what}: the stage process exited "
                 f"({self.proc.returncode})")
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
                fail(f"{self.what}: the stage did not catch up in "
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


def _state_rows(app, n_docs: int, tenant: str = "t") -> dict:
    """Every doc's state row, read back once: field -> [n_docs, ...]."""
    from fluidframework_tpu_torch.ops.doc_state import FIELDS

    app.finalize()
    rows = np.array([app.slot_of(tenant, f"doc{d}")
                     for d in range(n_docs)])
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
        PHASE_A_REQUIRED,
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
    missing = set(PHASE_A_REQUIRED) - set(out["coverage"])
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
        PHASE_A_REQUIRED,
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
        missing = set(PHASE_A_REQUIRED) - set(out["coverage"])
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


#: the apps phase: BASELINE config 1 at the farm's width. 1024 app docs
#: (the shared-text DataObject: root directory, title cell, body string,
#: edits counter) x 2 clients, APPS_ROUNDS rounds of one concurrent body
#: edit a client, then the title, a root key and the counter; the card
#: farm ingests every body stream after each round
APPS_DOCS = 1024
APPS_ROUNDS = 24
APPS_SEED = 12
#: the refusal of an app document by the service summarizer
#: (``tests/test_torch_apps.py`` pins it equal to the JAX package's)
APPS_REFUSAL = ("doc apps/doc0 has ops for default/root the device does "
                "not model — keep client summaries")
#: BASELINE config 3: one 1000 x 1000 SharedMatrix, 8 clients, 5 rounds
#: of 5 concurrent cell edits a client, a concurrent insert_rows(500, 2)
#: in round 2 (tests/test_dds_catalog.py's 1k x 1k case)
MATRIX_SHAPE = (1000, 1000)
MATRIX_CLIENTS = 8
MATRIX_ROUNDS = 5
MATRIX_EDITS = 5


def _apps_docs(device: str) -> dict:
    """Part 1 of the apps phase (BASELINE config 1): returns its row."""
    from fluidframework_tpu_torch import framework
    from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
        channel_stream,
    )
    from fluidframework_tpu_torch.service.local_server import LocalServer
    from fluidframework_tpu_torch.service.service_summarizer import (
        ServiceSummarizer,
    )
    from fluidframework_tpu_torch.testing.apps import (
        app_factory,
        app_view,
        edit_app_docs,
        feed_bodies,
        open_app_docs,
    )

    docs = [f"doc{d}" for d in range(APPS_DOCS)]
    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    factory = app_factory(framework)
    t0 = time.perf_counter()
    apps = open_app_docs(loader, factory, "apps", docs)
    open_seconds = time.perf_counter() - t0

    card = GpuDocumentApplier(device=device, async_dispatch=True,
                              **SERVICE_GEO)
    # the CPU reference ingests the same calls in the same order: the
    # farms intern annotate values in ingest order, so only a farm fed
    # the same way holds the same prop_val ids
    cpu = GpuDocumentApplier(device="cpu", **SERVICE_GEO)
    cpu.set_replay_source(lambda t, d: [])
    fed = []
    seconds = {"card_feed": 0.0, "cpu_feed": 0.0}

    def feed_both():
        t = time.perf_counter()
        fed.append(feed_bodies(server, card, "apps", docs, channel_stream))
        t1 = time.perf_counter()
        feed_bodies(server, cpu, "apps", docs, channel_stream)
        seconds["card_feed"] += t1 - t
        seconds["cpu_feed"] += time.perf_counter() - t1

    try:
        if device == "cuda":
            torch.cuda.synchronize()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        ops = edit_app_docs(server, apps, APPS_ROUNDS, APPS_SEED,
                            after_round=feed_both)
        t = time.perf_counter()
        card.finalize()  # re-raises a worker exception: the phase fails
        seconds["card_feed"] += time.perf_counter() - t
        # the run's wall time without the CPU reference's share
        wall = time.perf_counter() - t0 - seconds["cpu_feed"]
        launches = cuda_apply.LAUNCHES
        dispatches = card.dispatches
        card_rows = _state_rows(card, APPS_DOCS, tenant="apps")
        card_texts = [card.get_text("apps", d) for d in docs]
        escalations = card.host_escalations
    finally:
        card.close()
    if launches != dispatches or launches == 0:
        fail(f"apps: {launches} kernel launches for {dispatches} dispatches")
    if escalations:
        fail(f"apps: {escalations} host escalations on the card farm")

    cpu_rows = _state_rows(cpu, APPS_DOCS, tenant="apps")
    bad = [f for f in cpu_rows if not np.array_equal(cpu_rows[f],
                                                      card_rows[f])]
    if bad:
        fail(f"apps: the card farm's state rows differ from the CPU "
             f"applier's in {bad}")
    views = {d: [app_view(obj) for _, obj in apps[d]] for d in docs}
    bad = [d for d, text in zip(docs, card_texts)
           if cpu.get_text("apps", d) != text
           or [v["body"] for v in views[d]] != [text, text]
           or views[d][0] != views[d][1]]
    if bad:
        fail(f"apps: {len(bad)} docs' farm text differs from their "
             f"clients' bodies or the clients differ (first {bad[0]})")
    if not all(card_texts):
        fail("apps: a doc's body is empty")

    svc = ServiceSummarizer(server, card, channel_id="body")
    written = svc.summarize_all("apps", docs)
    refused = {d: m for _t, d, m in svc.refusals}
    bad = [d for d in docs
           if refused.get(d) != APPS_REFUSAL.replace("doc0", d)]
    if written or bad:
        fail(f"apps: the service summarizer wrote {written} app docs and "
             f"refused {len(refused)}; first unexpected {bad[:1]}: "
             f"{refused.get(bad[0]) if bad else None}")

    t0 = time.perf_counter()
    for d in docs:
        container, obj = apps[d][0]
        SummaryManager(container, max_ops=10**9).summarize_now()
        joiner = loader.resolve("apps", d)
        if joiner._base_snapshot is None or \
                app_view(factory.create_or_load(joiner)) != views[d][0]:
            fail(f"apps: {d}'s third container did not boot from the "
                 "client summary or reads other channels")
        joiner.close()
    boot_seconds = time.perf_counter() - t0
    body_ops = sum(fed)
    return {"docs": APPS_DOCS, "clients_per_doc": 2,
            "rounds": APPS_ROUNDS, "ops": ops, "body_ops": body_ops,
            "open_seconds": open_seconds, "seconds": wall,
            "ops_per_sec": ops / wall,
            "farm_feed_seconds": seconds["card_feed"],
            "farm_ops_per_sec": body_ops / seconds["card_feed"],
            "cpu_farm_feed_seconds": seconds["cpu_feed"],
            "launches": launches, "dispatches": dispatches,
            "max_body_chars": max(len(t) for t in card_texts),
            "refused": len(refused), "boot_seconds": boot_seconds}


def _apps_matrix() -> dict:
    """Part 2 of the apps phase (BASELINE config 3, host code): returns
    its row."""
    from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
    from fluidframework_tpu_torch.framework import UndoRedoStackManager
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.local_server import LocalServer
    from fluidframework_tpu_torch.testing.apps import matrix_cells

    rows, cols = MATRIX_SHAPE
    server = LocalServer()
    loader = Loader(LocalDocumentServiceFactory(server))
    rng = random.Random(33)
    t0 = time.perf_counter()
    c0 = loader.resolve("t", "grid")
    m0 = c0.runtime.create_data_store("default").create_channel(
        "grid", "shared-matrix")
    m0.insert_rows(0, rows)
    m0.insert_cols(0, cols)
    clients = [c0] + [loader.resolve("t", "grid")
                      for _ in range(MATRIX_CLIENTS - 1)]
    mats = [c.runtime.get_data_store("default").get_channel("grid")
            for c in clients]
    server._auto_drain = False
    server.drain()
    edits = 0
    for round_ in range(MATRIX_ROUNDS):
        for i, m in enumerate(mats):
            for _ in range(MATRIX_EDITS):
                r, c = rng.randrange(m.row_count), rng.randrange(m.col_count)
                m.set_cell(r, c, f"c{i}r{round_}")
                edits += 1
        if round_ == 2:
            mats[3].insert_rows(rows // 2, 2)
        server.drain()
    server._auto_drain = True
    server.drain()
    edit_seconds = time.perf_counter() - t0

    # undo and redo one client's edit through the matrix's undo provider
    mgr = UndoRedoStackManager()
    mgr.attach_matrix(mats[1])
    before = mats[1].get_cell(7, 7)
    mats[1].set_cell(7, 7, "undo-me")
    mgr.close_current_operation()
    undone = mgr.undo() and all(m.get_cell(7, 7) == before for m in mats)
    redone = mgr.redo() and all(m.get_cell(7, 7) == "undo-me"
                                for m in mats)
    if not (undone and redone):
        fail(f"apps: matrix undo {undone}, redo {redone} across "
             f"{MATRIX_CLIENTS} clients")

    t1 = time.perf_counter()
    ref = matrix_cells(mats[0])
    bad = [i for i, m in enumerate(mats) if matrix_cells(m) != ref]
    if bad or ref[:2] != [rows + 2, cols]:
        fail(f"apps: matrix clients {bad} differ from client 0, whose "
             f"shape is {ref[:2]}")
    lists = mats[0].to_lists()
    dense = sorted([r, c, v] for r, row in enumerate(lists)
                   for c, v in enumerate(row) if v is not None)
    if dense != ref[2] or len(dense) < 100:
        fail(f"apps: client 0's to_lists holds {len(dense)} cells, its "
             f"sparse view {len(ref[2])}")
    return {"shape": ref[:2], "clients": MATRIX_CLIENTS,
            "cell_edits": edits, "cells_set": len(dense),
            "edit_seconds": edit_seconds,
            "check_seconds": time.perf_counter() - t1,
            "seconds": time.perf_counter() - t0, "undo_redo": True}


def _apps_recorder(device: str) -> dict:
    """Part 3 of the apps phase: the corpus recorder with its replays on
    ``device``, under the committed corpus's client-id epochs, so that
    each ``expect.json`` (fingerprints included) must equal the committed
    one byte for byte. Returns its row."""
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.replay import record

    corpus = os.path.join(HERE, "tests", "corpus", "corpus")
    epochs = {}
    for name in record.SCENARIOS:
        with open(os.path.join(corpus, name, "messages.json")) as f:
            epochs[name] = json.load(f)[0]["contents"]["clientId"] \
                .split("-")[1]
    with _scratch_dir() as out:
        if device == "cuda":
            torch.cuda.synchronize()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            # asserts each replay's text (the farm's on ``device`` and
            # the client stack's) against the scenario's live text
            record.record_all(out, device=device, epochs=epochs)
        except AssertionError as e:
            fail(f"apps: recorder: {e}")
        seconds = time.perf_counter() - t0
        launches = cuda_apply.LAUNCHES
        differ = []
        for name in record.SCENARIOS:
            with open(os.path.join(out, "corpus", name, "expect.json"),
                      "rb") as f:
                got = f.read()
            with open(os.path.join(corpus, name, "expect.json"), "rb") as f:
                if f.read() != got:
                    differ.append(name)
    if differ:
        fail(f"apps: recorded expect.json of {differ} differs from the "
             "committed corpus")
    if launches < len(record.SCENARIOS):
        fail(f"apps: recorder: {launches} kernel launches for "
             f"{len(record.SCENARIOS)} replays")
    return {"scenarios": sorted(record.SCENARIOS), "seconds": seconds,
            "launches": launches, "device_texts_match": True,
            "expect_json_match_committed": True}


def phase_apps(power: str, device: str = "cuda"):
    """The client application layer on the card's machine, in three
    parts. ``docs``: BASELINE config 1 at the farm's width, 1024 app
    documents (the shared-text DataObject with its root directory, a
    title cell, a body string and a counter) of 2 clients, whose body
    streams the async card farm (D=1024, S=256, K=32) ingests after each
    round; its state rows equal a CPU applier's, every farm text both
    clients' body; the service summarizer refuses every app doc with
    ``APPS_REFUSAL``; each doc's client summary boots a third container
    that reads its title, root key, counter and body.
    ``matrix``: BASELINE config 3 (host code): a 1000 x 1000 SharedMatrix,
    8 clients, concurrent cell edits and row inserts, an undo and a redo,
    all 8 converged to 1002 x 1000. ``recorder``: ``replay.record``
    records the three corpus scenarios and replays each on the card.
    Returns B1's launches in the phase."""
    docs = _apps_docs(device)
    matrix = _apps_matrix()
    recorder = _apps_recorder(device)
    launches = docs["launches"] + recorder["launches"]
    emit({"phase": "apps", "docs": docs, "matrix": matrix,
          "recorder": recorder, "launches": launches, "card": power})
    return launches


#: the network phase: the service run's width over sockets. Four
#: load_async workers of 256 docs x 2 clients, two through the gateways
#: and two direct, 4 boxcars of 12 a client at 4 Hz (98,304 ops)
NETWORK_RUN = dict(workers=4, docs_per_worker=256, clients_per_doc=2,
                   rounds=4, batch=12, rate=4.0)
#: wall seconds between the last worker's CONNECTED and the start instant
#: handed to every worker (the barrier of ``load_async --start-gate``)
NETWORK_START_MARGIN_S = 1.0
NETWORK_BOOTS = 64
NETWORK_FETCHES = 3


def _spawn_ready(args: list, ready: str, err_path: str, what: str):
    """A ``python -m`` child of the port; returns (process, its readiness
    line) once it prints ``ready``, or fails the phase (``what`` names the
    phase and the child)."""
    err = open(err_path, "a")
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    line = []
    reader = threading.Thread(
        target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(CHILD_TIMEOUT_S)
    if not line or not line[0].startswith(ready):
        proc.kill()
        proc.wait(timeout=60)
        fail(f"{what} did not print {ready} (got {line}, rc "
             f"{proc.poll()}); stderr in {err_path}")
    return proc, line[0].strip()


def _pct(vals: list, p: float) -> float:
    vals = sorted(vals)
    return vals[int(p * (len(vals) - 1))] if vals else 0.0


def _network_statuses(rpc, docs: list, tenant: str = "bench") -> dict:
    """doc → (seq at the core, applierSeq) from the core's status RPC."""
    out = {}
    for doc in docs:
        st = rpc.request({"t": "admin_status", "tenant": tenant,
                          "doc": doc})["status"]
        out[doc] = (st["seq"], st["applierSeq"])
    return out


def _settled_seqs(rpc, docs: list, phase: str) -> dict:
    """doc → its seq at the core once every doc's applierSeq is at it and
    two reads half a second apart agree (a closed client's leave is
    sequenced after its socket closes)."""
    deadline = time.time() + CHILD_TIMEOUT_S
    last = None
    while True:
        status = _network_statuses(rpc, docs)
        if status == last and all(s == a for s, a in status.values()):
            return {d: s for d, (s, _) in status.items()}
        if time.time() > deadline:
            moving = [d for d in docs if status[d][0] != status[d][1]
                      or last is None or status[d] != last[d]]
            fail(f"{phase}: the docs' seqs did not settle with their "
                 f"applierSeq (first {moving[0]}: {status[moving[0]]})")
        last = status
        time.sleep(0.5)


def _cpu_seconds(pid: int) -> float:
    """User plus system CPU seconds a process has used so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _run_load(run: dict, ports: list, prefix: str, servers: dict,
              procs: list, err_path: str, phase: str, during=None,
              trace_sample_n: int = 16):
    """``run["workers"]`` ``load_async`` workers (worker ``w`` on
    ``ports[w]``, docs ``<prefix><w>d<k>``) behind the start barrier: each
    connects all its clients and prints ``CONNECTED``; only then is one
    start instant handed to all of them. ``during()``, when given, runs on
    this thread once the instant is handed out. Fails the phase on a
    worker that does not connect, fails or leaves an op unacked. Returns
    (the row's load fields, the last ack's wall time); the first two
    workers' latencies are the gateway's, the others direct. Appends the
    workers to ``procs``; ``servers`` names the pids whose CPU seconds over
    the load window the row reports. Each client samples every
    ``trace_sample_n``-th boxcar's hops (the workers' default, 16)."""
    t0 = time.perf_counter()
    workers = []
    for w in range(run["workers"]):
        wp = subprocess.Popen(
            [sys.executable, "-m",
             "fluidframework_tpu_torch.service.load_async",
             "--port", str(ports[w]),
             "--docs", str(run["docs_per_worker"]),
             "--clients-per-doc", str(run["clients_per_doc"]),
             "--rounds", str(run["rounds"]),
             "--batch", str(run["batch"]),
             "--rate", str(run["rate"]), "--seed", str(w),
             "--start-gate", "--timeout", "180",
             "--trace-sample-n", str(trace_sample_n),
             "--doc-prefix", f"{prefix}{w}d"],
            cwd=HERE, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=open(err_path, "a"), text=True)
        procs.append(wp)
        workers.append(wp)
    said = [[] for _ in workers]
    readers = [threading.Thread(
        target=lambda wp=wp, got=got: got.append(
            wp.stdout.readline()), daemon=True)
        for wp, got in zip(workers, said)]
    for r in readers:
        r.start()
    for r in readers:
        r.join(max(1.0, CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
    for w, got in enumerate(said):
        if not got or got[0].strip() != "CONNECTED":
            fail(f"{phase}: load worker {w} did not connect (got {got}, rc "
                 f"{workers[w].poll()}); stderr in {err_path}")
    row = {"connect_seconds": time.perf_counter() - t0}
    # the servers' CPU over the load alone (connects excluded): a busy
    # share near 1 is a saturated loop
    cpu0 = {k: _cpu_seconds(pid) for k, pid in servers.items()}
    start_at = time.time() + NETWORK_START_MARGIN_S
    for wp in workers:
        wp.stdin.write(f"{start_at!r}\n")
        wp.stdin.close()
    if during is not None:
        during()
    results = []
    for w, wp in enumerate(workers):
        out = wp.stdout.read()
        wp.wait(timeout=300)
        if wp.returncode != 0 or not out.strip():
            fail(f"{phase}: load worker {w} failed (rc {wp.returncode}); "
                 f"stderr in {err_path}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    cpu1 = {k: _cpu_seconds(pid) for k, pid in servers.items()}
    for w, r in enumerate(results):
        if r["acked"] != r["ops"] or r["errors"]:
            fail(f"{phase}: worker {w} acked {r['acked']} of {r['ops']} "
                 f"ops ({r['errors'][:2]})")
    ops = sum(r["ops"] for r in results)
    if ops != run["workers"] * run["docs_per_worker"] \
            * run["clients_per_doc"] * run["rounds"] * run["batch"]:
        fail(f"{phase}: {ops} ops submitted")
    # all the work over the whole window: the earliest first submit to the
    # last ack of any worker
    last_ack = max(r["ended_at"] for r in results)
    seconds = last_ack - min(r["started_at"] for r in results)
    late_s = max(r["late_s"] for r in results)
    lat = [x for r in results for x in r["lat_ms"]]
    gw_lat = [x for r in results[:2] for x in r["lat_ms"]]
    direct_lat = [x for r in results[2:] for x in r["lat_ms"]]
    row.update(
        ops=ops, seconds=seconds, ops_per_sec=ops / seconds,
        late_s=late_s, tainted=late_s > 0,
        shed=sum(r["shed"] for r in results),
        p50_ack_ms=_pct(lat, 0.50), p99_ack_ms=_pct(lat, 0.99),
        direct_p50_ack_ms=_pct(direct_lat, 0.50),
        direct_p99_ack_ms=_pct(direct_lat, 0.99),
        gateway_p50_ack_ms=_pct(gw_lat, 0.50),
        gateway_p99_ack_ms=_pct(gw_lat, 0.99))
    # the sampled boxcars' hop legs (every 16th boxcar a client)
    hops: dict = {}
    for r in results:
        for name, vals in r["hops"].items():
            hops.setdefault(name, []).extend(vals)
    row["hops"] = {name: {"count": len(v), "p50_ms": _pct(v, 0.5),
                          "p99_ms": _pct(v, 0.99)}
                   for name, v in sorted(hops.items())}
    row["load_window_seconds"] = seconds
    row["cpu_seconds"] = {k: cpu1[k] - cpu0[k] for k in servers}
    return row, last_ack


def phase_network(power: str, device: str = "cuda"):
    """The production composition over sockets, every process the
    port's: the core (``front_end --log-dir L --consume-backchannel S``),
    two native gateways (``gateway --core-port P``), the applier stage
    child on the card (``stage_runner --stage applier --device cuda`` at
    D=1024, S=256) and four ``load_async`` workers. Checks: every op
    acked; once quiescent every doc's ``applierSeq`` (the core's status
    RPC) at its seq; the stage's final checkpoint, loaded on the card,
    escalated nothing and equals a CPU applier fed the core's durable
    log; 64 docs summarized by the core and booted by network loaders
    (one through a gateway) read those texts; three live docs fetched
    with ``replay.fetch`` replay through ``replay_through_applier`` on
    the card to the texts of a CPU replay. Returns B1's launches of those
    replays (the stage child's launches are its own)."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
        _Transport,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.obs import parse_prometheus
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.replay import replay_through_applier
    from fluidframework_tpu_torch.replay.fetch import fetch_document
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )
    from fluidframework_tpu_torch.service.stage_runner import ApplierStage

    run = NETWORK_RUN
    docs = [f"netw{w}d{d}" for w in range(run["workers"])
            for d in range(run["docs_per_worker"])]
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    err_path = os.path.join(out_dir, "network_stderr.txt")
    procs = []
    row = {"phase": "network", "docs": len(docs), **run}
    t_phase = time.perf_counter()
    try:
        with _scratch_dir() as tmp:
            log_dir, state_dir = (os.path.join(tmp, "log"),
                                  os.path.join(tmp, "state"))
            t0 = time.perf_counter()
            stage, _ = _spawn_ready(
                ["fluidframework_tpu_torch.service.stage_runner", "--stage",
                 "applier", "--log-dir", log_dir, "--state-dir", state_dir,
                 "--device", device,
                 "--max-docs", str(SERVICE_GEO["max_docs"]),
                 "--max-slots", str(SERVICE_GEO["max_slots"])],
                "READY", err_path, "network: the applier stage")
            procs.append(stage)
            row["stage_start_seconds"] = time.perf_counter() - t0
            core, line = _spawn_ready(
                ["fluidframework_tpu_torch.service.front_end", "--port", "0",
                 "--log-dir", log_dir, "--consume-backchannel", state_dir],
                "LISTENING", err_path, "network: the core")
            procs.append(core)
            core_port = int(line.rsplit(":", 1)[1])
            t0 = time.perf_counter()
            gw_ports = []
            lib = str(native_build.build("gateway"))
            for _ in range(2):
                gw, line = _spawn_ready(
                    ["fluidframework_tpu_torch.service.gateway",
                     "--core-port", str(core_port)],
                    "LISTENING", err_path, "network: a gateway")
                procs.append(gw)
                gw_ports.append(int(line.rsplit(":", 1)[1]))
                with open(f"/proc/{gw.pid}/maps") as f:
                    if lib not in f.read():
                        fail("network: a gateway does not run the native "
                             f"relay ({lib} not mapped)")
            row["gateways_start_seconds"] = time.perf_counter() - t0
            row["gateways_native"] = True

            # the load: every worker connects all its clients and says
            # so; only then is one start instant handed to all of them,
            # so no worker's trial runs against another's join storm
            ports = [gw_ports[0], gw_ports[1], core_port, core_port]
            servers = {"core": core.pid, "gateway0": procs[2].pid,
                       "gateway1": procs[3].pid, "stage": stage.pid}
            load, last_ack = _run_load(run, ports, "netw", servers, procs,
                                       err_path, "network")
            row.update(load)

            # quiescence: every doc's applierSeq reaches its seq
            rpc = _Transport("127.0.0.1", core_port, timeout=60.0)
            try:
                while True:
                    status = _network_statuses(rpc, docs)
                    lagging = [d for d, (seq, app) in status.items()
                               if app != seq]
                    if not lagging:
                        break
                    if time.time() - last_ack > CHILD_TIMEOUT_S:
                        fail(f"network: {len(lagging)} docs' applierSeq "
                             f"lag the core (first {lagging[0]}: "
                             f"{status[lagging[0]]})")
                    time.sleep(0.05)
                row["catch_up_lag_seconds"] = time.time() - last_ack
                scrape = parse_prometheus(rpc.request(
                    {"t": "admin_metrics_scrape"})["scrape"])
                hop = {"count": 0}
                for key, v in scrape.get("fluid_obs_hop_ms_count",
                                         {}).items():
                    if dict(key).get("pair") == "stage_to_execute":
                        hop["count"] = int(v)
                for key, v in scrape.get("fluid_obs_hop_ms", {}).items():
                    labels = dict(key)
                    if labels.get("pair") == "stage_to_execute":
                        hop[f"p{round(float(labels['quantile']) * 100)}"
                            "_ms"] = v
                if not hop["count"]:
                    fail("network: the stage reported no stage_to_execute "
                         "hop (no wave ran in the stage child)")
                row["stage_to_execute"] = hop
                counters = rpc.request({"t": "admin_counters"})["counters"]
                row["core_counters"] = {
                    k: counters.get(k) for k in (
                        "net.ingress.frames", "net.ingress.batches",
                        "net.ingress.columnar", "net.flush.performed",
                        "net.fanout.encodes", "net.fanout.cache_hits")}
                stage.send_signal(signal.SIGTERM)
                stage.wait(timeout=60)

                # the stage's farm against a CPU applier fed the core's log
                t0 = time.perf_counter()
                farm = load_applier_checkpoint(
                    os.path.join(state_dir, "applier"), device=device)
                if farm.host_escalations or farm._host_docs:
                    fail("network: the stage escalated docs")
                texts = {d: farm.get_text("bench", d) for d in docs}
                ref = ApplierStage(log_dir, os.path.join(tmp, "cpu"),
                                   max_docs=SERVICE_GEO["max_docs"],
                                   max_slots=SERVICE_GEO["max_slots"],
                                   device="cpu")
                while ref.run_once():
                    pass
                bad = [d for d in docs
                       if ref.applier.get_text("bench", d) != texts[d]]
                if bad:
                    fail(f"network: {len(bad)} docs of the stage's farm "
                         f"differ from the CPU applier (first {bad[0]})")
                ref.shared.close()
                row["farm_check_seconds"] = time.perf_counter() - t0

                # summaries by the core, then network boots of 64 docs
                t0 = time.perf_counter()
                sample = docs[::len(docs) // NETWORK_BOOTS]
                for doc in sample:
                    rpc.request({"t": "admin_summarize", "tenant": "bench",
                                 "doc": doc})
                row["summarize_seconds"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                for i, doc in enumerate(sample):
                    port = gw_ports[0] if i == 0 else core_port
                    c = Loader(NetworkDocumentServiceFactory(
                        "127.0.0.1", port)).resolve("bench", doc)
                    got = c.runtime.get_data_store("default").get_channel(
                        "text").get_text()
                    c.close()
                    if got != texts[doc]:
                        fail(f"network: the boot of {doc} (port {port}) "
                             "reads another text than the stage's farm")
                row["boots"] = len(sample)
                row["boot_seconds"] = time.perf_counter() - t0
            finally:
                rpc.close()

            # three live docs fetched and replayed on the card and the CPU
            fetched = [d for d in (docs[1], docs[len(docs) // 2 + 3],
                                   docs[-1]) if d not in sample]
            if len(fetched) != NETWORK_FETCHES:
                fail("network: a fetched doc is also a summarized one")
            t0 = time.perf_counter()
            dirs = [fetch_document("127.0.0.1", core_port, "bench", d,
                                   os.path.join(tmp, "fetch"))
                    for d in fetched]
            row["fetch_seconds"] = time.perf_counter() - t0
            if device == "cuda":
                torch.cuda.synchronize()
            cuda_apply.LAUNCHES = 0
            card = [replay_through_applier(p, device=device) for p in dirs]
            launches = cuda_apply.LAUNCHES
            cpu = [replay_through_applier(p, device="cpu") for p in dirs]
            for d, a, b in zip(fetched, card, cpu):
                if not (a == b == texts[d]):
                    fail(f"network: the fetched replay of {d} differs "
                         "(card, CPU, stage's farm)")
            if launches < len(dirs):
                fail(f"network: {launches} kernel launches for "
                     f"{len(dirs)} replays")
            row.update(fetched=fetched, replay_launches=launches,
                       texts_match_cpu=True, boots_match=True,
                       replays_match=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
    row["phase_seconds"] = time.perf_counter() - t_phase
    row["card"] = power
    emit(row)
    return launches


#: the storage phase, part B: the network phase's width at a pace the core
#: serves (0.4 Hz a client: 49,152 ops over about 5 s), two workers
#: through the gateway and two direct, beside real containers on
#: STORAGE_CONTAINERS docs through the gateway. Cut in depth to two
#: rounds (four until the host_admin phase joined the smoke) to hold the
#: smoke's time
STORAGE_RUN = dict(workers=4, docs_per_worker=256, clients_per_doc=2,
                   rounds=2, batch=12, rate=0.4)
STORAGE_CONTAINERS = 8


def _object_files(directory: str) -> dict:
    """{object id: bytes} of a chunk store (the fan-out layout
    ``aa/rest``), the history plane's files left out."""
    out = {}
    for fan in os.listdir(directory):
        if len(fan) != 2:
            continue
        for rest in os.listdir(os.path.join(directory, fan)):
            out[fan + rest] = os.path.getsize(
                os.path.join(directory, fan, rest))
    return out


def _storage_durable(root: str, row: dict, device: str) -> int:
    """Part A: the service run on a ``LocalServer`` over a ``DurableLog``
    and the native chunk store, 1024 summaries from the card, then a
    fresh server over the same directories. Returns B1's launches."""
    from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.ops import cuda_apply
    from fluidframework_tpu_torch.protocol.refgraph import RefLog
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.gpu_applier import (
        GpuDocumentApplier,
        channel_stream,
    )
    from fluidframework_tpu_torch.service.load_gen import run_inproc_on
    from fluidframework_tpu_torch.service.local_server import LocalServer
    from fluidframework_tpu_torch.service.service_summarizer import (
        ServiceSummarizer,
    )

    docs = [f"doc{d}" for d in range(SERVICE_RUN["n_docs"])]
    log_dir, blob_dir = (os.path.join(root, "log"),
                         os.path.join(root, "blobs"))
    cpu_log, cpu_blobs = (os.path.join(root, "cpu_log"),
                          os.path.join(root, "cpu_blobs"))
    os.makedirs(log_dir)
    server = LocalServer(log=DurableLog(log_dir), storage_dir=blob_dir)
    card = GpuDocumentApplier(device=device, async_dispatch=True,
                              min_wave_ops=32768, **SERVICE_GEO)
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        cuda_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        stats = run_inproc_on(server, applier=card, array_lane=True,
                              **SERVICE_RUN)
        row["feed_seconds"] = time.perf_counter() - t0
        if stats.ops_acked != stats.ops_submitted or \
                stats.applier_ops != stats.ops_submitted:
            fail(f"storage: {stats.ops_acked} acked, {stats.applier_ops} "
                 f"applied of {stats.ops_submitted}")
        row["ops"] = stats.ops_submitted
        server.checkpoint_all()
        server.log.flush()
        # the CPU store's server replays a copy of this log: the same
        # stream, client ids and seqs
        t0 = time.perf_counter()
        shutil.copytree(log_dir, cpu_log)
        row["log_copy_seconds"] = time.perf_counter() - t0
        svc = ServiceSummarizer(server, card)
        row["summary_pass"] = _summary_pass(svc, server, card, docs)
        card.finalize()  # re-raises a worker exception: the phase fails
        launches = cuda_apply.LAUNCHES
        if launches != card.dispatches or launches == 0:
            fail(f"storage: {launches} kernel launches for "
                 f"{card.dispatches} dispatches")
        row.update(launches=launches, dispatches=card.dispatches)
        heads = {d: server._get_orderer("bench", d).scribe.last_summary_head
                 for d in docs}
        t0 = time.perf_counter()
        server.checkpoint_all()
        server.log.sync()
        server.log.close()
        server.blob_store.close()
        row["close_seconds"] = time.perf_counter() - t0
    finally:
        card.close()
    objects = _object_files(blob_dir)
    row.update(objects_written=len(objects),
               bytes_written=sum(objects.values()))

    # the same summarizer from a CPU applier, into a second store
    cpu_server = LocalServer(log=DurableLog(cpu_log), storage_dir=cpu_blobs)
    for doc in docs:  # each doc's pipeline replays at the next drain
        cpu_server._get_orderer("bench", doc)
    cpu_server.log.drain()
    cpu = GpuDocumentApplier(device="cpu", **SERVICE_GEO)
    cpu.set_replay_source(lambda t, d: [])
    for doc in docs:
        cpu.ingest_batch("bench", doc, [
            (m, m.contents) for m in channel_stream(
                cpu_server, "bench", doc, "default", "text")])
    cpu.finalize()
    cpu_svc = ServiceSummarizer(cpu_server, cpu)
    if cpu_svc.summarize_all("bench", docs) != len(docs):
        fail(f"storage: the CPU pass refused {cpu_svc.refusals[:1]}")
    cpu_server.log.close()
    cpu_server.blob_store.close()
    cpu_objects = _object_files(cpu_blobs)
    if cpu_objects != objects:
        only = sorted(set(objects) ^ set(cpu_objects))
        fail(f"storage: the card's store and the CPU's differ in "
             f"{len(only)} objects (first {only[:1]})")

    # a fresh server over the same two directories
    t0 = time.perf_counter()
    server2 = LocalServer(log=DurableLog(log_dir), storage_dir=blob_dir)
    orderers = [server2._get_orderer("bench", d) for d in docs]
    server2.log.drain()
    reopened = {d: o.scribe.last_summary_head for d, o in zip(docs, orderers)}
    row["reopen_seconds"] = time.perf_counter() - t0
    bad = [d for d in docs if reopened[d] != heads[d] or heads[d] is None]
    if bad:
        fail(f"storage: {len(bad)} docs' summary heads did not survive the "
             f"reopen (first {bad[0]}: {heads[bad[0]]} -> "
             f"{reopened[bad[0]]})")
    loader = Loader(LocalDocumentServiceFactory(server2))
    t0 = time.perf_counter()
    booted = [loader.resolve("bench", d, connect=False) for d in docs]
    row["boot_seconds"] = time.perf_counter() - t0
    bad = [d for d, c in zip(docs, booted) if c._base_snapshot is None
           or c.runtime.get_data_store("default").get_channel("text")
           .get_text() != cpu.get_text("bench", d)]
    if bad:
        fail(f"storage: {len(bad)} booted containers differ from the CPU "
             f"applier or did not boot from the summary (first {bad[0]})")
    bad = [d for d in docs if not any(
        r["t"] == "commit" and r["version"] == heads[d]
        for r in RefLog(os.path.join(blob_dir, "history",
                                     f"bench__{d}.hist")).load())]
    if bad:
        fail(f"storage: {len(bad)} docs' .hist files lack their commit "
             f"(first {bad[0]})")
    server2.log.close()
    server2.blob_store.close()
    row.update(docs=len(docs), heads_survive=True, boots_match_cpu=True,
               hist_commits=True, objects_match_cpu=True)
    return launches


def _stage_applied(state_dir: str) -> dict:
    """doc → newest ``applied_seq`` a stage reported on its backchannel;
    with the docs it reported ``version`` records for under ``"version"``
    (tenant ``bench``)."""
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.service.stage_runner import (
        BACKCHANNEL_TOPIC,
    )

    log = DurableLog(state_dir, readonly=True)
    applied, versions = {}, set()
    try:
        for i in range(log.refresh_topic(BACKCHANNEL_TOPIC)):
            rec = log.read(BACKCHANNEL_TOPIC, i)
            if rec["kind"] == "applied":
                applied[rec["doc"]] = max(applied.get(rec["doc"], 0),
                                          rec["applied_seq"])
            elif rec["kind"] == "version":
                versions.add(rec["doc"])
    finally:
        log.close()
    return {"applied": applied, "version": versions}


def _storage_composition(root: str, row: dict, device: str) -> None:
    """Part B: the full production composition, every tier a process of
    the port (storage server, core with an external scribe, the scribe
    stage, two partitioned applier stages on ``device``, a native
    gateway), under the socket load and real containers."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
        _Transport,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.native import build as native_build
    from fluidframework_tpu_torch.runtime.summarizer import SummaryManager
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )
    from fluidframework_tpu_torch.service.stage_runner import (
        ApplierStage,
        doc_partition,
    )
    from fluidframework_tpu_torch.service.storage_client import (
        RemoteStorage,
        StorageConnection,
    )

    run = STORAGE_RUN
    load_docs = [f"stor{w}d{d}" for w in range(run["workers"])
                 for d in range(run["docs_per_worker"])]
    cont_docs = [f"cont{i}" for i in range(STORAGE_CONTAINERS)]
    docs = load_docs + cont_docs
    tmp = os.path.join(root, "compose")
    log_dir, store_dir = (os.path.join(tmp, "log"),
                          os.path.join(tmp, "store"))
    sstate = os.path.join(tmp, "scribe")
    astates = [os.path.join(tmp, f"applier{k}") for k in range(2)]
    err_path = os.path.join(HERE, "build", "smoke", "storage_stderr.txt")
    procs, named = [], {}
    out = row["composition"] = {"docs": len(docs), **run,
                                "containers": len(cont_docs)}

    def spawn(name, args, ready):
        proc, line = _spawn_ready(args, ready, err_path,
                                  f"storage: {name}")
        procs.append(proc)
        named[name] = proc
        return proc, line

    def start_storage():
        port = out.get("storage_port", 0)
        proc, line = spawn("storage", [
            "fluidframework_tpu_torch.service.storage_server", "--dir",
            store_dir, "--port", str(port)], "LISTENING")
        out["storage_port"] = int(line.rsplit(":", 1)[1])
        return proc

    owned = {k: [d for d in docs if doc_partition("bench", d, 2) == k]
             for k in range(2)}
    if not owned[0] or not owned[1] or \
            len(owned[0]) + len(owned[1]) != len(docs):
        fail(f"storage: the partition splits {len(docs)} docs as "
             f"{len(owned[0])} + {len(owned[1])}")
    out["docs_per_stage"] = [len(owned[0]), len(owned[1])]
    conns = []
    try:
        t0 = time.perf_counter()
        storage = start_storage()
        spawn("scribe", ["fluidframework_tpu_torch.service.stage_runner",
                         "--stage", "scribe", "--log-dir", log_dir,
                         "--state-dir", sstate], "READY")
        for k in range(2):
            spawn(f"applier{k}", [
                "fluidframework_tpu_torch.service.stage_runner", "--stage",
                "applier", "--log-dir", log_dir, "--state-dir", astates[k],
                "--device", device, "--partition", f"{k}/2",
                "--max-docs", str(SERVICE_GEO["max_docs"]),
                "--max-slots", str(SERVICE_GEO["max_slots"])], "READY")
        _, line = spawn("core", [
            "fluidframework_tpu_torch.service.front_end", "--port", "0",
            "--log-dir", log_dir,
            "--storage-server", f"127.0.0.1:{out['storage_port']}",
            "--external-scribe", "--consume-backchannel", sstate,
            "--consume-backchannel", astates[0],
            "--consume-backchannel", astates[1]], "LISTENING")
        core_port = int(line.rsplit(":", 1)[1])
        lib = str(native_build.build("gateway"))
        gw, line = spawn("gateway", [
            "fluidframework_tpu_torch.service.gateway", "--core-port",
            str(core_port)], "LISTENING")
        gw_port = int(line.rsplit(":", 1)[1])
        with open(f"/proc/{gw.pid}/maps") as f:
            if lib not in f.read():
                fail(f"storage: the gateway does not run the native relay "
                     f"({lib} not mapped)")
        out["start_seconds"] = time.perf_counter() - t0

        # real containers through the gateway, each summarizing after 4
        # operations (2 channel attaches, 2 inserts) while the load runs
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1",
                                                      gw_port))
        conts = [loader.resolve("bench", d) for d in cont_docs]
        managers = [SummaryManager(c, max_ops=4) for c in conts]
        strings, t_sent, t_acked, t_ref, heads = [], {}, {}, {}, {}
        conn = StorageConnection("127.0.0.1", out["storage_port"])
        conns.append(conn)

        def write_containers():
            time.sleep(max(0.0, NETWORK_START_MARGIN_S))
            for i, c in enumerate(conts):
                s = c.runtime.create_data_store("default").create_channel(
                    "text", "shared-string")
                for w in (f"doc {i} ", "on the card "):
                    s.insert_text(0, w)
                t_sent[i] = time.perf_counter()
                strings.append(s)
            # each summary's ack (the scribe process validated it, the
            # core ordered the ack) and its ref in the storage process
            deadline = time.perf_counter() + CHILD_TIMEOUT_S
            while len(t_ref) < len(conts) or len(t_acked) < len(conts):
                for i, (sm, d) in enumerate(zip(managers, cont_docs)):
                    if i not in t_acked and sm.summaries_acked >= 1:
                        t_acked[i] = time.perf_counter()
                    if i not in t_ref:
                        head = RemoteStorage(conn, "bench", d).get_ref()
                        if head is not None:
                            heads[d], t_ref[i] = head, time.perf_counter()
                if time.perf_counter() > deadline:
                    fail(f"storage: of {len(conts)} container summaries "
                         f"{len(t_acked)} were acked and {len(t_ref)} "
                         "advanced their ref in the storage process")
                time.sleep(0.01)

        servers = {k: named[k].pid for k in ("core", "gateway", "storage",
                                             "scribe", "applier0",
                                             "applier1")}
        load, last_ack = _run_load(run, [gw_port, gw_port, core_port,
                                         core_port], "stor", servers,
                                   procs, err_path, "storage",
                                   during=write_containers)
        out.update(load)
        ack_s = [t_acked[i] - t_sent[i] for i in t_acked]
        ref_s = [t_ref[i] - t_sent[i] for i in t_ref]
        out["summary_ack_seconds"] = {"p50": _pct(ack_s, 0.5),
                                      "max": max(ack_s)}
        out["summary_ref_seconds"] = {"p50": _pct(ref_s, 0.5),
                                      "max": max(ref_s)}
        texts = {d: s.get_text() for d, s in zip(cont_docs, strings)}

        # quiescence: every doc's applierSeq (from its stage) at its seq
        rpc = _Transport("127.0.0.1", core_port, timeout=60.0)
        conns.append(rpc)
        lag = {}
        while len(lag) < 2:
            status = _network_statuses(rpc, docs)
            for k in range(2):
                if k not in lag and all(status[d][0] == status[d][1]
                                        for d in owned[k]):
                    lag[k] = time.time() - last_ack
            if time.time() - last_ack > CHILD_TIMEOUT_S:
                first = next(d for d in docs
                             if status[d][0] != status[d][1])
                fail(f"storage: docs' applierSeq lag the core (first "
                     f"{first}: {status[first]})")
            time.sleep(0.05)
        out["catch_up_lag_seconds"] = [lag[0], lag[1]]

        # the scribe PROCESS acked each container's summary; the ref walks
        scribe_bc = _stage_applied(sstate)
        if set(cont_docs) - scribe_bc["version"]:
            fail("storage: the scribe stage recorded no version for "
                 f"{sorted(set(cont_docs) - scribe_bc['version'])}")
        for d in cont_docs:
            hist = RemoteStorage(conn, "bench", d).history()
            if heads[d] not in [c["id"] for c in hist]:
                fail(f"storage: the history of {d} lacks its head")

        def boot_all(port, what):
            bad = []
            for d in cont_docs:
                c = Loader(NetworkDocumentServiceFactory(
                    "127.0.0.1", port)).resolve("bench", d)
                got = c.runtime.get_data_store("default").get_channel(
                    "text").get_text()
                if c._base_snapshot is None or got != texts[d]:
                    bad.append(d)
                c.close()
            if bad:
                fail(f"storage: {what}: {len(bad)} fresh clients did not "
                     f"boot from the ref to the writer's text (first "
                     f"{bad[0]})")
        t0 = time.perf_counter()
        boot_all(gw_port, "through the gateway")
        out["boot_seconds"] = time.perf_counter() - t0

        # each stage reported exactly its partition, at every doc's tail
        # (read again: the boots above joined and left the container docs)
        seqs = _settled_seqs(rpc, docs, "storage")
        for k in range(2):
            applied = _stage_applied(astates[k])["applied"]
            if set(applied) != set(owned[k]):
                fail(f"storage: applier stage {k} reported "
                     f"{len(applied)} docs, owns {len(owned[k])}")
            off = [d for d in owned[k] if applied[d] != seqs[d]]
            if off:
                fail(f"storage: applier stage {k} is off the tail on "
                     f"{len(off)} docs (first {off[0]}: applied "
                     f"{applied[off[0]]}, seq {seqs[off[0]]})")
        out["cpu_seconds_total"] = {k: _cpu_seconds(pid)
                                    for k, pid in servers.items()}
        # each stage's farm against a CPU applier over the core's log
        t0 = time.perf_counter()
        for k in range(2):
            proc = named[f"applier{k}"]
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
            farm = load_applier_checkpoint(
                os.path.join(astates[k], "applier"), device=device)
            if farm.host_escalations or farm._host_docs:
                fail(f"storage: applier stage {k} escalated docs")
            ref = ApplierStage(log_dir, os.path.join(tmp, f"cpu{k}"),
                               max_docs=SERVICE_GEO["max_docs"],
                               max_slots=SERVICE_GEO["max_slots"],
                               partition=(k, 2), device="cpu")
            while ref.run_once():
                pass
            bad = [d for d in owned[k] if ref.applier.get_text("bench", d)
                   != farm.get_text("bench", d)]
            ref.shared.close()
            ref.state.close()
            if bad:
                fail(f"storage: {len(bad)} docs of applier stage {k}'s "
                     f"farm differ from the CPU applier (first {bad[0]})")
            for d in cont_docs:
                if d in owned[k] and farm.get_text("bench", d) != texts[d]:
                    fail(f"storage: stage {k}'s farm reads another text "
                         f"for {d} than its writer")
        out["farm_check_seconds"] = time.perf_counter() - t0

        # kill the storage process, restart it on the same --dir and port
        t0 = time.perf_counter()
        storage.kill()
        storage.wait(timeout=30)
        start_storage()
        out["storage_restart_seconds"] = time.perf_counter() - t0
        for d in cont_docs:
            got = RemoteStorage(conn, "bench", d).get_ref()
            if got != heads[d]:
                fail(f"storage: {d}'s ref after the restart is {got}, "
                     f"not {heads[d]}")
        boot_all(core_port, "after the storage restart")
        for c in conts:
            c.close()
        out.update(summaries_acked_by_scribe=True, refs_advance=True,
                   refs_survive_restart=True, stages_at_tail=True,
                   farms_match_cpu=True, gateway_native=True)
    finally:
        for c in conns:
            c.close()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)


def phase_storage(power: str, device: str = "cuda"):
    """The storage tier. Part A: the service run (1024 docs x 2 clients x
    48 ops, the async card applier) on a ``LocalServer`` over a
    ``DurableLog`` and the native chunk store (``storage_dir``);
    ``summarize_all`` writes every doc's summary from the card into the
    store and the history plane's ``.hist`` files; after the handles
    close, a fresh server over the same directories holds every summary
    head, boots 1024 containers to the CPU applier's texts, finds every
    commit in its ``.hist`` file, and the store's object ids equal those
    the same summarizer writes from a CPU applier over a copy of the log.
    Part B: the full production composition as processes (see
    ``_storage_composition``). Returns B1's launches in part A (part B's
    are the stage children's own)."""
    root = os.path.join(HERE, "build", "smoke", "storage")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    row = {"phase": "storage", "filesystem": subprocess.run(
        ["stat", "-f", "-c", "%T", os.path.dirname(root)],
        capture_output=True, text=True, check=True).stdout.strip()}
    launches = _storage_durable(root, row, device)
    _storage_composition(root, row, device)
    shutil.rmtree(root, ignore_errors=True)
    row["phase_seconds"] = time.perf_counter() - t_phase
    row["card"] = power
    emit(row)
    return launches


#: each of the load's two halves (48 ops a client in all)
SHARDED_RUN = dict(workers=4, docs_per_worker=256, clients_per_doc=2,
                   rounds=2, batch=12, rate=0.4)
#: the lease TTL. A core heartbeats every TTL/3 from its event loop and
#: refuses orders once 75% of the TTL passes without one (``lease_fresh``);
#: a peer takes its partitions over after the whole TTL. On the card's
#: machine ``bench.py::bench_migration_blip``'s 1.5 s fenced the cores in
#: the 2,048-client connect storm; at 5 s heartbeats lapsed 3.4-3.9 s
#: apart beside the earlier phases (a live core taken over twice in three
#: whole runs), at 15 s up to 9.9 s apart: the loop's 9p writes (the
#: per-batch log flush, the 2 s checkpoint pass over ~540 dirty docs) hold
#: the heartbeat back for seconds. 30 s leaves the fence 22.5 s.
SHARDED_TTL_S = 30.0
SHARDED_PROBES = 8
SHARDED_TAIL_DOCS = 64
SHARDED_TAIL_OPS = 3
#: seconds of probe alone before the migration (its baseline: the ops
#: acked in it) and after the migration's reply (its window: the ops in
#: flight at any time from the seal to this long after the flip)
SHARDED_PROBE_WINDOW_S = 5.0


#: seconds between two probe ops (one op in flight at a time)
SHARDED_PROBE_PACE_S = 0.02


class _Probe:
    """Containers writing one op at a time, each waited on until acked:
    ``(sent wall time, acked wall time)`` per op, on a thread of its own.
    A container whose core died rides ``auto_reconnect``; its op acks once
    the new owner has it. The ops alternate an insert of one character at
    0 and its removal, so a probe doc's text ends as it began and zamboni
    frees its slots: thousands of one-character inserts would overflow a
    doc's S=256 slots."""

    def __init__(self, strings: list, containers: list):
        self.strings, self.containers = strings, containers
        self.samples: list = []
        self.stop = threading.Event()
        self.error: list = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def step(self, i: int) -> tuple:
        """Op ``i``: container ``i mod n``, an insert on even rounds and
        its removal on odd ones."""
        n = len(self.strings)
        s, c = self.strings[i % n], self.containers[i % n]
        t0 = time.time()
        self.inflight = (i, t0)
        if (i // n) % 2:
            s.remove_text(0, 1)
        else:
            s.insert_text(0, "p")
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while c.runtime.pending.count:
            if time.monotonic() > deadline:
                raise RuntimeError(f"probe op {i} never acked")
            time.sleep(0.0005)
        return t0, time.time()

    def _run(self) -> None:
        try:
            while not self.stop.is_set():
                self.samples.append(self.step(len(self.samples)))
                time.sleep(SHARDED_PROBE_PACE_S)
        except Exception as e:  # noqa: BLE001 — reported by join()
            self.error.append(repr(e))

    def join(self) -> None:
        """Stop after a whole number of insert/remove rounds."""
        self.stop.set()
        self.thread.join(CHILD_TIMEOUT_S)
        if self.error or self.thread.is_alive():
            fail(f"sharded: the probe failed ({self.error or 'hung'})")
        while len(self.samples) % (2 * len(self.strings)):
            self.samples.append(self.step(len(self.samples)))


class _LeaseWatch:
    """Samples each partition lease file's mtime (a heartbeat touches it)
    every 50 ms on a thread: the longest gap between two heartbeats a
    partition's owner landed, against the fence at 75% of the TTL."""

    def __init__(self, shard: str, n: int):
        self.paths = [os.path.join(shard, "placement", f"part-{k}.lease")
                      for k in range(n)]
        self.last = [None] * n
        self.max_gap = [0.0] * n
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.stop.wait(0.05):
            for k, path in enumerate(self.paths):
                try:
                    m = os.stat(path).st_mtime
                except OSError:
                    continue
                if self.last[k] is not None and m != self.last[k]:
                    self.max_gap[k] = max(self.max_gap[k], m - self.last[k])
                self.last[k] = m

    def join(self) -> list:
        self.stop.set()
        self.thread.join(5)
        return self.max_gap


def _journal_seal_to_flip_ms(shard: str, epoch: int):
    """ms from the source core's ``migration.seal`` to the ``epoch.bump``
    that recorded ``epoch`` (the adopting core's), from the cores'
    journals in the shard dir; None when either entry is missing."""
    entries = []
    jdir = os.path.join(shard, "journal")
    for name in os.listdir(jdir) if os.path.isdir(jdir) else ():
        with open(os.path.join(jdir, name)) as f:
            entries += [json.loads(ln) for ln in f if ln.strip()]
    bump = [e["ts"] for e in entries if e.get("kind") == "epoch.bump"
            and e.get("epoch") == epoch]
    seal = [e["ts"] for e in entries if e.get("kind") == "migration.seal"
            and bump and e["ts"] <= bump[0]]
    if not bump or not seal:
        return None
    return (bump[0] - max(seal)) * 1e3


def _replay_log(log_dir: str, docs: list, tenant: str = "bench",
                phase: str = "sharded") -> dict:
    """Each doc's deltas topic of one partition log through the port's
    ``InvariantMonitor`` (no seq gap, no duplicate join or clientSeq, msn
    monotone); re-ticketed seqs must carry the same message. Returns
    counts and each doc's last seq."""
    from fluidframework_tpu_torch.chaos.monitor import InvariantMonitor
    from fluidframework_tpu_torch.service.durable_log import DurableLog
    from fluidframework_tpu_torch.utils.telemetry import Counters

    log = DurableLog(log_dir, readonly=True)
    out = {"observed": 0, "redelivered": 0, "last": {}}
    try:
        for doc in docs:
            topic = f"deltas/{tenant}/{doc}"
            monitor = InvariantMonitor(Counters())
            seen: dict = {}
            for i in range(log.refresh_topic(topic)):
                rec = log.read(topic, i)
                msgs = (rec["abatch"].messages() if "abatch" in rec
                        else rec.get("boxcar") or [rec["message"]])
                for m in msgs:
                    key = (m.client_id, m.client_sequence_number,
                           str(m.type), json.dumps(m.contents,
                                                   sort_keys=True))
                    if seen.setdefault(m.sequence_number, key) != key:
                        fail(f"{phase}: {log_dir} re-ticketed seq "
                             f"{m.sequence_number} of {doc} with another "
                             "message")
                    monitor.observe(m)
            try:
                monitor.check()
            except AssertionError as e:
                fail(f"{phase}: {doc} in {log_dir}: {e}")
            out["observed"] += monitor.observed
            out["redelivered"] += monitor.redelivered
            out["last"][doc] = monitor.last_seq
    finally:
        log.close()
    return out


def _sharded_postmortem(shard: str, row: dict, err_path: str) -> None:
    """On a failed phase: the row so far, the epoch table and the cores'
    control-plane journals (leases, epochs, migrations), to stderr and
    the phase's stderr file."""
    lines = [f"sharded postmortem: row {json.dumps(row, default=str)}"]
    try:
        with open(os.path.join(shard, "placement", "table.json")) as f:
            lines.append(f"table {f.read()}")
    except OSError as e:
        lines.append(f"table unreadable: {e}")
    jdir = os.path.join(shard, "journal")
    for name in sorted(os.listdir(jdir)) if os.path.isdir(jdir) else ():
        with open(os.path.join(jdir, name)) as f:
            for ln in f:
                if any(k in ln for k in ('"lease.', '"epoch.', '"migration.',
                                         '"core.')):
                    lines.append(f"{name}: {ln.strip()}")
    text = "\n".join(lines)
    print(text, file=sys.stderr, flush=True)
    with open(err_path, "a") as f:
        f.write(text + "\n")


def phase_sharded(power: str, device: str = "cuda"):
    """The sharded ordering core as processes of the port, from one
    ``TopologySpec``: two cores over one shard dir (``--shards 2``, core
    ``i`` preferring partition ``i``, lease TTL ``SHARDED_TTL_S``), two
    shard-routing gateways (the asyncio relay, as the JAX package runs
    them) and one applier stage child on ``device`` a partition log
    (``log-<k>``, D=1024, S=256). The socket load (1024 docs x 2 clients x 48 ops, boxcars of
    12 at 0.4 Hz, through the gateways) runs in two halves; between them
    partition 0 migrates live from core 0 to core 1 (``admin_migrate_part``)
    while 8 containers probe; then core 1, owner of both partitions, is
    killed with SIGKILL, core 0 takes both over after the TTL and 64
    containers write a tail. Checks: every stage's farm equals a CPU
    applier fed its whole log and the containers' texts, every doc's
    ``applied`` record reaches its last seq, each log replays through the
    invariant monitor with no gap or duplicate, each partition's epoch
    rises at every ownership change, the ex-owner refuses the moved
    partition and the dead core any connect, and no doc escalates. B1's
    launches are the children's own: their ``applied`` records and
    checkpoints prove them."""
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )
    from fluidframework_tpu_torch.service.placement_plane import (
        EpochTable,
        admin_rpc,
    )
    from fluidframework_tpu_torch.service.stage_runner import (
        ApplierStage,
        doc_partition,
    )
    from fluidframework_tpu_torch.service.topology import (
        CoreSpec,
        Fleet,
        GatewaySpec,
        TopologySpec,
    )

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "smoke", "sharded")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    err_path = os.path.join(HERE, "build", "smoke", "sharded_stderr.txt")
    open(err_path, "w").close()
    shard = os.path.join(root, "deploy")
    run = SHARDED_RUN
    load_docs = [f"shd{w}d{d}" for w in range(run["workers"])
                 for d in range(run["docs_per_worker"])]
    cont_docs = [f"shc{i}" for i in range(SHARDED_TAIL_DOCS)]
    docs = load_docs + cont_docs
    owned = {k: [d for d in docs if doc_partition("bench", d, 2) == k]
             for k in range(2)}
    row = {"phase": "sharded", "docs": len(docs), **run,
           "halves": 2, "lease_ttl_s": SHARDED_TTL_S,
           "docs_per_partition": [len(owned[0]), len(owned[1])]}
    # boot_rate=0 disarms boot-storm admission: it parks first routes to
    # cold docs on a retry lane that the socket load's raw clients do not
    # ride (every doc of this run is new, so nothing is rehydrated)
    spec = TopologySpec(
        shard_dir=shard, n_partitions=2, lease_ttl=SHARDED_TTL_S,
        boot_rate=0.0,
        cores=[CoreSpec(name=f"core{i}", prefer=[i]) for i in range(2)],
        gateways=[GatewaySpec(name=f"gw{i}") for i in range(2)])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    table = EpochTable.for_shard_dir(shard)
    procs, stages, conts = [], [], []
    fleet = Fleet(spec, subprocess=True, env=env)

    def epoch(k):
        return table.read()["parts"][str(k)]["epoch"]

    def owner(k):
        return table.read()["parts"][str(k)]["addr"]

    try:
        t0 = time.perf_counter()
        fleet.start()
        # the fleet's children write to pipes: drain them into the
        # stderr file so that no child blocks on a full pipe
        for p in [*fleet.procs.values(), *fleet.gw_procs.values()]:
            threading.Thread(target=lambda p=p: shutil.copyfileobj(
                p.stdout, open(err_path, "a")), daemon=True).start()
        fleet.wait_claimed(timeout=CHILD_TIMEOUT_S)
        addr = {i: f"{spec.host}:{fleet.core_ports[i]}" for i in range(2)}
        if owner(0) != addr[0] or owner(1) != addr[1]:
            fail(f"sharded: the cores claimed {table.read()['parts']}")
        epochs = {k: [epoch(k)] for k in range(2)}
        leases = _LeaseWatch(shard, 2)
        # live until the kill, so that a postmortem shows it too
        row["lease_heartbeat_gap_max_s"] = leases.max_gap
        for i, gp in fleet.gw_procs.items():
            with open(f"/proc/{gp.pid}/maps") as f:
                if "libgateway" in f.read():
                    fail(f"sharded: gateway {i} mapped the native relay; "
                         "the sharded routing runs the asyncio relay")
        row["relay"] = "python asyncio (--shard-dir routing)"
        for k in range(2):
            proc = _StageProcess(os.path.join(shard, f"log-{k}"),
                                 os.path.join(root, f"stage{k}"), device,
                                 err_path, what=f"sharded stage {k}")
            stages.append(proc)
        row["start_seconds"] = time.perf_counter() - t0
        gw_ports = [fleet.gw_ports[0], fleet.gw_ports[1]]
        servers = {"core0": fleet.procs[0].pid, "core1": fleet.procs[1].pid,
                   "gw0": fleet.gw_procs[0].pid,
                   "gw1": fleet.gw_procs[1].pid,
                   "stage0": stages[0].proc.pid,
                   "stage1": stages[1].proc.pid}

        # 64 containers through the gateways, riding auto_reconnect
        t0 = time.perf_counter()
        strings = []
        for i, d in enumerate(cont_docs):
            c = Loader(NetworkDocumentServiceFactory(
                "127.0.0.1", gw_ports[i % 2]), auto_reconnect=True
            ).resolve("bench", d)
            s = c.runtime.create_data_store("default").create_channel(
                "text", "shared-string")
            s.insert_text(0, f"doc {i} ")
            conts.append(c)
            strings.append(s)
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while any(c.runtime.pending.count for c in conts):
            if time.monotonic() > deadline:
                fail("sharded: the containers' first ops were not acked")
            time.sleep(0.01)
        row["containers_seconds"] = time.perf_counter() - t0
        probe = _Probe(strings[:SHARDED_PROBES], conts[:SHARDED_PROBES])

        # half 1, then the live migration of partition 0 under the probe,
        # then half 2: the socket load's raw clients resubmit shed nacks
        # but do not reconnect, so the migration falls between the halves
        halves = []
        load, last_ack = _run_load(run, gw_ports + gw_ports, "shd", servers,
                                   procs, err_path, "sharded")
        halves.append(load)
        time.sleep(SHARDED_PROBE_WINDOW_S)
        t_mig = time.time()
        t0 = time.perf_counter()
        res = admin_rpc("127.0.0.1", fleet.core_ports[0], {
            "t": "admin_migrate_part", "k": 0, "target": addr[1]},
            timeout=60.0)
        rpc_ms = (time.perf_counter() - t0) * 1e3
        t_flip = time.time()
        if res.get("target") != addr[1] or owner(0) != addr[1]:
            fail(f"sharded: the migration answered {res}")
        epochs[0].append(epoch(0))
        # the ex-owner refuses the moved partition's docs
        try:
            NetworkDocumentServiceFactory(
                "127.0.0.1", fleet.core_ports[0]).create_document_service(
                "bench", owned[0][0]).connect_to_delta_stream()
            fail("sharded: core 0 still serves partition 0 after the "
                 "migration")
        except RuntimeError as e:
            if "not the owner" not in str(e):
                raise
        t_end = t_flip + SHARDED_PROBE_WINDOW_S
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not probe.error and time.monotonic() < deadline and not [
                a for a, b in probe.samples if a >= t_end]:
            time.sleep(0.05)
        samples = list(probe.samples)
        base = [(b - a) * 1e3 for a, b in samples
                if t_mig - SHARDED_PROBE_WINDOW_S <= b < t_mig]
        window = [(b - a) * 1e3 for a, b in samples
                  if a < t_end and b >= t_mig]
        if not base or not window:
            near = [(round(a - t_mig, 3), round(b - t_mig, 3))
                    for a, b in probe.samples[-6:]]
            near.append([(c.connected, c.runtime.pending.count)
                         for c in probe.containers])
            near.append((probe.inflight[0],
                         round(probe.inflight[1] - t_mig, 3), probe.error))
            fail(f"sharded: the probe wrote {len(base)} ops before and "
                 f"{len(window)} across the migration (of "
                 f"{len(probe.samples)}; sent and acked around it, s from "
                 f"the migration: {near}; half 1 ended "
                 f"{round(last_ack - t_mig, 3)} s from it)")
        row["migration"] = {
            "rpc_ms": rpc_ms,
            "seal_to_flip_ms": _journal_seal_to_flip_ms(
                shard, res.get("epoch")),
            "probe_baseline_p99_ms": _pct(base, 0.99),
            "probe_window_p99_ms": _pct(window, 0.99),
            "probe_window_max_ms": max(window),
            "probe_ops": [len(base), len(window)]}

        # half 2, with core 1 now the owner of both partitions
        load, last_ack = _run_load(run, gw_ports + gw_ports, "shd", servers,
                                   procs, err_path, "sharded")
        halves.append(load)
        row["halves_load"] = halves
        row["cpu_seconds_before_kill"] = {
            k: _cpu_seconds(pid) for k, pid in servers.items()}

        leases.join()
        # takeover: SIGKILL core 1; core 0 claims both after the TTL
        t_kill = time.time()
        fleet.procs[1].kill()
        fleet.procs[1].wait(timeout=60)
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while owner(0) != addr[0] or owner(1) != addr[0]:
            if time.monotonic() > deadline:
                fail(f"sharded: no takeover ({table.read()['parts']})")
            time.sleep(0.02)
        t_claimed = time.time()
        for k in range(2):
            epochs[k].append(epoch(k))
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not [b for a, b in probe.samples if b > t_claimed]:
            if time.monotonic() > deadline or probe.error:
                fail(f"sharded: the probe never acked after the takeover "
                     f"({probe.error})")
            time.sleep(0.01)
        first_ack = min(b for a, b in probe.samples if b > t_claimed)
        probe.join()
        try:
            NetworkDocumentServiceFactory(
                "127.0.0.1", fleet.core_ports[1]).create_document_service(
                "bench", owned[1][0]).connect_to_delta_stream()
            fail("sharded: the killed core still answers")
        except (OSError, ConnectionError):
            pass
        row["takeover"] = {"kill_to_claim_s": t_claimed - t_kill,
                           "kill_to_first_ack_s": first_ack - t_kill}

        # the tail: every container writes through the new owner
        t0 = time.perf_counter()
        for i, s in enumerate(strings):
            for j in range(SHARDED_TAIL_OPS):
                s.insert_text(len(s.get_text()), f"t{j}")
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while any(c.runtime.pending.count for c in conts):
            if time.monotonic() > deadline:
                fail("sharded: the containers' tail was not acked")
            time.sleep(0.01)
        last_ack = time.time()
        row["tail_seconds"] = time.perf_counter() - t0
        texts = {d: s.get_text() for d, s in zip(cont_docs, strings)}
        for c in conts:
            c.close()  # their leaves are the logs' last records
        conts = []
        time.sleep(0.5)
        for k in range(2):
            if not epochs[k] == sorted(set(epochs[k])):
                fail(f"sharded: partition {k}'s epochs {epochs[k]} do not "
                     "rise at every ownership change")
        row["epochs"] = epochs

        # every doc's applied record at its last seq, per stage
        replay = {k: _replay_log(os.path.join(shard, f"log-{k}"), owned[k])
                  for k in range(2)}
        row["invariants"] = {str(k): {"observed": replay[k]["observed"],
                                      "redelivered": replay[k]["redelivered"]}
                             for k in range(2)}
        lag = []
        for k in range(2):
            last = replay[k]["last"]
            deadline = time.monotonic() + CHILD_TIMEOUT_S
            while True:
                newest = stages[k].poll()
                if all(newest.get(d, -1) >= s for d, s in last.items()):
                    break
                if time.monotonic() > deadline:
                    late = [d for d, s in last.items()
                            if newest.get(d, -1) < s]
                    fail(f"sharded: stage {k}'s applied records lag on "
                         f"{len(late)} docs (first {late[0]})")
                time.sleep(0.01)
            lag.append(time.time() - last_ack)
        row["catch_up_lag_seconds"] = lag
        row["cpu_seconds_total"] = {
            **{k: _cpu_seconds(pid) for k, pid in servers.items()
               if k != "core1"},
            "core1": row["cpu_seconds_before_kill"]["core1"]}

        # each stage's farm: a CPU applier over its whole log, the texts
        fleet.stop()
        t0 = time.perf_counter()
        escalations = 0
        for k in range(2):
            stages[k].kill(signal.SIGTERM)
            farm = load_applier_checkpoint(
                os.path.join(root, f"stage{k}", "applier"), device=device)
            escalations += farm.host_escalations + len(farm._host_docs)
            ref = ApplierStage(os.path.join(shard, f"log-{k}"),
                               os.path.join(root, f"cpu{k}"),
                               max_docs=SERVICE_GEO["max_docs"],
                               max_slots=SERVICE_GEO["max_slots"],
                               device="cpu")
            while ref.run_once():
                pass
            bad = [d for d in owned[k] if ref.applier.get_text("bench", d)
                   != farm.get_text("bench", d)]
            ref.shared.close()
            ref.state.close()
            if bad:
                fail(f"sharded: {len(bad)} docs of stage {k}'s farm differ "
                     f"from the CPU applier (first {bad[0]})")
            wrong = [d for d in owned[k] if d in texts
                     and farm.get_text("bench", d) != texts[d]]
            if wrong:
                fail(f"sharded: stage {k}'s farm reads another text than "
                     f"the writer for {len(wrong)} docs (first {wrong[0]})")
        if escalations:
            fail(f"sharded: {escalations} escalations")
        row["farm_check_seconds"] = time.perf_counter() - t0
        row.update(escalations=0, farms_match_cpu=True, stages_at_tail=True,
                   no_gap_no_duplicate=True, epochs_rise=True,
                   ex_owner_refuses=True, dead_core_refuses=True)
    except BaseException:
        _sharded_postmortem(shard, row, err_path)
        raise
    finally:
        for c in conts:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — tearing down
                pass
        fleet.stop()
        for st in stages:
            if st.proc.poll() is None:
                st.kill()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    shutil.rmtree(root, ignore_errors=True)
    row["phase_seconds"] = time.perf_counter() - t_phase
    row["card"] = power
    emit(row)


#: the overload phase's steady tenant ``bench`` (no configured rate: it
#: is never shed): the sharded phase's width at 0.2 Hz a client (4,838
#: ops/s offered), in three windows of rounds: before the flood, during
#: it and after its drain, every boxcar's hops sampled (the SLO reads
#: them: with one in 16, a client's samples came in its first round only
#: and the window emptied between rounds). 252 docs a worker, not 256:
#: the stage's farm holds 1024 docs, and the flood's 8 docs and the
#: canary's doc ride it too (a farm past its rows raises "all shards
#: full")
OVERLOAD_RUN = dict(workers=4, docs_per_worker=252, clients_per_doc=2,
                    rounds=2, batch=12, rate=0.2)
OVERLOAD_WINDOWS = {"before": 2, "during": 4, "after": 1}
#: the flood tenant: clients of the port's driver stack, one doc each,
#: submitting ``ops`` in all in boxcars of ``batch`` at ``rate`` ops/s in
#: all, ten times the budget (the shape of ``chaos/noisy.py``), over two
#: seconds, starting ``OVERLOAD_FLOOD_AFTER_S`` into the steady load's
#: second window
OVERLOAD_FLOOD = dict(clients=8, ops=8000, batch=20, rate=4000.0)
OVERLOAD_FLOOD_AFTER_S = 10.0
#: the core's flags: the flood's budget is ``chaos/noisy.py``'s CAP (400
#: ops/s, burst 400); ``ingest`` is the example of ``obs/slo.py``'s
#: docstring, which the steady load alone burns (its bursts' p99 is past
#: 25 ms), so its state cannot tell the flood; ``flood_ingest`` is
#: scoped to the flood tenant with ``chaos/noisy.py``'s hair-trigger
#: budget of 0 ms: it has no sample before the flood, and the bucket's
#: burst admits 20 of the flood's boxcars at once, so it burns as soon as
#: the flood's own samples fill its window. A 25 ms budget there burned
#: only when the flood's admitted boxcars met a busy core loop (the
#: admitted share is what admission keeps fast), which not every run
#: met; the canary probes every 2 s
OVERLOAD_SLOS = ("ingest=submit_to_admit:25:5:2",
                 "flood_ingest=submit_to_admit@flood:0:5:2")
OVERLOAD_CORE_FLAGS = ["--tenant-rate", "flood:400:400",
                       *(f for slo in OVERLOAD_SLOS for f in ("--slo", slo)),
                       "--probe", "--probe-tick", "2"]


class _Flood:
    """The flood tenant: clients of the port's driver stack
    (``NetworkDocumentServiceFactory``, so their shed ops ride the
    driver's shed-retry lane), one doc each, every boxcar sampled for the
    hop windows. ``start()`` submits every client's share from one
    thread, one boxcar a client at a time at ``rate`` ops/s in all (or
    as fast as the driver takes them, if slower): one insert of a word, then
    annotates of that word, so the backlog adds no slots to a doc (a
    doc's 256 slots would not hold 1000 inserts whose refSeq cannot
    advance while they wait). Counts acks (own sequenced ops) and hard
    nacks (a shed nack is the driver's, not the app's)."""

    def __init__(self, port: int, clients: int, ops: int, batch: int,
                 rate: float):
        from fluidframework_tpu_torch.driver.network import (
            NetworkDocumentServiceFactory,
        )

        self.factory = NetworkDocumentServiceFactory("127.0.0.1", port)
        self.docs = [f"flood{i}" for i in range(clients)]
        self.per_client, self.batch = ops // clients, batch
        self.round_s = batch * clients / rate
        self.conns, self.acked, self.hard = [], [0] * clients, []
        self.last_ack = None
        for i, doc in enumerate(self.docs):
            conn = self.factory.create_document_service(
                "flood", doc).connect_to_delta_stream()
            conn.trace_sample_n = 1
            conn.on_op = lambda m, i=i, me=conn.client_id: (
                m.client_id == me and self._ack(i))
            conn.on_nack = lambda n, i=i: self.hard.append(
                (i, f"{n.code} {n.message}"))
            self.conns.append(conn)

    def _ack(self, i: int) -> None:
        self.acked[i] += 1
        self.last_ack = time.time()

    def _boxcar(self, first: int) -> list:
        from fluidframework_tpu_torch.mergetree.ops import (
            AnnotateOp,
            InsertOp,
            op_to_wire,
        )
        from fluidframework_tpu_torch.protocol.messages import (
            DocumentMessage,
            MessageType,
        )

        ops = []
        for cseq in range(first, first + self.batch):
            op = (InsertOp(pos=0, text="flood") if cseq == 1 else
                  AnnotateOp(start=0, end=5, props={"flood": cseq % 4}))
            ops.append(DocumentMessage(
                client_sequence_number=cseq, reference_sequence_number=0,
                type=MessageType.OPERATION,
                contents={"kind": "chanop", "address": "default",
                          "contents": {"address": "text",
                                       "contents": op_to_wire(op)}}))
        return ops

    def start(self, delay: float) -> float:
        """Submit everything from ``delay`` seconds on; returns the
        seconds the submits took."""
        time.sleep(delay)
        self.started = time.time()
        for k, first in enumerate(range(1, self.per_client + 1,
                                        self.batch)):
            delay = self.started + k * self.round_s - time.time()
            if delay > 0:
                time.sleep(delay)
            for conn in self.conns:
                conn.submit(self._boxcar(first))
        self.submit_seconds = time.time() - self.started
        return self.submit_seconds

    @property
    def total(self) -> int:
        return self.per_client * len(self.conns)

    def drained(self) -> bool:
        return sum(self.acked) >= self.total

    def shed_retries(self) -> int:
        return self.factory.counters.snapshot().get(
            "driver.submit.shed_retries", 0)

    def report(self) -> str:
        """What a failed check prints: acks, the driver's shed retries
        and the hard nacks."""
        return (f"acked {sum(self.acked)} of {self.total} "
                f"(by client {self.acked}), driver.submit.shed_retries "
                f"{self.shed_retries()}, hard nacks {self.hard[:8]}")

    def close(self) -> None:
        for conn in self.conns:
            conn.close()


class _OverloadWatch:
    """Polls the core's SLO status (every 0.25 s) and health verdict
    (every 1 s) on a thread of its own transport: each SLO's states and
    every health verdict it saw change, with its second since ``t0``,
    and each SLO's largest windowed count and p99 it read."""

    def __init__(self, port: int, t0: float):
        from fluidframework_tpu_torch.driver.network import _Transport

        self.rpc = _Transport("127.0.0.1", port, timeout=60.0)
        self.t0 = t0
        self.slo: dict = {}
        self.peak: dict = {}
        self.health: list = []
        self.error: list = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        n = 0
        try:
            while not self.stop.wait(0.25):
                t = time.time() - self.t0
                for row in self.rpc.request(
                        {"t": "admin_slo_status"})["slos"]:
                    peak = self.peak.setdefault(
                        row["slo"], {"count": 0, "p99_ms": 0.0})
                    peak["count"] = max(peak["count"], row["count"])
                    peak["p99_ms"] = max(peak["p99_ms"], row["p99_ms"])
                    seen = self.slo.setdefault(row["slo"], [])
                    if not seen or seen[-1]["state"] != row["state"]:
                        seen.append({"t": round(t, 3), "state": row["state"],
                                     "p99_ms": row["p99_ms"],
                                     "count": row["count"]})
                n += 1
                if n % 4 == 0:
                    v = self.rpc.request({"t": "admin_health"})[
                        "health"]["verdict"]
                    if not self.health or self.health[-1]["verdict"] != v:
                        self.health.append({"t": round(t, 3), "verdict": v})
        except Exception as e:  # noqa: BLE001 — reported by join()
            self.error.append(repr(e))

    def join(self) -> None:
        self.stop.set()
        self.thread.join(60)
        self.rpc.close()
        if self.error:
            fail(f"overload: the SLO and health watch failed: {self.error}")


def _wait_health_ok(rpc, what: str) -> dict:
    """The core's ``admin_health`` once it answers ``ok`` with a canary
    door probed ok; fails the phase after ``CHILD_TIMEOUT_S``."""
    deadline = time.time() + CHILD_TIMEOUT_S
    while True:
        health = rpc.request({"t": "admin_health"})["health"]
        doors = (health.get("probes") or {}).get("doors") or {}
        if health["verdict"] == "ok" and any(
                d["ok"] and d["probes"] for d in doors.values()):
            return health
        if time.time() > deadline:
            fail(f"overload: {what}: admin_health never answered ok with a "
                 f"door probed ok ({json.dumps(health)[:600]})")
        time.sleep(0.5)


def _stop_all(procs: list) -> None:
    """Terminate every child still running (then kill it after 30 s)."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


@contextlib.contextmanager
def _children(procs: list):
    """Stops the children in ``procs`` on leaving the block."""
    try:
        yield procs
    finally:
        _stop_all(procs)


def phase_overload(power: str, device: str = "cuda"):
    """The overload, health and recovery plane over the card's applier
    stage: the core (``front_end --log-dir L --consume-backchannel S``
    with ``OVERLOAD_CORE_FLAGS``: a rated flood tenant, the SLO engine,
    the canary prober and the health engine) and the stage child on the
    card (D=1024, S=256). The steady tenant's ``load_async`` workers run
    three windows; the flood's driver clients start ten seconds into the
    second and drain through the shed-retry lane. Checks: health ``ok`` (a
    door probed ok) before the load and again after the drain; the flood
    tenant's SLO ok when the flood starts and violated before it has
    drained, its ``obs.slo.violations`` counted; sheds
    labelled with the flood tenant only, the flood's driver retried and
    the steady workers were never shed; every op of both tenants acked,
    no hard nack; every doc's ``applierSeq`` at its seq; the stage's farm
    (loaded on the card) escalated nothing and equals a CPU applier fed
    the whole log, flood and canary docs included; every doc's log
    replays through the invariant monitor (no clientSeq gap or
    duplicate: a retried shed op landed once) and the stage's
    ``applied`` records reach every doc's last seq. The stage child's
    launches are its own: returns 0."""
    from fluidframework_tpu_torch.driver.network import _Transport
    from fluidframework_tpu_torch.obs import parse_prometheus
    from fluidframework_tpu_torch.obs.probe import CANARY_DOC, CANARY_TENANT
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )
    from fluidframework_tpu_torch.service.stage_runner import ApplierStage

    run = OVERLOAD_RUN
    bench = [f"ovl{w}d{d}" for w in range(run["workers"])
             for d in range(run["docs_per_worker"])]
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    err_path = os.path.join(out_dir, "overload_stderr.txt")
    open(err_path, "w").close()
    procs, flood, watch, rpc = [], None, None, None
    row = {"phase": "overload", "docs": len(bench), **run,
           "windows": OVERLOAD_WINDOWS, "flood": dict(OVERLOAD_FLOOD),
           "core_flags": OVERLOAD_CORE_FLAGS}
    t_phase = time.perf_counter()
    try:
        # the children write into the scratch dir: they stop first
        with _scratch_dir() as tmp, _children(procs):
            log_dir, state_dir = (os.path.join(tmp, "log"),
                                  os.path.join(tmp, "state"))
            stage, _ = _spawn_ready(
                ["fluidframework_tpu_torch.service.stage_runner", "--stage",
                 "applier", "--log-dir", log_dir, "--state-dir", state_dir,
                 "--device", device,
                 "--max-docs", str(SERVICE_GEO["max_docs"]),
                 "--max-slots", str(SERVICE_GEO["max_slots"])],
                "READY", err_path, "overload: the applier stage")
            procs.append(stage)
            core, line = _spawn_ready(
                ["fluidframework_tpu_torch.service.front_end", "--port", "0",
                 "--log-dir", log_dir, "--consume-backchannel", state_dir,
                 *OVERLOAD_CORE_FLAGS],
                "LISTENING", err_path, "overload: the core")
            procs.append(core)
            port = int(line.rsplit(":", 1)[1])
            servers = {"core": core.pid, "stage": stage.pid}
            cpu0 = {k: _cpu_seconds(pid) for k, pid in servers.items()}
            rpc = _Transport("127.0.0.1", port, timeout=60.0)
            t0 = time.time()
            health = _wait_health_ok(rpc, "before the load")
            row["health_before"] = {
                "seconds": time.time() - t0,
                "doors": {k: {"ok": d["ok"], "probes": d["probes"]}
                          for k, d in health["probes"]["doors"].items()}}
            watch = _OverloadWatch(port, time.time())

            windows = {}
            for name, rounds in OVERLOAD_WINDOWS.items():
                during = None
                if name == "during":
                    # during() runs as the start instant is handed out:
                    # the workers start NETWORK_START_MARGIN_S later
                    flood = _Flood(port, **OVERLOAD_FLOOD)
                    flood_thread = threading.Thread(
                        target=flood.start, daemon=True,
                        args=(NETWORK_START_MARGIN_S
                              + OVERLOAD_FLOOD_AFTER_S,))
                    during = flood_thread.start
                load, last_ack = _run_load(
                    dict(run, rounds=rounds), [port] * run["workers"],
                    "ovl", servers, procs, err_path, "overload",
                    during=during, trace_sample_n=1)
                windows[name] = {k: load[k] for k in (
                    "ops", "ops_per_sec", "p50_ack_ms", "p99_ack_ms",
                    "connect_seconds", "late_s", "cpu_seconds", "shed")}
                windows[name]["start"] = round(
                    last_ack - load["seconds"] - watch.t0, 3)
                if load["shed"]:
                    fail(f"overload: the steady tenant was shed "
                         f"({load['shed']} ops, window {name})")
                if name == "during":
                    flood_thread.join(CHILD_TIMEOUT_S)
                    deadline = time.time() + CHILD_TIMEOUT_S
                    while not flood.drained():
                        if flood.hard or time.time() > deadline:
                            fail(f"overload: the flood did not drain: "
                                 f"{flood.report()}")
                        time.sleep(0.05)
                    row["flood"].update(
                        submit_seconds=flood.submit_seconds,
                        offered_ops_per_sec=flood.total
                        / max(flood.submit_seconds, 1e-9),
                        drain_seconds=flood.last_ack - flood.started,
                        start=round(flood.started - watch.t0, 3),
                        shed_retries=flood.shed_retries(), acked=sum(
                            flood.acked))
            row["steady"] = windows
            if flood.hard:
                fail(f"overload: hard nacks on the flood: {flood.report()}")
            if flood.shed_retries() <= 0:
                watch.join()
                fail("overload: the flood's driver never retried a shed op "
                     f"(flood {row['flood']}, SLO {watch.slo})")

            # quiescence: every doc's applierSeq at its seq
            groups = {"bench": bench, "flood": flood.docs,
                      CANARY_TENANT: [CANARY_DOC]}
            while True:
                status = {t: _network_statuses(rpc, docs, tenant=t)
                          for t, docs in groups.items()}
                lagging = [(t, d) for t, st in status.items()
                           for d, (seq, app) in st.items() if app != seq]
                if not lagging:
                    break
                if time.time() - last_ack > CHILD_TIMEOUT_S:
                    fail(f"overload: {len(lagging)} docs' applierSeq lag "
                         f"the core (first {lagging[0]})")
                time.sleep(0.05)
            row["catch_up_lag_seconds"] = time.time() - last_ack
            health = _wait_health_ok(rpc, "after the drain")
            row["health_after_seconds"] = time.time() - last_ack
            watch.join()
            row["slo_transitions"] = watch.slo
            row["slo_peaks"] = watch.peak
            row["health_verdicts"] = watch.health
            # the flood tenant's SLO: ok when the flood starts (it has
            # no sample before), then violated before the flood drained
            t0f = row["flood"]["start"]
            t1f = t0f + row["flood"]["drain_seconds"]
            flood_slo = watch.slo.get("flood_ingest", [])
            at_start = [e["state"] for e in flood_slo if e["t"] <= t0f][-1:]
            during = [e["state"] for e in flood_slo if t0f < e["t"] <= t1f]
            if at_start != ["ok"] or "violated" not in during:
                fail(f"overload: the flood tenant's SLO read {at_start} at "
                     f"the flood's start and {during} until its drain (want "
                     f"ok, then violated): {watch.slo}, peaks "
                     f"{watch.peak}")
            scrape = parse_prometheus(rpc.request(
                {"t": "admin_metrics_scrape"})["scrape"])
            shed = scrape.get("fluid_net_admission_shed", {})
            tenants = sorted({dict(k).get("tenant") for k in shed})
            row["admission_shed"] = {
                "ops": sum(shed.values()), "tenants": tenants,
                "by_reason": {dict(k).get("reason"): v
                              for k, v in shed.items()}}
            if sum(shed.values()) <= 0 or tenants != ["flood"]:
                fail(f"overload: sheds {row['admission_shed']} (want > 0, "
                     "the flood tenant only)")
            violations = {dict(k).get("slo"): v for k, v in scrape.get(
                "fluid_obs_slo_violations", {}).items()}
            row["slo_violations"] = violations
            if violations.get("flood_ingest", 0) < 1:
                fail(f"overload: obs.slo.violations never counted the flood "
                     f"tenant's SLO ({violations})")
            row["stage_waves_observed"] = int(sum(
                v for k, v in scrape.get("fluid_obs_hop_ms_count",
                                         {}).items()
                if dict(k).get("pair") == "stage_to_execute"))
            if not row["stage_waves_observed"]:
                fail("overload: the stage reported no wave")
            cpu1 = {k: _cpu_seconds(pid) for k, pid in servers.items()}
            row["cpu_seconds"] = {k: cpu1[k] - cpu0[k] for k in servers}
            rpc.close()
            rpc = None
            # the canary goes on writing while the core runs: stop the
            # core, then let the stage reach every doc's final seq. Every
            # doc's log through the invariant monitor (a retried shed op
            # landed once: no clientSeq gap or duplicate)
            core.terminate()
            core.wait(timeout=60)
            replay = {t: _replay_log(log_dir, docs, tenant=t,
                                     phase="overload")
                      for t, docs in groups.items()}
            last = {d: r["last"][d] for r in replay.values()
                    for d in r["last"]}
            deadline = time.time() + CHILD_TIMEOUT_S
            while True:
                applied = _stage_applied(state_dir)["applied"]
                short = [d for d, seq in last.items()
                         if applied.get(d, 0) < seq]
                if not short:
                    break
                if time.time() > deadline:
                    fail(f"overload: the stage's applied records stop short "
                         f"of {len(short)} docs' last seq (first "
                         f"{short[0]}: {applied.get(short[0])} < "
                         f"{last[short[0]]})")
                time.sleep(0.2)
            row["replay"] = {t: {k: r[k] for k in ("observed", "redelivered")}
                             for t, r in replay.items()}
            stage.send_signal(signal.SIGTERM)
            stage.wait(timeout=60)

            # the stage's farm against a CPU applier fed the whole log
            t0 = time.perf_counter()
            farm = load_applier_checkpoint(
                os.path.join(state_dir, "applier"), device=device)
            if farm.host_escalations or farm._host_docs:
                fail("overload: the stage escalated docs")
            ref = ApplierStage(log_dir, os.path.join(tmp, "cpu"),
                               max_docs=SERVICE_GEO["max_docs"],
                               max_slots=SERVICE_GEO["max_slots"],
                               device="cpu")
            while ref.run_once():
                pass
            bad = [(t, d) for t, docs in groups.items() for d in docs
                   if ref.applier.get_text(t, d) != farm.get_text(t, d)]
            if bad:
                fail(f"overload: {len(bad)} docs of the stage's farm differ "
                     f"from the CPU applier (first {bad[0]})")
            if any(farm.get_text("flood", d) != "flood"
                   for d in flood.docs):
                fail("overload: a flood doc's text is not its one word")
            ref.shared.close()
            row["farm_check_seconds"] = time.perf_counter() - t0

    finally:
        if watch is not None and watch.thread.is_alive():
            watch.stop.set()
        if flood is not None:
            flood.close()
        if rpc is not None:
            rpc.close()
        _stop_all(procs)
    row["phase_seconds"] = time.perf_counter() - t_phase
    row["card"] = power
    emit(row)
    return 0


def phase_campaigns(power: str):
    """The overload and recovery campaigns of ``chaos/`` in their full
    forms at seed 0, host code on the card's machine: ``noisy`` (a
    flooding tenant shed in process), ``coldstart`` (the whole fleet
    killed and restarted twice, 0.75 s leases), ``multihost`` (one host
    group killed and respawned; every ``os.killpg`` it makes is refused
    if it names this process's own group) and soak phase B. Each prints
    its result's seed-fixed fields and seconds; any failure fails the
    phase."""
    from fluidframework_tpu_torch.chaos import coldstart, multihost, noisy
    from fluidframework_tpu_torch.chaos.soak import run_soak
    from fluidframework_tpu_torch.utils.telemetry import Counters

    own_group = os.getpgrp()
    signalled = []
    killpg = os.killpg

    def guarded_killpg(pgid: int, sig: int) -> None:
        if pgid == own_group:
            fail(f"campaigns: a fleet signalled the smoke's own process "
                 f"group {pgid}")
        signalled.append(pgid)
        killpg(pgid, sig)

    def soak_b():
        out = run_soak(0, phases="b")
        return {k: out[k] for k in ("coverage", "observed", "redelivered",
                                    "counters")}

    def noisy_full():
        out = noisy.run_noisy(0)
        return {k: out[k] for k in ("flood", "steady", "shed_ops",
                                    "shed_tenants", "slo")}

    row = {"phase": "campaigns", "seed": 0}
    campaigns = (
        ("noisy", noisy_full),
        ("coldstart", lambda: coldstart.run_campaign(0, Counters())),
        ("multihost", lambda: multihost.run_campaign(0, Counters())),
        ("soak_b", soak_b))
    os.killpg = guarded_killpg
    try:
        for name, run in campaigns:
            t0 = time.perf_counter()
            try:
                out = run()
            except Exception as e:  # noqa: BLE001 — the phase's verdict
                fail(f"campaigns: {name} failed: {e!r}")
            row[name] = {**out, "seconds": time.perf_counter() - t0}
    finally:
        os.killpg = killpg
    if not signalled:
        fail("campaigns: multihost killed no process group")
    row["process_groups_killed"] = len(signalled)
    row["card"] = power
    emit(row)


#: the host_admin phase, part A: each of the port's seven apps on a
#: topology of its dev host (the JAX tests' pairs: todo through gateways,
#: canvas on the sharded core; shared_text on the split core; the other
#: four on one core)
HOST_APPS = (("todo", "gateway"), ("canvas", "sharded"),
             ("shared_text", "split"), ("clicker", "single"),
             ("table_doc", "single"), ("sudoku", "single"),
             ("album", "single"))
HOST_APP_TIMEOUT_S = 240.0
#: part B: the network phase's width (1024 docs x 2 clients, boxcars of
#: 12 at 4 Hz) cut in depth to one round, 24,576 ops, every worker direct
#: to the core
HOST_ADMIN_RUN = dict(NETWORK_RUN, rounds=1)
HOST_ADMIN_SECRET = "host-admin-smoke"
#: monitor ticks read while the load runs (from its start instant)
HOST_ADMIN_EARLY_TICKS = 1
#: monitor ticks after the last ack within which every doc must read
#: ``applier_lag 0``
HOST_ADMIN_LAG_TICKS = 120
_MONITOR_ROW = re.compile(
    r"^  (\S+): seq (\d+) msn (\d+) clients (\d+) applier_lag (\S+)$")


class _AppGroups:
    """The process groups of part A's dev hosts (each host, its fleet and
    its app's actors): on leaving the block no new one starts and every
    live one is killed."""

    def __init__(self):
        self.groups: list = []
        self.lock = threading.Lock()
        self.closed = False

    def spawn(self, argv: list):
        with self.lock:
            if self.closed:
                raise RuntimeError("the phase is over")
            proc = subprocess.Popen(
                argv, cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
            self.groups.append(proc)
            return proc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with self.lock:
            self.closed = True
            for proc in self.groups:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)


def _host_app(app: str, kind: str, err_path: str,
              groups: _AppGroups) -> dict:
    """``python -m fluidframework_tpu_torch.host APP -t KIND``: its seconds
    and its ``CONVERGED`` line. Fails the phase unless it exits 0 with
    one; on a timeout its whole process group (the host's fleet and the
    app's actors) is killed."""
    t0 = time.perf_counter()
    proc = groups.spawn(
        [sys.executable, "-m", "fluidframework_tpu_torch.host", app, "-t",
         kind])
    try:
        out, err = proc.communicate(timeout=HOST_APP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"host_admin: {app} on {kind} ran past {HOST_APP_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    with open(err_path, "a") as f:
        f.write(err)
    said = [ln.strip() for ln in out.splitlines()
            if ln.strip().startswith("CONVERGED")]
    if proc.returncode != 0 or not said:
        fail(f"host_admin: {app} on {kind} exited {proc.returncode} "
             f"without converging ({out[-400:]!r}); stderr in {err_path}")
    return {"topology": kind, "seconds": seconds, "converged": said[-1]}


def _admin_cli(port: int, *argv, secret: bool = True) -> tuple:
    """The port's ``admin`` CLI in this process: (exit code, its standard
    output, seconds)."""
    import io

    from fluidframework_tpu_torch import admin

    args = ["--port", str(port)]
    if secret:
        args += ["--admin-secret", HOST_ADMIN_SECRET]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = admin.main(args + list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def _monitor_ticks(text: str) -> list:
    """Each tick of ``admin monitor``'s output as {doc: applier_lag}, the
    lag an int, or None where the monitor printed "-"."""
    ticks = []
    for ln in text.splitlines():
        if ln.startswith("tick "):
            ticks.append({})
        elif ticks and (m := _MONITOR_ROW.match(ln)):
            lag = m.group(5)
            ticks[-1][m.group(1)] = None if lag == "-" else int(lag)
    return ticks


class _SecretRpc:
    """A transport that signs every admin frame with the phase's secret."""

    def __init__(self, transport):
        self.transport = transport

    def request(self, frame: dict) -> dict:
        return self.transport.request(dict(frame, secret=HOST_ADMIN_SECRET))


def phase_host_admin(power: str, device: str = "cuda"):
    """The operator and developer surface of the port.

    Part A (on a thread beside part B): the dev host runs each of the
    seven apps on its topology (``HOST_APPS``); each converges. Part B,
    the operator's view over the card: one core (``front_end --log-dir L
    --consume-backchannel S --admin-secret X --journal J --probe
    --probe-tick 3600``) beside the
    applier stage child on the card (D=1024, S=256, K=32) under
    ``HOST_ADMIN_RUN``. ``admin monitor`` shows some doc with
    ``applier_lag`` > 0 while ops are in flight, then every doc at 0
    within ``HOST_ADMIN_LAG_TICKS`` ticks of the last ack; ``docs`` lists
    every doc; ``status`` of sampled docs equals the core's status RPC;
    ``tenant-add`` and ``tenant-rm`` are refused without the secret and
    done with it; ``metrics``, ``journal``, ``slo``, ``health`` and
    ``flight dump`` exit 0; ``bundle`` writes the manifest and the core's
    files, which the port's doctor triages with no anomaly; the stage's final checkpoint, loaded on the
    card, escalated nothing and equals a CPU applier fed the core's log.
    The health engine is armed but its canary's first pass is set past
    the phase: a canary doc would take a row of the D=1024 farm. B1 runs
    in the stage child only, so the smoke's own launch count is
    unchanged."""
    from fluidframework_tpu_torch.driver.network import _Transport
    from fluidframework_tpu_torch.service.gpu_applier import (
        load_applier_checkpoint,
    )
    from fluidframework_tpu_torch.service.stage_runner import ApplierStage
    from fluidframework_tpu_torch.tools import doctor

    run = HOST_ADMIN_RUN
    docs = [f"hadm{w}d{d}" for w in range(run["workers"])
            for d in range(run["docs_per_worker"])]
    out_dir = os.path.join(HERE, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    err_path = os.path.join(out_dir, "host_admin_stderr.txt")
    row = {"phase": "host_admin", "docs": len(docs), **run,
           "b1": "launched in the stage child only (its own process): the "
                 "smoke's own count is unchanged; its applied records "
                 "bring every doc to applier_lag 0 and its farm equals a "
                 "CPU applier's"}
    procs = []
    t_phase = time.perf_counter()
    with _scratch_dir() as tmp, _children(procs), _AppGroups() as groups:
        log_dir, state_dir = (os.path.join(tmp, "log"),
                              os.path.join(tmp, "state"))
        # the stage child sets up torch and the card while part A runs
        with open(err_path, "a") as err:
            stage = subprocess.Popen(
                [sys.executable, "-m",
                 "fluidframework_tpu_torch.service.stage_runner", "--stage",
                 "applier", "--log-dir", log_dir, "--state-dir", state_dir,
                 "--device", device,
                 "--max-docs", str(SERVICE_GEO["max_docs"]),
                 "--max-slots", str(SERVICE_GEO["max_slots"])],
                cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True)
        procs.append(stage)
        said = []
        reader = threading.Thread(
            target=lambda: said.append(stage.stdout.readline()), daemon=True)
        reader.start()
        # part A runs beside part B on a thread of its own (its apps one
        # after another): the phase takes the longer of the two
        part_a: dict = {}

        def run_part_a():
            t0 = time.perf_counter()
            try:
                for app, kind in HOST_APPS:
                    part_a[app] = _host_app(app, kind, err_path, groups)
            except BaseException as e:  # fail() exits: reported below
                part_a["failed"] = repr(e)
                raise
            finally:
                part_a["seconds"] = time.perf_counter() - t0

        apps = threading.Thread(target=run_part_a, daemon=True)
        apps.start()
        reader.join(CHILD_TIMEOUT_S)
        if not said or not said[0].startswith("READY"):
            fail(f"host_admin: the applier stage child did not start on "
                 f"{device} (got {said}, rc {stage.poll()}); stderr in "
                 f"{err_path}")
        core, line = _spawn_ready(
            ["fluidframework_tpu_torch.service.front_end", "--port", "0",
             "--log-dir", log_dir, "--consume-backchannel", state_dir,
             "--admin-secret", HOST_ADMIN_SECRET,
             "--journal", os.path.join(tmp, "journal.jsonl"),
             "--probe", "--probe-tick", "3600"],
            "LISTENING", err_path, "host_admin: the core")
        procs.append(core)
        port = int(line.rsplit(":", 1)[1])

        # the load, and the monitor reading the core while it runs
        early = {}

        def during():
            time.sleep(NETWORK_START_MARGIN_S)
            rc, text, seconds = _admin_cli(
                port, "monitor", "--interval", "0.5", "--count",
                str(HOST_ADMIN_EARLY_TICKS))
            early.update(rc=rc, ticks=_monitor_ticks(text), seconds=seconds)

        load, last_ack = _run_load(
            run, [port] * run["workers"], "hadm",
            {"core": core.pid, "stage": stage.pid}, procs, err_path,
            "host_admin", during=during)
        row["load"] = load
        ticks = early["ticks"]
        lagging = [sum(1 for lag in t.values() if lag) for t in ticks]
        row["monitor_early"] = {
            "seconds": early["seconds"], "docs": [len(t) for t in ticks],
            "lagging_docs": lagging,
            "max_lag": [max([lag or 0 for lag in t.values()] or [0])
                        for t in ticks]}
        if early["rc"] != 0 or len(ticks) != HOST_ADMIN_EARLY_TICKS:
            fail(f"host_admin: admin monitor exited {early['rc']} with "
                 f"{len(ticks)} ticks during the load")
        if not any(lagging):
            fail("host_admin: no doc showed applier_lag > 0 on the "
                 f"monitor's ticks during the load ({row['monitor_early']})")

        # after the last ack: every doc's applier_lag reaches 0
        want = [f"bench/{d}" for d in docs]
        for tick in range(1, HOST_ADMIN_LAG_TICKS + 1):
            rc, text, _ = _admin_cli(port, "monitor", "--interval", "0.5",
                                     "--count", "1")
            (lags,) = _monitor_ticks(text) or [{}]
            if rc == 0 and all(lags.get(d) == 0 for d in want):
                break
            time.sleep(0.5)
        else:
            behind = [d for d in want if lags.get(d) != 0]
            fail(f"host_admin: {len(behind)} docs not at applier_lag 0 "
                 f"after {HOST_ADMIN_LAG_TICKS} monitor ticks (first "
                 f"{behind[0]}: {lags.get(behind[0])})")
        row["ticks_to_lag_zero"] = tick
        row["lag_zero_seconds"] = time.time() - last_ack

        rpc = _SecretRpc(_Transport("127.0.0.1", port, timeout=60.0))
        try:
            _settled_seqs(rpc, docs, "host_admin")
            seconds = {}
            rc, text, seconds["docs"] = _admin_cli(port, "docs")
            listed = set(text.split())
            if rc != 0 or listed != set(want):
                fail(f"host_admin: admin docs listed {len(listed)} docs, "
                     f"{len(listed & set(want))} of the load's {len(want)}")
            sample = docs[::len(docs) // 8]
            seconds["status"] = 0.0
            for doc in sample:
                rc, text, took = _admin_cli(port, "status", "bench", doc)
                seconds["status"] += took
                st = rpc.request({"t": "admin_status", "tenant": "bench",
                                  "doc": doc})["status"]
                if rc != 0 or json.loads(text) != st:
                    fail(f"host_admin: admin status bench {doc} disagrees "
                         f"with the core's status RPC ({text[:200]!r})")
            row["status_sampled"] = len(sample)

            # tenant CRUD: refused without the secret, done with it
            for argv, done in ((("tenant-add", "hadm-t", "hadm-s"),
                                "registered hadm-t"),
                               (("tenant-rm", "hadm-t"), "removed hadm-t")):
                try:
                    _admin_cli(port, *argv, secret=False)
                except RuntimeError:
                    pass
                else:
                    fail(f"host_admin: admin {argv[0]} without the secret "
                         "was not refused")
                rc, text, seconds[argv[0]] = _admin_cli(port, *argv)
                if rc != 0 or done not in text:
                    fail(f"host_admin: admin {argv[0]} exited {rc} "
                         f"({text[:200]!r})")
            for name, argv in (("metrics", ("metrics",)),
                               ("journal", ("journal",)),
                               ("slo", ("slo",)), ("health", ("health",)),
                               ("flight_dump", ("flight", "dump", "--reason",
                                                "host_admin"))):
                rc, text, seconds[name] = _admin_cli(port, *argv)
                if rc != 0:
                    fail(f"host_admin: admin {' '.join(argv)} exited {rc} "
                         f"({text[-300:]!r})")

            bundle = os.path.join(tmp, "bundle")
            rc, text, seconds["bundle"] = _admin_cli(port, "bundle",
                                                     "--out", bundle)
            files = sorted(os.path.relpath(os.path.join(d, f), bundle)
                           for d, _, fs in os.walk(bundle) for f in fs)
            if rc != 0 or "manifest.json" not in files or not any(
                    f.startswith("cores/local/") for f in files):
                fail(f"host_admin: admin bundle exited {rc} with files "
                     f"{files}")
            t0 = time.perf_counter()
            report = doctor.diagnose(bundle)
            seconds["doctor"] = time.perf_counter() - t0
            # the core arms its journal and sets no SLO: the phase
            # explains no anomaly
            if report["anomalies"] or report["slo_burn"]:
                fail(f"host_admin: the doctor found {report['anomalies']} "
                     f"{report['slo_burn']} in the bundle")
            row["admin_seconds"] = seconds
            row["bundle_files"] = files
            row["doctor"] = {"anomalies": report["anomalies"],
                             "hop_pairs": report["hop_pairs"][:3]}
        finally:
            rpc.transport.close()

        # the stage's farm against a CPU applier fed the core's log
        stage.send_signal(signal.SIGTERM)
        stage.wait(timeout=60)
        t0 = time.perf_counter()
        farm = load_applier_checkpoint(os.path.join(state_dir, "applier"),
                                       device=device)
        if farm.host_escalations or farm._host_docs:
            fail("host_admin: the stage escalated docs")
        ref = ApplierStage(log_dir, os.path.join(tmp, "cpu"),
                           max_docs=SERVICE_GEO["max_docs"],
                           max_slots=SERVICE_GEO["max_slots"], device="cpu")
        while ref.run_once():
            pass
        bad = [d for d in docs if ref.applier.get_text("bench", d)
               != farm.get_text("bench", d)]
        ref.shared.close()
        if bad:
            fail(f"host_admin: {len(bad)} docs of the stage's farm differ "
                 f"from the CPU applier (first {bad[0]})")
        row["farm_check_seconds"] = time.perf_counter() - t0
        row["texts_match_cpu"] = True
        row["part_b_seconds"] = time.perf_counter() - t_phase
        apps.join(len(HOST_APPS) * HOST_APP_TIMEOUT_S)
        if apps.is_alive() or "failed" in part_a:
            fail(f"host_admin: part A failed ({part_a.get('failed')}); "
                 f"stderr in {err_path}")
        row["part_a_seconds"] = part_a.pop("seconds")
        row["part_a"] = part_a
    row["phase_seconds"] = time.perf_counter() - t_phase
    row["card"] = power
    emit(row)


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

    # B1's launches in this process, by phase (the stage children's are
    # their own)
    by_phase = {"main_path": timed(phase_main_path, power)}
    by_phase["farms"] = timed(phase_farms, power)
    timed(phase_escalation)
    by_phase["service"], app, cpu_texts, service_row = timed(
        phase_service, name, power)
    by_phase["checkpoint"] = timed(phase_checkpoint, app, power)
    by_phase["stage"] = timed(phase_stage, cpu_texts, power)
    timed(phase_split, cpu_texts, service_row, power)
    by_phase["summary"], _, held = timed(phase_summary, power)
    try:
        by_phase["history"] = timed(phase_history, held, power)
    finally:
        held.card.close()  # re-raises a worker exception: the run fails
    by_phase["soak"] = timed(phase_soak, power)
    by_phase["replay"] = timed(phase_replay, power)
    by_phase["apps"] = timed(phase_apps, power)
    timed(phase_host_admin, power)
    by_phase["network"] = timed(phase_network, power)
    by_phase["storage"] = timed(phase_storage, power)
    timed(phase_sharded, power)
    timed(phase_overload, power)
    timed(phase_campaigns, power)
    by_phase["mesh"] = timed(phase_mesh, power)
    timed(phase_long_doc, power)
    emit({"phase": "seconds", **seconds})
    launches = sum(by_phase.values())
    emit({"phase": "launches", "total": launches, **by_phase})

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
