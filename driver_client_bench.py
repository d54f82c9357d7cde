"""Throughput of clients of the port's network driver, against one core.

    python3 driver_client_bench.py [--clients 8] [--ops 8000] [--batch 20]
                                   [--runs 1]

Starts one core of this checkout (``front_end --port 0``: no tenant rate,
no SLO, so nothing is shed) and, in this process, ``--clients`` delta
connections of the driver stack (``NetworkDocumentServiceFactory``), one
doc each. Each client submits ``--ops`` ops in boxcars of ``--batch`` as
fast as its driver takes them (one insert of a word, then annotates of
it, so a doc never outgrows its slots). A run ends when every op is
acked. To compare two versions of the driver, run a copy of the script
from the root of each checkout, in turns, on the same machine.

Prints one JSON line a run: the acked ops/s from the first submit to the
last ack, this process's CPU seconds per 1,000 ops (the driver's own
cost, the core being another process), the shed retries (0: nothing is
shed) and the hard nacks. Exits nonzero if an op was not acked within
the timeout or took a hard nack.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 300.0


def start_core() -> tuple:
    """One core of this checkout on a free port: (process, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"], cwd=HERE, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.startswith("LISTENING"):
        proc.kill()
        raise SystemExit(f"the core did not start: {line!r}")
    return proc, int(line.strip().rsplit(":", 1)[1])


def run(port: int, clients: int, ops: int, batch: int) -> dict:
    from fluidframework_tpu_torch.driver.network import (
        NetworkDocumentServiceFactory,
    )
    from fluidframework_tpu_torch.mergetree.ops import (
        AnnotateOp,
        InsertOp,
        op_to_wire,
    )
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage,
        MessageType,
    )

    factory = NetworkDocumentServiceFactory("127.0.0.1", port)
    tag = f"b{time.monotonic_ns()}"
    acked, hard, done = [0] * clients, [], threading.Event()
    total = clients * (ops // batch) * batch

    def on_ack(i):
        acked[i] += 1
        if sum(acked) >= total:
            done.set()

    conns = []
    for i in range(clients):
        conn = factory.create_document_service(
            "bench", f"{tag}d{i}").connect_to_delta_stream()
        conn.on_op = lambda m, i=i, me=conn.client_id: (
            m.client_id == me and on_ack(i))
        conn.on_nack = lambda n: hard.append(f"{n.code} {n.message}")
        conns.append(conn)

    def boxcar(first: int) -> list:
        out = []
        for cseq in range(first, first + batch):
            op = (InsertOp(pos=0, text="bench") if cseq == 1 else
                  AnnotateOp(start=0, end=5, props={"b": cseq % 4}))
            out.append(DocumentMessage(
                client_sequence_number=cseq, reference_sequence_number=0,
                type=MessageType.OPERATION,
                contents={"kind": "chanop", "address": "default",
                          "contents": {"address": "text",
                                       "contents": op_to_wire(op)}}))
        return out

    cars = [boxcar(first) for first in range(1, ops - batch + 2, batch)]
    cpu0, t0 = time.process_time(), time.perf_counter()
    for car in cars:
        for conn in conns:
            conn.submit(car)
    submitted = time.perf_counter() - t0
    drained = done.wait(TIMEOUT_S)
    seconds = time.perf_counter() - t0
    cpu = time.process_time() - cpu0
    retries = factory.counters.snapshot().get("driver.submit.shed_retries", 0)
    for conn in conns:
        conn.close()
    return {"clients": clients, "ops": total, "batch": batch,
            "acked": sum(acked), "drained": drained,
            "submit_seconds": submitted, "seconds": seconds,
            "ops_per_sec": sum(acked) / seconds,
            "client_cpu_s_per_kop": 1000.0 * cpu / max(sum(acked), 1),
            "shed_retries": retries, "hard_nacks": hard[:3]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--ops", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    core, port = start_core()
    ok = True
    try:
        for k in range(args.runs):
            row = run(port, args.clients, args.ops, args.batch)
            row["run"] = k
            print(json.dumps(row), flush=True)
            ok = ok and row["drained"] and not row["hard_nacks"]
    finally:
        core.terminate()
        core.wait(timeout=30)
    if not ok:
        raise SystemExit("driver_client_bench: an op was not acked")


if __name__ == "__main__":
    main()
