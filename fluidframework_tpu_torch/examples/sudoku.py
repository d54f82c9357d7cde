"""sudoku: a collaborative puzzle grid over a shared map.

JAX counterpart: ``examples/sudoku.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/sudoku — the reference's sudoku data object
keys a SharedMap by "row,col" coordinate strings; every client writes
cell values into the same map and conflicting entries resolve
last-writer-wins. Here the same shape: three solver PROCESSES each fill
one band of a known solution concurrently, two of them deliberately
fight over one cell, and an observer proves every replica converged to
the identical board (including an identical winner for the contested
cell — LWW must pick the SAME writer everywhere).

    python -m fluidframework_tpu_torch.examples.sudoku
        # demo: 3 solver processes
    python -m fluidframework_tpu_torch.examples.sudoku \
        --connect PORT [--create] --band K
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..loader import Loader

DOC_ID = "sudoku-demo"

# a solved 9x9 grid (rows); bands of 3 rows per solver
SOLUTION = [
    "534678912",
    "672195348",
    "198342567",
    "859761423",
    "426853791",
    "713924856",
    "961537284",
    "287419635",
    "345286179",
]
CONTESTED = "4,4"  # both solver 0 and solver 2 write this cell


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def open_board(port: int, creator: bool):
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if creator:
        ds = container.runtime.create_data_store("default")
        board = ds.create_channel("board", "shared-map")
    else:
        if not wait_until(
                lambda: "default" in container.runtime.data_stores
                and "board" in container.runtime
                .get_data_store("default").channels):
            raise SystemExit("board never replicated")
        board = container.runtime.get_data_store(
            "default").get_channel("board")
    return container, board


def run_solver(port: int, band: int, creator: bool) -> None:
    container, board = open_board(port, creator)
    if creator:
        print("READY", flush=True)
    wait_until(lambda: container.connected)
    # fill this solver's 3-row band cell by cell (the contested cell is
    # left to the two fighters — its band owner writing it too would
    # make the LWW winner depend on gateway/scheduling timing)
    for r in range(band * 3, band * 3 + 3):
        for c in range(9):
            if f"{r},{c}" != CONTESTED:
                board.set(f"{r},{c}", int(SOLUTION[r][c]))
    # solvers 0 and 2 both write the contested cell (different values):
    # LWW must converge to ONE of them identically on every replica
    if band in (0, 2):
        board.set(CONTESTED, 100 + band)
    # the done marker is set AFTER every write: map ops from one client
    # apply in submission order, so seeing done-K proves K's contested
    # write (if any) is visible too — the snapshot below is
    # deterministic, not a race with in-flight writes
    board.set(f"done-{band}", 1)
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit("cell writes never acked")
    if not wait_until(lambda: all(
            board.get(f"done-{k}") for k in range(3))):
        raise SystemExit("peer solvers never finished")
    cells = {k: board.get(k) for k in board.keys() if "," in k}
    print(json.dumps({"band": band, "contested": board.get(CONTESTED),
                      "cells": len(cells),
                      "sum": sum(cells.values())}))


def run_clients(port: int) -> int:
    """Drive the three solvers against an ALREADY-RUNNING service on
    ``port`` (any topology — the dev host owns the deployment shape)."""
    def spawn(band, creator):
        args = [sys.executable, "-m",
                "fluidframework_tpu_torch.examples.sudoku",
                "--connect", str(port), "--band", str(band)]
        if creator:
            args.append("--create")
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)

    first = spawn(0, True)
    assert first.stdout.readline().strip() == "READY"
    procs = [first, spawn(1, False), spawn(2, False)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=220)
            if p.returncode != 0:
                print(f"solver failed rc={p.returncode}")
                return 1
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:  # a hung solver must not outlive the run
            if p.poll() is None:
                p.kill()

    # every replica saw the same contested winner and the same board sum
    winners = {r["contested"] for r in results}
    sums = {r["sum"] for r in results}
    if len(winners) != 1 or len(sums) != 1:
        print(f"DIVERGED: winners {winners} sums {sums}")
        return 1

    # an observer checks the final board against the solution
    _, board = open_board(port, creator=False)
    if not wait_until(lambda: all(
            board.get(f"done-{k}") for k in range(3))):
        print("DIVERGED: observer board incomplete")
        return 1
    wrong = [
        (r, c) for r in range(9) for c in range(9)
        if f"{r},{c}" != CONTESTED
        and board.get(f"{r},{c}") != int(SOLUTION[r][c])
    ]
    if wrong:
        print(f"DIVERGED: wrong cells {wrong[:5]}")
        return 1
    winner = board.get(CONTESTED)
    if winner not in (100, 102) or {winner} != winners:
        print(f"DIVERGED: contested cell {winner} vs replicas {winners}")
        return 1
    print(f"CONVERGED: 81 cells, contested cell won by solver "
          f"{winner - 100}")
    return 0


def run_demo() -> int:
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = server.stdout.readline().strip()
        port = int(line.rsplit(":", 1)[1])
        return run_clients(port)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main() -> None:
    p = argparse.ArgumentParser(description="sudoku demo")
    p.add_argument("--connect", type=int)
    p.add_argument("--band", type=int, default=0)
    p.add_argument("--create", action="store_true")
    args = p.parse_args()
    if args.connect:
        run_solver(args.connect, args.band, args.create)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
