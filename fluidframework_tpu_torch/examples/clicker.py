"""clicker: the canonical SharedCounter example (BASELINE config 2).

JAX counterpart: ``examples/clicker.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/clicker — the simplest real collaborative
app: a counter every client increments concurrently; commutative
increments mean no conflicts, just convergence. This version runs N
clicker PROCESSES hammering the same counter through the network driver
and proves the total.

    python -m fluidframework_tpu_torch.examples.clicker
        # demo: 4 processes x 25 clicks
    python -m fluidframework_tpu_torch.examples.clicker \
        --connect PORT --clicks N   # one clicker
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..loader import Loader

DOC_ID = "clicker-demo"


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def open_counter(port: int, creator: bool):
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if creator:
        ds = container.runtime.create_data_store("default")
        counter = ds.create_channel("clicks", "shared-counter")
    else:
        if not wait_until(
                lambda: "default" in container.runtime.data_stores
                and "clicks" in container.runtime
                .get_data_store("default").channels):
            raise SystemExit("counter never replicated")
        counter = container.runtime.get_data_store("default") \
            .get_channel("clicks")
    return container, counter


def run_clicker(port: int, clicks: int, creator: bool) -> None:
    container, counter = open_counter(port, creator)
    if creator:
        print("READY", flush=True)
    wait_until(lambda: container.connected)
    for _ in range(clicks):
        counter.increment(1)
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit("clicks never acked")
    print(json.dumps({"clicked": clicks, "sees": counter.value}))


def run_clients(port: int, n_procs: int = 4, clicks: int = 25) -> int:
    """Drive N clicker processes against an ALREADY-RUNNING service on
    ``port`` (any topology — the dev host owns the deployment shape)."""
    def spawn(creator):
        args = [sys.executable, "-m",
                "fluidframework_tpu_torch.examples.clicker",
                "--connect", str(port), "--clicks", str(clicks)]
        if creator:
            args.append("--create")
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)

    first = spawn(True)
    assert first.stdout.readline().strip() == "READY"
    procs = [first] + [spawn(False) for _ in range(n_procs - 1)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=220)
            if p.returncode != 0:
                print(f"clicker failed rc={p.returncode}")
                return 1
    finally:
        for p in procs:  # a hung clicker must not outlive the run
            if p.poll() is None:
                p.kill()

    # an observer verifies the converged total
    _, counter = open_counter(port, creator=False)
    want = n_procs * clicks
    if not wait_until(lambda: counter.value == want):
        print(f"DIVERGED: {counter.value} != {want}")
        return 1
    print(f"CONVERGED: {n_procs} processes x {clicks} clicks "
          f"= {counter.value}")
    return 0


def run_demo(n_procs: int = 4, clicks: int = 25) -> int:
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = server.stdout.readline().strip()
        port = int(line.rsplit(":", 1)[1])
        return run_clients(port, n_procs, clicks)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main() -> None:
    p = argparse.ArgumentParser(description="clicker demo")
    p.add_argument("--connect", type=int)
    p.add_argument("--clicks", type=int, default=25)
    p.add_argument("--create", action="store_true")
    args = p.parse_args()
    if args.connect:
        run_clicker(args.connect, args.clicks, args.create)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
