"""canvas: a collaborative ink surface over the Ink DDS.

JAX counterpart: ``examples/canvas.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/canvas — the reference's drawing surface over
the Ink DDS (append-only stroke streams, dds/ink). N painter PROCESSES
draw concurrent strokes into one document; append-only semantics mean
strokes interleave but never conflict, and every replica converges to
the same stroke set and point counts.

    python -m fluidframework_tpu_torch.examples.canvas  # demo: 3 painters
    python -m fluidframework_tpu_torch.examples.canvas \
        --connect PORT [--create] --painter NAME
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..loader import Loader

DOC_ID = "canvas-demo"
POINTS_PER_STROKE = 16


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def open_canvas(port: int, creator: bool):
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if creator:
        ds = container.runtime.create_data_store("default")
        ink = ds.create_channel("ink", "ink")
    else:
        if not wait_until(
                lambda: "default" in container.runtime.data_stores
                and "ink" in container.runtime
                .get_data_store("default").channels):
            raise SystemExit("ink channel never replicated")
        ink = container.runtime.get_data_store("default").get_channel("ink")
    return container, ink


def run_painter(port: int, painter: str, strokes: int,
                creator: bool) -> None:
    container, ink = open_canvas(port, creator)
    if creator:
        print("READY", flush=True)
    wait_until(lambda: container.connected)
    for s in range(strokes):
        stroke_id = ink.create_stroke(
            pen={"color": painter, "thickness": 1 + s % 3})
        for i in range(POINTS_PER_STROKE):
            ink.append_point(stroke_id, x=float(i), y=float(s),
                             pressure=0.5)
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit("strokes never acked")
    print(json.dumps({"painter": painter, "strokes": strokes}))


def run_clients(port: int, n_procs: int = 3, strokes: int = 4) -> int:
    def spawn(painter, creator):
        args = [sys.executable, "-m",
                "fluidframework_tpu_torch.examples.canvas",
                "--connect", str(port), "--painter", painter,
                "--strokes", str(strokes)]
        if creator:
            args.append("--create")
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)

    first = spawn("red", True)
    assert first.stdout.readline().strip() == "READY"
    names = ["red", "green", "blue", "violet"][:n_procs]
    procs = [first] + [spawn(n, False) for n in names[1:]]
    try:
        for p in procs:
            p.communicate(timeout=220)
            if p.returncode != 0:
                print(f"painter failed rc={p.returncode}")
                return 1
    finally:
        for p in procs:  # a hung painter must not outlive the run
            if p.poll() is None:
                p.kill()

    _, ink = open_canvas(port, creator=False)
    want = n_procs * strokes

    def converged():
        got = ink.get_strokes()
        return (len(got) == want
                and all(len(s["points"]) == POINTS_PER_STROKE
                        for s in got))
    if not wait_until(converged):
        got = ink.get_strokes()
        print(f"DIVERGED: {len(got)} strokes "
              f"{[len(s['points']) for s in got]}")
        return 1
    by_pen = {}
    for s in ink.get_strokes():
        by_pen[s["pen"]["color"]] = by_pen.get(s["pen"]["color"], 0) + 1
    print(f"CONVERGED: {want} strokes x {POINTS_PER_STROKE} points, "
          f"by painter {by_pen}")
    return 0


def run_demo(n_procs: int = 3, strokes: int = 4) -> int:
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = server.stdout.readline().strip()
        port = int(line.rsplit(":", 1)[1])
        return run_clients(port, n_procs, strokes)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main() -> None:
    p = argparse.ArgumentParser(description="ink canvas demo")
    p.add_argument("--connect", type=int)
    p.add_argument("--painter", default="red")
    p.add_argument("--strokes", type=int, default=4)
    p.add_argument("--create", action="store_true")
    args = p.parse_args()
    if args.connect:
        run_painter(args.connect, args.painter, args.strokes, args.create)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
