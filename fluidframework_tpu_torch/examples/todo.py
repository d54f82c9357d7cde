"""todo: a collaborative task list over map + string channels.

JAX counterpart: ``examples/todo.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/todo/src/Todo.ts — the reference's todo data
object keeps an order-preserving collection of TodoItem components, each
pairing editable SharedString text with checkbox state. Here the same
shape: a ``shared-map`` holds item metadata (``done`` flags, creation
order), and every item's text is its own ``shared-string`` channel —
concurrent text edits merge character-wise while concurrent checks are
last-writer-wins, exercising BOTH merge disciplines in one app.

    python -m fluidframework_tpu_torch.examples.todo  # demo: 3 processes
    python -m fluidframework_tpu_torch.examples.todo \
        --connect PORT [--create] --actor NAME
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..loader import Loader

DOC_ID = "todo-demo"


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


class TodoApp:
    """The app facade over the container (the data-object role)."""

    def __init__(self, port: int, creator: bool):
        loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
        self.container = loader.resolve("demo", DOC_ID)
        if creator:
            ds = self.container.runtime.create_data_store("default")
            self.items = ds.create_channel("items", "shared-map")
        else:
            if not wait_until(
                    lambda: "default" in self.container.runtime.data_stores
                    and "items" in self.container.runtime
                    .get_data_store("default").channels):
                raise SystemExit("todo map never replicated")
            self.items = self.container.runtime.get_data_store(
                "default").get_channel("items")
        self.ds = self.container.runtime.get_data_store("default")

    def add_item(self, item_id: str, text: str) -> None:
        s = self.ds.create_channel(f"text-{item_id}", "shared-string")
        s.insert_text(0, text)
        self.items.set(item_id, {"done": False})

    def text_of(self, item_id: str):
        name = f"text-{item_id}"
        if name not in self.ds.channels:
            return None
        return self.ds.get_channel(name)

    def set_done(self, item_id: str, done: bool) -> None:
        meta = dict(self.items.get(item_id) or {})
        meta["done"] = done
        self.items.set(item_id, meta)

    def snapshot(self) -> dict:
        out = {}
        for item_id in sorted(self.items.keys()):
            s = self.text_of(item_id)
            out[item_id] = {
                "text": s.get_text() if s is not None else None,
                "done": (self.items.get(item_id) or {}).get("done"),
            }
        return out


def run_actor(port: int, actor: str, creator: bool) -> None:
    app = TodoApp(port, creator)
    if creator:
        print("READY", flush=True)
    wait_until(lambda: app.container.connected)
    # every actor adds two items, marks one of them done, and decorates
    # the shared first item's text (concurrent inserts on one string)
    app.add_item(f"{actor}-a", f"task {actor}-a")
    app.add_item(f"{actor}-b", f"task {actor}-b")
    app.set_done(f"{actor}-a", True)
    if creator:
        app.add_item("shared", "shared: ")
    else:
        if not wait_until(lambda: app.text_of("shared") is not None):
            raise SystemExit("shared item never replicated")
    shared = app.text_of("shared")
    if not wait_until(lambda: "shared: " in shared.get_text()):
        raise SystemExit("shared text never replicated")
    shared.insert_text(len(shared.get_text()), f"[{actor}]")
    if not wait_until(lambda: app.container.runtime.pending.count == 0):
        raise SystemExit("todo edits never acked")
    print(json.dumps({"actor": actor, "items": len(list(app.items.keys()))}))


def run_clients(port: int, n_procs: int = 3) -> int:
    """Drive the scenario against an already-running service on PORT
    (the dev-host seam: ``python -m fluidframework_tpu_torch.host todo``)."""
    def spawn(actor, creator):
        args = [sys.executable, "-m", "fluidframework_tpu_torch.examples.todo",
                "--connect", str(port), "--actor", actor]
        if creator:
            args.append("--create")
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)

    first = spawn("p0", True)
    assert first.stdout.readline().strip() == "READY"
    procs = [first] + [spawn(f"p{i}", False) for i in range(1, n_procs)]
    try:
        for p in procs:
            p.communicate(timeout=220)
            if p.returncode != 0:
                print(f"todo actor failed rc={p.returncode}")
                return 1
    finally:
        for p in procs:  # a hung/failed run must not orphan actors
            if p.poll() is None:
                p.kill()

    # an observer checks full convergence
    app = TodoApp(port, creator=False)
    want_items = 2 * n_procs + 1

    def settled():
        snap = app.snapshot()
        if len(snap) != want_items:
            return False
        shared = snap.get("shared", {}).get("text") or ""
        return all(f"[p{i}]" in shared for i in range(n_procs))
    if not wait_until(settled):
        print(f"DIVERGED: {json.dumps(app.snapshot(), indent=1)}")
        return 1
    snap = app.snapshot()
    done = sum(1 for v in snap.values() if v["done"])
    print(f"CONVERGED: {want_items} items, {done} done, "
          f"shared text {snap['shared']['text']!r}")
    return 0


def run_demo(n_procs: int = 3) -> int:
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = server.stdout.readline().strip()
        port = int(line.rsplit(":", 1)[1])
        return run_clients(port, n_procs)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main() -> None:
    p = argparse.ArgumentParser(description="todo demo")
    p.add_argument("--connect", type=int)
    p.add_argument("--actor", default="p0")
    p.add_argument("--create", action="store_true")
    args = p.parse_args()
    if args.connect:
        run_actor(args.connect, args.actor, args.create)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
