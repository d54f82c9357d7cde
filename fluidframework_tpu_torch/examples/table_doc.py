"""table-doc: a table document composing THREE DDS types in one container.

JAX counterpart: ``examples/table_doc.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/table-document (src/document.ts) — the
reference's instructive composition: a SharedMatrix holds the cells
while sequence/map structures carry the surrounding document state, all
in one data store, all converging through the same total order.

Composition here:
- ``grid``    SharedMatrix — the cell values (row/col inserts survive
              concurrent edits via the permutation vectors);
- ``headers`` SharedMap — column labels keyed by column index;
- ``notes``   SharedString — free-text commentary under the table.

Run the full demo (server process + two editor processes editing the
SAME table concurrently, then both replicas' rendered tables printed):

    python -m fluidframework_tpu_torch.examples.table_doc

Or by hand against a live front end:

    python -m fluidframework_tpu_torch.service.front_end --port 8123 &
    python -m fluidframework_tpu_torch.examples.table_doc \
        --connect 8123 --name ana --script a
    python -m fluidframework_tpu_torch.examples.table_doc \
        --connect 8123 --name raj --script b
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..framework.data_object import (
    DataObject,
    DataObjectFactory,
)
from ..loader import Loader

DOC_ID = "table-doc-demo"


class TableDocument(DataObject):
    """A spreadsheet-shaped document: matrix cells + map headers +
    string notes, one data store."""

    def initializing_first_time(self) -> None:
        self.create_channel("grid", "shared-matrix")
        self.create_channel("headers", "shared-map")
        self.create_channel("notes", "shared-string")
        grid = self.grid
        grid.insert_rows(0, 3)
        grid.insert_cols(0, 3)

    @property
    def grid(self):
        return self.get_channel("grid")

    @property
    def headers(self):
        return self.get_channel("headers")

    @property
    def notes(self):
        return self.get_channel("notes")

    def render(self) -> str:
        grid = self.grid
        cols = grid.col_count
        labels = [str(self.headers.get(str(c)) or f"col{c}")
                  for c in range(cols)]
        widths = [max(len(labels[c]), 6) for c in range(cols)]
        lines = [" | ".join(l.ljust(w) for l, w in zip(labels, widths))]
        lines.append("-+-".join("-" * w for w in widths))
        for r in range(grid.row_count):
            cells = [str(grid.get_cell(r, c) if grid.get_cell(r, c)
                         is not None else "")
                     for c in range(cols)]
            lines.append(" | ".join(v.ljust(w)
                                    for v, w in zip(cells, widths)))
        return "\n".join(lines) + f"\nnotes: {self.notes.get_text()}"


FACTORY = DataObjectFactory("table-doc", TableDocument)


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.05)
    return False


def open_document(port: int, creator: bool) -> tuple[object, TableDocument]:
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if not creator:
        wait_until(lambda: "default" in container.runtime.data_stores)
    return container, FACTORY.create_or_load(container)


# ------------------------------------------------------------- edit scripts

def script_a(doc: TableDocument) -> None:
    """Ana: labels the columns, fills the first data row, starts notes."""
    for c, label in enumerate(("region", "q1", "q2")):
        doc.headers.set(str(c), label)
    for c, v in enumerate(("north", 41, 37)):
        doc.grid.set_cell(0, c, v)
    doc.notes.insert_text(0, "Q1 dip explained by the launch slip. ")


def script_b(doc: TableDocument) -> None:
    """Raj: fills another row, inserts a TOTALS row concurrently with
    Ana's cell edits (the permutation vectors keep her writes anchored),
    and appends to the notes."""
    for c, v in enumerate(("south", 22, 58)):
        doc.grid.set_cell(1, c, v)
    doc.grid.insert_rows(doc.grid.row_count, 1)
    doc.grid.set_cell(doc.grid.row_count - 1, 0, "TOTAL")
    # wait until ana's WHOLE row landed before totalling — summing after
    # only part of it arrived would converge both replicas on a wrong
    # total (the wait must succeed, not time out)
    assert wait_until(lambda: all(
        doc.grid.get_cell(0, c) is not None for c in (1, 2)))
    for c in (1, 2):
        vals = [doc.grid.get_cell(r, c) for r in range(2)]
        doc.grid.set_cell(doc.grid.row_count - 1, c,
                          sum(v for v in vals if isinstance(v, int)))
    doc.notes.insert_text(len(doc.notes.get_text()),
                          "South beat forecast in Q2. ")


SCRIPTS = {"a": script_a, "b": script_b}


# --------------------------------------------------------------- processes

def run_editor(port: int, name: str, script: str) -> None:
    container, doc = open_document(port, creator=script == "a")
    if script == "a":
        print("READY", flush=True)
    if not wait_until(lambda: container.connected):
        raise SystemExit(f"{name}: never connected")
    SCRIPTS[script](doc)
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit(f"{name}: ops never acked")
    # converged = both scripts' sentinel edits visible
    wait_until(lambda: "launch slip" in doc.notes.get_text()
               and "forecast" in doc.notes.get_text()
               and doc.grid.get_cell(doc.grid.row_count - 1, 0) == "TOTAL")
    time.sleep(0.3)
    print(json.dumps({
        "name": name,
        "render": doc.render(),
        "rows": doc.grid.row_count,
        "cols": doc.grid.col_count,
        "notes": doc.notes.get_text(),
    }))


def run_clients(port: int) -> int:
    """Drive the two editors against an ALREADY-RUNNING service on
    ``port`` (any topology — the dev host owns the deployment shape)."""
    def spawn(name, s):
        return subprocess.Popen(
            [sys.executable, "-m",
             "fluidframework_tpu_torch.examples.table_doc",
             "--connect", str(port), "--name", name, "--script", s],
            stdout=subprocess.PIPE, stderr=sys.stderr, text=True)

    ana = spawn("ana", "a")
    assert ana.stdout.readline().strip() == "READY"
    editors = [ana, spawn("raj", "b")]
    results = []
    try:
        for p in editors:
            out, _ = p.communicate(timeout=220)
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in editors:  # a hung editor must not outlive the demo
            if p.poll() is None:
                p.kill()
    for r in results:
        print(f"--- {r['name']} ---")
        print(r["render"])
    a, b = results
    assert a["render"] == b["render"], "replicas diverged!"
    assert a["rows"] == 4 and a["cols"] == 3
    print("CONVERGED: both replicas render the same table")
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
    p = argparse.ArgumentParser(description="table-doc demo")
    p.add_argument("--connect", type=int, default=None)
    p.add_argument("--name", default="editor")
    p.add_argument("--script", choices=sorted(SCRIPTS), default="a")
    args = p.parse_args()
    if args.connect is None:
        raise SystemExit(run_demo())
    run_editor(args.connect, args.name, args.script)


if __name__ == "__main__":
    main()
