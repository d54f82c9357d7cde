"""shared-text: the canonical collaborative-text example application.

JAX counterpart: ``examples/shared_text.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/shared-text (src/document.ts + component.ts)
— the reference's flagship SharedString app: rich text with markers,
bold/style annotations, and comment ranges that stay anchored as the
text changes around them.

This is the developer-surface proof: everything below uses only the
public framework API (DataObject + DDS channels) over the network
driver — the same stack an application author would ship.

Run the full demo (spawns a server process + two editor processes that
edit CONCURRENTLY, then prints both replicas' rendered documents):

    python -m fluidframework_tpu_torch.examples.shared_text

Or the pieces by hand:

    python -m fluidframework_tpu_torch.service.front_end --port 8123 &
    python -m fluidframework_tpu_torch.examples.shared_text \
        --connect 8123 --name alice --script a
    python -m fluidframework_tpu_torch.examples.shared_text \
        --connect 8123 --name bob   --script b
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

DOC_ID = "shared-text-demo"
COMMENTS = "comments"


class SharedTextDocument(DataObject):
    """The shared-text data object: a title cell, the text body, and a
    comment interval collection anchored to the body."""

    def initializing_first_time(self) -> None:
        self.create_channel("title", "shared-cell")
        self.create_channel("body", "shared-string")
        self.get_channel("title").set("Untitled document")

    @property
    def title(self):
        return self.get_channel("title")

    @property
    def body(self):
        return self.get_channel("body")

    @property
    def comments(self):
        return self.body.get_interval_collection(COMMENTS)

    # ------------------------------------------------------------- render

    def render(self) -> str:
        """Plain-terminal rendering: **bold** runs, ¶ markers, and
        [comment: …] ranges resolved to live positions."""
        body = self.body
        text = body.get_text()
        # character-level style lookup via the merge-tree client
        marks = []
        for start, end in self._bold_runs(text):
            marks.append((start, "**"))
            marks.append((end, "**"))
        for ival in self.comments:
            s, e = self.comments.position(ival)
            label = (ival.properties or {}).get("text", "?")
            marks.append((s, "["))
            marks.append((e, f" ⟦{label}⟧]"))
        out = []
        last = 0
        for pos, tag in sorted(marks, key=lambda m: m[0]):
            out.append(text[last:pos])
            out.append(tag)
            last = pos
        out.append(text[last:])
        rendered = "".join(out)
        return f"# {self.title.get()}\n{rendered}"

    def _bold_runs(self, text: str) -> list[tuple[int, int]]:
        runs = []
        start = None
        for i in range(len(text)):
            props = self.body.client.get_properties_at(i)
            bold = bool(props.get("bold"))
            if bold and start is None:
                start = i
            elif not bold and start is not None:
                runs.append((start, i))
                start = None
        if start is not None:
            runs.append((start, len(text)))
        return runs


FACTORY = DataObjectFactory("shared-text", SharedTextDocument)


def open_document(port: int,
                  creator: bool = False) -> tuple[object, SharedTextDocument]:
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if not creator:
        # the default store's attach op travels through the total order;
        # a joiner waits for it instead of racing the creator
        wait_until(lambda: "default" in container.runtime.data_stores)
    doc = FACTORY.create_or_load(container)
    return container, doc


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.05)
    return False


# ------------------------------------------------------------- edit scripts

def script_a(doc: SharedTextDocument) -> None:
    """Alice: writes the opening, titles the doc, bolds the greeting."""
    doc.title.set("Collaborative design notes")
    body = doc.body
    body.insert_text(0, "Welcome to the TPU fluid framework. ")
    body.annotate_range(0, 7, {"bold": True})
    body.insert_marker(len(body.get_text()), {"kind": "para"})
    body.insert_text(len(body.get_text()),
                     "The server only sequences; clients merge. ")


def script_b(doc: SharedTextDocument) -> None:
    """Bob: appends a section and leaves a comment on 'sequences' — the
    comment range keeps tracking the word as concurrent edits move it."""
    body = doc.body
    body.insert_text(len(body.get_text()),
                     "Summaries ride the same total order. ")
    # wait until alice's sentence shows up, then annotate a word of HERS
    wait_until(lambda: "sequences" in body.get_text())
    at = body.get_text().find("sequences")
    if at >= 0:
        doc.comments.add(at, at + len("sequences"),
                         {"text": "verify deli ordering claim"})


SCRIPTS = {"a": script_a, "b": script_b}


# --------------------------------------------------------------- processes

def run_editor(port: int, name: str, script: str) -> None:
    container, doc = open_document(port, creator=script == "a")
    if script == "a":
        # the orchestrator starts the second editor only after the doc
        # exists — concurrent first-creation is not part of this demo
        print("READY", flush=True)
    if not wait_until(lambda: container.connected):
        raise SystemExit(f"{name}: never connected")
    SCRIPTS[script](doc)
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit(f"{name}: ops never acked")
    # wait for the OTHER script's edits too, so the printed render is the
    # converged document (both scripts' sentinel text present)
    wait_until(lambda: "total order" in doc.body.get_text()
               and "clients merge" in doc.body.get_text())
    time.sleep(0.3)  # let the tail of remote ops drain
    print(json.dumps({"name": name, "render": doc.render(),
                      "text": doc.body.get_text()}))


def run_clients(port: int) -> int:
    """Drive the two editors against an ALREADY-RUNNING service on
    ``port`` (any topology — the dev host owns the deployment shape)."""
    def spawn(name, s):
        return subprocess.Popen(
            [sys.executable, "-m",
             "fluidframework_tpu_torch.examples.shared_text",
             "--connect", str(port), "--name", name, "--script", s],
            stdout=subprocess.PIPE, stderr=sys.stderr, text=True)

    alice = spawn("alice", "a")
    assert alice.stdout.readline().strip() == "READY"
    editors = [alice, spawn("bob", "b")]
    results = []
    try:
        for e in editors:
            out, _ = e.communicate(timeout=220)
            if e.returncode != 0:
                print(f"editor failed rc={e.returncode}")
                return 1
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for e in editors:  # a hung editor must not outlive the run
            if e.poll() is None:
                e.kill()
    texts = {r["text"] for r in results}
    print(f"\n=== {results[0]['name']}'s replica ===")
    print(results[0]["render"])
    print(f"\n=== {results[1]['name']}'s replica ===")
    print(results[1]["render"])
    if len(texts) == 1:
        print("\nCONVERGED: both replicas render identical documents")
        return 0
    print("\nDIVERGED!")
    return 1


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
    p = argparse.ArgumentParser(description="shared-text demo")
    p.add_argument("--connect", type=int, help="front-end port")
    p.add_argument("--name", default="editor")
    p.add_argument("--script", choices=sorted(SCRIPTS), default="a")
    args = p.parse_args()
    if args.connect:
        run_editor(args.connect, args.name, args.script)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
