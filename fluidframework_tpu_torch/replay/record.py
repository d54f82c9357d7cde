"""Corpus recorder: seeded multi-client scenarios → committed replay
corpus (file-driver layout + expectations).

JAX counterpart: ``fluidframework_tpu/replay/record.py``; the port's copy,
imports rebased to this package.

Ref: the reference's snapshot corpus is recorded real documents
(packages/test/snapshots README.md:80-97); here the corpus is generated
by the same randomized farms that fuzz the merge-tree, so it covers
concurrent inserts/removes/annotates, markers, map ops, and reconnects
deterministically.

``python -m fluidframework_tpu_torch.replay.record --out DIR [--device
cpu]`` records every scenario under ``DIR`` and replays each through the
replica farm, on ``cuda`` unless given ``--device cpu`` (no card and no
device given raises before anything is written). ``--out`` has no
default: the committed corpus under ``tests/corpus`` is the JAX
package's recording, which the port's tests and smoke compare against.
"""

from __future__ import annotations

import argparse
import json
import os
import random

from ..device import resolve_device
from ..driver import LocalDocumentServiceFactory
from ..driver.file import FileDocumentService, record_document
from ..loader import Loader
from ..service.local_server import LocalServer
from .tool import ReplayController, replay_through_applier

SCENARIOS = {
    # name → (seed, clients, rounds)
    "text-basic": (7, 2, 40),
    "text-conflict": (23, 4, 60),
    "text-map-mixed": (51, 3, 50),
}


def run_scenario(server: LocalServer, name: str, seed: int, n_clients: int,
                 rounds: int) -> str:
    """Deterministic multi-client editing session on one document."""
    rng = random.Random(seed)
    loader = Loader(LocalDocumentServiceFactory(server))
    clients = [loader.resolve("corpus", name) for _ in range(n_clients)]
    ds = clients[0].runtime.create_data_store("default")
    text = ds.create_channel("text", "shared-string")
    text.insert_text(0, "seed text for the corpus. ")
    kv = ds.create_channel("kv", "shared-map") if "map" in name else None
    if "basic" in name:
        # give one scenario an acked mid-stream summary, so the corpus
        # also covers boot-from-snapshot + tail replay
        from ..runtime.summarizer import SummaryManager

        SummaryManager(clients[0], max_ops=25)

    for r in range(rounds):
        c = clients[rng.randrange(n_clients)]
        s = c.runtime.get_data_store("default").get_channel("text")
        length = len(s.get_text())
        roll = rng.random()
        if roll < 0.45 or length < 6:
            pos = rng.randrange(length + 1)
            s.insert_text(pos, f"w{r} ")
        elif roll < 0.7:
            a = rng.randrange(length - 2)
            s.remove_text(a, min(length, a + 1 + rng.randrange(4)))
        elif roll < 0.85:
            a = rng.randrange(length - 2)
            s.annotate_range(a, min(length, a + 1 + rng.randrange(6)),
                             {"style": rng.randrange(4)})
        elif roll < 0.92:
            s.insert_marker(rng.randrange(length + 1),
                            {"kind": "para"}, {"m": r})
        elif kv is not None:
            m = c.runtime.get_data_store("default").get_channel("kv")
            m.set(f"k{rng.randrange(8)}", r)
        else:
            pos = rng.randrange(length + 1)
            s.insert_text(pos, "*")
    # convergence sanity before recording
    texts = {
        c.runtime.get_data_store("default").get_channel("text").get_text()
        for c in clients
    }
    assert len(texts) == 1, "scenario did not converge"
    return texts.pop()


def record_all(out_dir: str, device=None, epochs=None) -> None:
    """Record every scenario under ``out_dir`` and replay each through
    the farm on ``device`` (``cuda`` when None, which raises without a
    card before any scenario runs). ``epochs`` ({scenario: client-id
    epoch}) pins a scenario's client ids: the fingerprints in
    ``expect.json`` hash them, so a recording reproduces a corpus's
    fingerprints only under that corpus's epochs. By default each
    scenario's server draws its own."""
    device = resolve_device(device)
    for name, (seed, n_clients, rounds) in SCENARIOS.items():
        server = LocalServer()
        if epochs and name in epochs:
            server._client_epoch = epochs[name]
        live_text = run_scenario(server, name, seed, n_clients, rounds)
        doc_dir = record_document(server, "corpus", name, out_dir)
        # expectations come from an immediate replay; the live text cross-
        # checks that replay-through-container equals the live replicas
        expect = ReplayController(
            FileDocumentService.from_dir(doc_dir)).run(snapshot_every=50)
        assert expect["final_text"] == live_text, name
        device_text = replay_through_applier(doc_dir, device=device)
        assert device_text == live_text, f"{name}: device replay diverged"
        with open(os.path.join(doc_dir, "expect.json"), "w") as f:
            json.dump(expect, f, indent=1, sort_keys=True)
        print(f"recorded {name}: {expect['last_seq']} ops, "
              f"{len(expect['snapshots'])} fingerprints")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="record replay corpus")
    p.add_argument("--out", required=True,
                   help="directory to record into (no default)")
    p.add_argument("--device", default=None,
                   help="the farm's device for the replay check "
                        "(default cuda)")
    args = p.parse_args(argv)
    record_all(args.out, device=args.device)


if __name__ == "__main__":
    main()
