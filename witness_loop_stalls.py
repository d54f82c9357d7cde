"""Slow event-loop callbacks in the lease witness's processes.

    python3 witness_loop_stalls.py [--order jax,port,port,jax] [--device cpu]

Runs ``sharded_lease_witness.py`` as it is, with asyncio's debug mode on
in every process it starts (``PYTHONASYNCIODEBUG=1``: an event loop logs
each callback that holds it for more than 100 ms), and keeps each run's
merged stderr before the witness removes it. Every slow callback is
listed with the process kind whose code it names (``core`` for
``service/front_end.py``, ``gateway``, ``load`` for the load workers,
``stage``, else ``other``), the package, the callback and its seconds.

Prints one JSON line a run (the witness's row, then ``stalls``: the
callbacks, longest first, and their count and sum by kind), then the
card's name and power limit. The full lists go to
``build/witness/loop_stalls.json``. Exits nonzero when the witness
does (a run failed or a lease was taken over).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
from types import SimpleNamespace

os.environ["PYTHONASYNCIODEBUG"] = "1"

import sharded_lease_witness as witness  # noqa: E402

SLOW = re.compile(r"Executing (.*) took (\d+(?:\.\d+)?) seconds")
KINDS = (("service/front_end.py", "core"), ("service/gateway.py", "gateway"),
         ("service/load_async.py", "load"),
         ("service/stage_runner.py", "stage"))


def classify(callback: str) -> tuple:
    """(process kind, package) that a slow callback's repr names."""
    kind = next((k for path, k in KINDS if path in callback), "other")
    package = ("port" if "fluidframework_tpu_torch/" in callback else
               "jax" if "fluidframework_tpu/" in callback else "")
    return kind, package


def stalls(err_path: str) -> list:
    """Every slow-callback line of one run's stderr, longest first."""
    out = []
    with open(err_path, errors="replace") as f:
        for line in f:
            m = SLOW.search(line)
            if m:
                kind, package = classify(m.group(1))
                out.append({"kind": kind, "package": package,
                            "seconds": float(m.group(2)),
                            "callback": m.group(1)[:300]})
    return sorted(out, key=lambda s: -s["seconds"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="jax,port,port,jax")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    kept: dict = {}

    def rmtree(path, ignore_errors=False):
        err = os.path.join(path, "stderr.txt")
        if os.path.exists(err):
            kept[path] = stalls(err)
        shutil.rmtree(path, ignore_errors=ignore_errors)

    witness.shutil = SimpleNamespace(rmtree=rmtree,
                                     copyfileobj=shutil.copyfileobj)
    emitted = []
    emit = witness.smoke.emit

    def emit_with_stalls(row: dict) -> None:
        run = os.path.join(witness.smoke.HERE, "build", "witness",
                           f"run{len(emitted)}")
        err = os.path.join(run, "stderr.txt")
        found = kept.pop(run, None)
        if found is None and os.path.exists(err):  # a failed run, kept
            found = stalls(err)
        found = found or []
        by_kind: dict = {}
        for s in found:
            key = f"{s['kind']}/{s['package'] or '-'}"
            agg = by_kind.setdefault(key, {"count": 0, "seconds": 0.0})
            agg["count"] += 1
            agg["seconds"] += s["seconds"]
        row = {**row, "stalls": {"by_kind": by_kind, "top": found[:25]}}
        emitted.append({**row, "stalls_all": found})
        emit(row)

    witness.smoke.emit = emit_with_stalls
    sys.argv = [sys.argv[0], "--order", args.order, "--device", args.device]
    try:
        witness.main()
    finally:
        out_dir = os.path.join(witness.smoke.HERE, "build", "witness")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "loop_stalls.json"), "w") as f:
            json.dump(emitted, f, indent=1)


if __name__ == "__main__":
    main()
