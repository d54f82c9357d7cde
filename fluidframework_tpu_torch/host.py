"""Dev host: run any example app against a chosen service topology.

JAX counterpart: ``fluidframework_tpu/host.py``; the port's copy. Its
topologies spawn the port's ``service.front_end``, ``service.gateway``,
``service.storage_server`` and ``service.stage_runner``, and its apps are
the port's own, ``fluidframework_tpu_torch/examples/<name>`` (copies of
the repo's ``examples/``, which run on the JAX package).

Ref: packages/tools/webpack-fluid-loader — the reference's ``fluid
start`` serves a data object against local / tinylicious / r11s targets
through one resolver seam (multiResolver.ts:75). Here the same role for
the process world: the host owns the SERVICE topology, the app module
only knows how to drive clients against a port (its ``run_clients``),
so every app runs unchanged against every deployment shape:

    python -m fluidframework_tpu_torch.host todo              # single core
    python -m fluidframework_tpu_torch.host canvas -t gateway  # via gateways
    python -m fluidframework_tpu_torch.host clicker -t split   # staged core
    python -m fluidframework_tpu_torch.host shared_text -t sharded  # 2-core

Apps are ``fluidframework_tpu_torch.examples.<name>`` modules exposing
``run_clients(port) -> int`` — all seven (shared_text, clicker,
table_doc, todo, canvas, sudoku, album) support every topology. An app
without ``run_clients`` (a third-party module that embeds its own
server) still runs via its ``run_demo()``, but only under ``-t
single`` — the host refuses to spawn a topology such an app would
silently ignore.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import shutil
import subprocess
import sys
import tempfile


def _spawn(args: list, ready: str = "LISTENING"):
    proc = subprocess.Popen(
        [sys.executable, "-m"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith(ready), f"{args[0]}: {line!r}"
    port = int(line.rsplit(":", 1)[1]) if ":" in line else 0
    return proc, port


@contextlib.contextmanager
def topology(kind: str):
    """Yield a client-facing port for the requested deployment shape."""
    procs = []
    tmp = tempfile.mkdtemp(prefix="fluid-host-")
    try:
        if kind == "single":
            core, port = _spawn(
                ["fluidframework_tpu_torch.service.front_end", "--port", "0"])
            procs.append(core)
        elif kind == "gateway":
            core, cport = _spawn(
                ["fluidframework_tpu_torch.service.front_end", "--port", "0"])
            procs.append(core)
            gw, port = _spawn(["fluidframework_tpu_torch.service.gateway",
                               "--core-port", str(cport)])
            procs.append(gw)
        elif kind == "split":
            # durable core + external scribe stage + storage process
            store, sport = _spawn(
                ["fluidframework_tpu_torch.service.storage_server",
                 "--dir", f"{tmp}/store"])
            procs.append(store)
            scribe, _ = _spawn(
                ["fluidframework_tpu_torch.service.stage_runner", "--stage",
                 "scribe", "--log-dir", f"{tmp}/log",
                 "--state-dir", f"{tmp}/scribe"], ready="READY")
            procs.append(scribe)
            core, port = _spawn(
                ["fluidframework_tpu_torch.service.front_end", "--port", "0",
                 "--log-dir", f"{tmp}/log",
                 "--storage-server", str(sport), "--external-scribe",
                 "--consume-backchannel", f"{tmp}/scribe"])
            procs.append(core)
        elif kind == "sharded":
            for prefer in ("0", "1"):
                core, _ = _spawn(
                    ["fluidframework_tpu_torch.service.front_end", "--port",
                     "0", "--shard-dir", f"{tmp}/deploy", "--shards",
                     "2", "--prefer", prefer])
                procs.append(core)
            gw, port = _spawn(["fluidframework_tpu_torch.service.gateway",
                               "--shard-dir", f"{tmp}/deploy",
                               "--shards", "2"])
            procs.append(gw)
        else:
            raise ValueError(f"unknown topology {kind!r}")
        yield port
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    p = argparse.ArgumentParser(
        description="run an example app on a service topology")
    p.add_argument("app", help="fluidframework_tpu_torch.examples.<app> "
                               "module name (e.g. todo)")
    p.add_argument("-t", "--topology", default="single",
                   choices=("single", "gateway", "split", "sharded"))
    args = p.parse_args()
    mod = importlib.import_module(
        f"fluidframework_tpu_torch.examples.{args.app}")
    run_clients = getattr(mod, "run_clients", None)
    if run_clients is None:
        # legacy examples embed their own server — running run_demo()
        # under a spawned topology would silently IGNORE -t (the demo
        # talks to its own single core, not the processes we started)
        if args.topology != "single":
            p.error(f"{mod.__name__} has no run_clients(port); it "
                    f"only supports -t single (its demo embeds its own "
                    f"server)")
        raise SystemExit(mod.run_demo())
    with topology(args.topology) as port:
        raise SystemExit(run_clients(port))


if __name__ == "__main__":
    main()
