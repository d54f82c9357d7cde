"""Socket clients on an open-loop schedule against the deployed service.

The general driver of every traffic file with ``"driver": "net_open_loop"``:
the composition that ``chip_smoke.py::phase_network`` runs, as processes
of the program over loopback.

- set-up: the card's replica farm in an ``ApplierStage`` built in this
  process with the configuration's geometry (so the card's memory, its
  trace and the stage's spans are the harness's), tailing the durable log
  of one core process (``front_end --port 0 --log-dir L
  --consume-backchannel S``), and ``workers`` load processes
  (``portbench/yardstick/sockets.py``), each holding its share of the
  ``docs × clients_per_doc`` sockets behind a start gate, then the
  stage's loop runs for the configuration's ``settle_s`` while the
  deployment settles after the connect storm (the core checkpoints every
  doc the joins dirtied, every 2 s, and sweeps the storm's garbage; the
  stage consumes the joins). Before them a
  throwaway core and stage of the same geometry serve a few docs from the
  same load processes, so that every shape the window uses is warm. The
  core's span recorder is switched on and off once over its admin door
  (``admin_spans``): a core without it fails the set-up.
- the window: every client submits its boxcars on the traffic's schedule
  while this process runs the stage's loop (``run_forever``). After the
  last boxcar is acked the stage drains to every doc's last acked seq
  (``drain_to``), inside the window. Each boxcar's ack is timed from its
  due instant. A traced run records the core's spans over the window.
- the check: every op acked once and in its client's order, each doc's
  sequence numbers contiguous, every acked op applied by the farm once;
  then the core is killed (SIGKILL) and a fresh core started on the same
  log reads every doc's deltas back (``get_deltas``): every acked op must
  be there as it was sent, and a seeded sample of docs (the longest among
  them) read back from the card must equal the plain reference replaying
  the read-back deltas.

Every child runs in a process group of its own and dies with this
process; any failure kills them all and raises, so a run never hangs.
"""

from __future__ import annotations

import json
import os
import queue
import resource
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from portbench.yardstick.driving import (
    compare_docs,
    farm_texts,
    sample_docs,
    seed_rng,
)
from portbench.yardstick.sockets import ops_digest
from portbench.yardstick.streams import reference_ops

ROOT = Path(__file__).resolve().parents[2]
#: the core's module (``python -m``)
CORE = "fluidframework_tpu_torch.service.front_end"
#: a child's first act: die with this process (PR_SET_PDEATHSIG, SIGKILL),
#: then run its module with the rest of its arguments
PRELUDE = ("import ctypes, runpy, sys; ctypes.CDLL(None).prctl(1, 9); "
           "m = sys.argv[1]; sys.argv = sys.argv[1:]; "
           "runpy.run_module(m, run_name='__main__', alter_sys=True)")
CHILD_TIMEOUT_S = 120.0
START_MARGIN_S = 1.0
ACK_TIMEOUT_S = 30.0
DRAIN_TIMEOUT_S = 60.0


def _pythonpath() -> str:
    """Where this process found the benchmark and the program, for the
    children."""
    import fluidframework_tpu_torch
    import portbench

    paths = [str(Path(portbench.__file__).resolve().parents[1]),
             str(Path(fluidframework_tpu_torch.__file__).resolve()
                 .parents[1])]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    return os.pathsep.join(dict.fromkeys(paths))


def raise_fd_limit(need: int) -> int:
    """Raise this process's soft ``RLIMIT_NOFILE`` (children inherit it)
    to at least ``need``; fails, naming the limit, where the hard limit
    is lower."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and hard < need:
        raise RuntimeError(
            f"RLIMIT_NOFILE: the hard limit {hard} is below the {need} "
            "descriptors the cell's sockets need")
    if soft != resource.RLIM_INFINITY and soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))
    return need


def mount_of(path: str) -> str:
    """``<fstype> <mount point>`` of the filesystem holding ``path``,
    from ``/proc/mounts``."""
    path = os.path.realpath(path)
    best = ("", "not read")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                point = parts[1].replace("\\040", " ")
                if (path == point or path.startswith(point.rstrip("/") + "/")
                        or point == "/") and len(point) > len(best[0]):
                    best = (point, parts[2])
    except OSError:
        pass
    return f"{best[1]} {best[0]}"


def cpu_seconds(pid: int) -> float:
    """User plus system CPU seconds a process has used so far."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class Children:
    """The run's child processes, each the leader of its own process
    group; ``kill`` ends them all."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.procs: list = []
        self.env = dict(os.environ, PYTHONPATH=_pythonpath())

    def spawn(self, module: str, *args: str) -> subprocess.Popen:
        proc = subprocess.Popen(
            [sys.executable, "-c", PRELUDE, module, *args],
            cwd=self.run_dir, env=self.env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=open(os.path.join(self.run_dir, "stderr.txt"), "a"),
            text=True, start_new_session=True)
        self.procs.append(proc)
        return proc

    def kill(self, proc=None) -> None:
        for p in [proc] if proc is not None else list(self.procs):
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    p.kill()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            for stream in (p.stdin, p.stdout):
                try:
                    stream.close()
                except (OSError, AttributeError):
                    pass
            if p in self.procs:
                self.procs.remove(p)


class Lines:
    """A child's standard output, a line at a time, with a deadline."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.q: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.q.put(line)
        self.q.put(None)

    def get(self, timeout: float, what: str) -> str:
        try:
            line = self.q.get(timeout=timeout)
        except queue.Empty:
            raise RuntimeError(f"{what}: nothing in {timeout:.0f} s") from None
        if line is None:
            raise RuntimeError(f"{what}: the process ended (rc "
                               f"{self.proc.wait()})")
        return line.strip()

    def ready(self) -> bool:
        return not self.q.empty()


class Rpc:
    """Request and reply frames (4-byte length, JSON) on one socket to a
    core."""

    def __init__(self, port: int, timeout: float = 60.0):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        self.file = self.sock.makefile("rb")
        self.rid = 0

    def send(self, frame: dict) -> int:
        self.rid += 1
        body = json.dumps(dict(frame, rid=self.rid)).encode()
        self.sock.sendall(len(body).to_bytes(4, "big") + body)
        return self.rid

    def reply(self) -> dict:
        """The next JSON frame that answers a request."""
        while True:
            header = self.file.read(4)
            if len(header) < 4:
                raise ConnectionError("the core closed the connection")
            body = self.file.read(int.from_bytes(header, "big"))
            if body[:1] == b"\x01":
                continue  # a binary push
            frame = json.loads(body)
            if frame.get("t") == "error":
                raise RuntimeError(f"the core refused a request: "
                                   f"{frame.get('message')}")
            if "rid" in frame:
                return frame

    def request(self, frame: dict) -> dict:
        self.send(frame)
        return self.reply()

    def close(self) -> None:
        self.sock.close()


def read_back(port: int, tenant: str, docs: list) -> dict:
    """Every doc's sequenced deltas, read through a core's ``get_deltas``
    (all of them, seq 1 on), as the program's message objects."""
    from fluidframework_tpu_torch.protocol.serialization import (
        message_from_dict,
    )

    rpc = Rpc(port)
    try:
        rids = {rpc.send({"t": "get_deltas", "tenant": tenant, "doc": d,
                          "from": 0, "to": 1 << 31}): d for d in docs}
        out = {}
        while len(out) < len(rids):
            frame = rpc.reply()
            out[rids[frame["rid"]]] = [message_from_dict(m)
                                       for m in frame["msgs"]]
        return out
    finally:
        rpc.close()


class Core:
    """One core process and the port it listens on."""

    def __init__(self, children: Children, log_dir: str,
                 state_dir: str = None):
        args = ["--port", "0", "--log-dir", log_dir]
        if state_dir is not None:
            args += ["--consume-backchannel", state_dir]
        self.children = children
        self.proc = children.spawn(CORE, *args)
        line = Lines(self.proc).get(CHILD_TIMEOUT_S, "the core")
        if not line.startswith("LISTENING"):
            raise RuntimeError(f"the core said {line!r}, not LISTENING")
        self.port = int(line.rsplit(":", 1)[1])

    def spans(self, on: bool):
        """Switch the core's span recorder (``admin_spans``); off answers
        its totals."""
        rpc = Rpc(self.port)
        try:
            return rpc.request({"t": "admin_spans", "on": on})["spans"]
        finally:
            rpc.close()

    def kill(self) -> None:
        self.children.kill(self.proc)


class Deployment:
    """A core, the stage on the farm, and the load processes' share of
    one doc set."""

    def __init__(self, cfg: dict, directory: str, children: Children,
                 device: str, workers: list):
        from fluidframework_tpu_torch.service.stage_runner import (
            ApplierStage,
        )

        self.cfg = cfg
        self.log_dir = os.path.join(directory, "log")
        self.state_dir = os.path.join(directory, "state")
        os.makedirs(directory)
        self.stage = ApplierStage(self.log_dir, self.state_dir,
                                  device=device, **cfg["applier"])
        self.core = Core(children, self.log_dir, self.state_dir)
        self.core.spans(True)
        self.core.spans(False)
        self.workers = workers

    def connect(self, docs: list, mix: dict, seed: int) -> None:
        """Every load process connects its share of the clients of
        ``docs``; each client submits a boxcar a period, the period that
        makes ``mix["rate"]`` ops a second over all the cell's clients."""
        cfg = self.cfg
        clients = cfg["docs"] * cfg["clients_per_doc"]
        for w, (proc, lines) in enumerate(self.workers):
            proc.stdin.write(json.dumps({
                "host": "127.0.0.1", "port": self.core.port,
                "tenant": cfg["tenant"], "docs": docs[w::len(self.workers)],
                "clients_per_doc": cfg["clients_per_doc"],
                "boxcar": mix["boxcar"],
                "remove_fraction": mix["remove_fraction"],
                "annotate_fraction": mix["annotate_fraction"],
                "max_insert": mix["max_insert"],
                "period_s": clients * mix["boxcar"] / mix["rate"],
                "seed": seed * 64 + w,
                "ack_timeout_s": ACK_TIMEOUT_S}) + "\n")
            proc.stdin.flush()
        for w, (proc, lines) in enumerate(self.workers):
            said = json.loads(lines.get(CHILD_TIMEOUT_S,
                                        f"load process {w} connecting"))
            if not said.get("connected"):
                raise RuntimeError(f"load process {w} said {said}")

    def start(self, start_at: float, seconds: float) -> None:
        for proc, _ in self.workers:
            proc.stdin.write(json.dumps({"start_at": start_at,
                                         "seconds": seconds}) + "\n")
            proc.stdin.flush()

    def run(self, deadline: float) -> list:
        """Run the stage's loop until every load process has answered;
        their results."""
        workers = self.workers

        def done() -> bool:
            if time.perf_counter() > deadline:
                return True
            return all(lines.ready() or proc.poll() is not None
                       for proc, lines in workers)

        self.stage.run_forever(until=done)
        return [json.loads(lines.get(1.0, f"load process {w}'s result"))
                for w, (proc, lines) in enumerate(workers)]

    def drain(self, results: list) -> None:
        seqs = {}
        for r in results:
            for doc, seq in r["docs"].items():
                seqs[(self.cfg["tenant"], doc)] = seq
        self.stage.drain_to(seqs, timeout=DRAIN_TIMEOUT_S)

    def close(self) -> None:
        self.core.kill()
        stage = self.stage
        stage.applier.close()
        stage.shared.close()
        stage.state.close()


class Driver:
    """``net_open_loop``: see the module docstring."""

    NESTED = {}

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 tracing: bool, control: str = None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device, self.tracing = device, tracing
        self.samples: dict = {}
        self.notes: dict = {}
        self.core_spans = None
        base = ROOT / "build" / "portbench" / "net"
        base.mkdir(parents=True, exist_ok=True)
        self.run_dir = tempfile.mkdtemp(dir=base)
        self.children = Children(self.run_dir)
        try:
            self._setup(control)
        except BaseException:
            self.close()
            raise

    def _setup(self, control: str) -> None:
        cfg, mix, seed = self.cfg, self.mix, self.seed
        t = time.perf_counter()
        clients = cfg["docs"] * cfg["clients_per_doc"]
        raise_fd_limit(clients + 1024)
        self.notes["log_filesystem"] = mount_of(self.run_dir)
        self.workers = []
        for _ in range(mix["workers"]):
            proc = self.children.spawn("portbench.yardstick.sockets",
                                       self.run_dir)
            self.workers.append((proc, Lines(proc)))
        # the warm-up: a throwaway core and farm, a few docs a worker
        warm_docs = [f"warm{i}" for i in range(cfg["warmup_docs"])]
        warm = Deployment(cfg, os.path.join(self.run_dir, "warm"),
                          self.children, self.device, self.workers)
        warm.connect(warm_docs, mix, seed ^ 0x5EED)
        warm.start(time.time() + 0.2, cfg["warmup_seconds"])
        results = warm.run(time.perf_counter() + cfg["warmup_seconds"]
                           + ACK_TIMEOUT_S + 5)
        if any(r["acked"] != r["submitted"] or r["errors"]
               for r in results):
            raise RuntimeError("the warm-up lost acks: " + str([
                (r["acked"], r["submitted"], r["errors"]) for r in results]))
        warm.drain(results)
        warm.close()
        del warm
        self.notes["setup_warmup_s"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        self.dep = dep = Deployment(cfg, os.path.join(self.run_dir, "run"),
                                    self.children, self.device,
                                    self.workers)
        if control is not None:
            ingest = dep.stage.applier.ingest_array_batch
            every = cfg["check"]["control_every"]
            calls = [0]

            def twice(tenant, doc, batch):
                ingest(tenant, doc, batch)
                calls[0] += 1
                if calls[0] % every == 0:
                    ingest(tenant, doc, batch)
            dep.stage.applier.ingest_array_batch = twice
        self.docs = [f"doc{i}" for i in range(cfg["docs"])]
        self.notes["setup_core_s"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        dep.connect(self.docs, mix, seed)
        self.notes["setup_connect_s"] = round(time.perf_counter() - t, 3)
        settled = time.perf_counter() + cfg["settle_s"]
        dep.stage.run_forever(until=lambda: time.perf_counter() >= settled)

    def window(self, seconds: float) -> None:
        dep = self.dep
        if self.tracing:
            dep.core.spans(True)
        start_at = time.time() + START_MARGIN_S
        self.w0 = time.perf_counter() + (start_at - time.time())
        cpu0 = cpu_seconds(dep.core.proc.pid)
        dep.start(start_at, seconds)
        self.results = results = dep.run(self.w0 + seconds + ACK_TIMEOUT_S
                                         + 5)
        t_acked = time.perf_counter()
        saves = []
        checkpoint = dep.stage.checkpoint

        def timed_checkpoint():
            t = time.perf_counter()
            checkpoint()
            saves.append(time.perf_counter() - t)
        dep.stage.checkpoint = timed_checkpoint
        dep.drain(results)
        self.w1 = time.perf_counter()
        dep.stage.checkpoint = checkpoint
        self.notes["stage_final_checkpoint_s"] = round(sum(saves), 3)
        self.core_cpu_s = cpu_seconds(dep.core.proc.pid) - cpu0
        self.window_s = self.w1 - self.w0
        if self.tracing:
            self.core_spans = dep.core.spans(False)
        self.drain_s = self.w1 - (self.w0 + seconds)
        self.samples["ack_ms"] = acks = [x for r in results
                                         for x in r["ack_ms"]]
        if acks:
            ranked = sorted(acks)
            self.notes["ack_ms_p50_p90_p99_max"] = [
                round(ranked[int(q * (len(ranked) - 1))], 3)
                for q in (0.5, 0.9, 0.99, 1.0)]
            # acks over 50 ms by the second of the schedule they were due
            slow = [0] * (int(seconds) + 1)
            for r in results:
                for due, ms in zip(r["ack_due_s"], r["ack_ms"]):
                    if ms > 50 and 0 <= due < len(slow):
                        slow[int(due)] += 1
            self.notes["slow_acks_by_second"] = slow
        late = sorted(x for r in results for x in r["late_ms"])
        self.notes["generator_late_p95_ms"] = (
            round(late[int(0.95 * (len(late) - 1))], 3) if late else None)
        last = [r["last_ack_at"] for r in results if r["last_ack_at"]]
        if last:
            self.notes["ack_tail_s"] = round(
                max(last) - (start_at + seconds), 3)
        self.notes["drain_s"] = round(self.drain_s, 3)
        self.notes["stage_drain_s"] = round(self.w1 - t_acked, 3)
        self.notes["loop_exit_s"] = round(t_acked - (self.w0 + seconds), 3)
        submitted = sum(r["submitted"] for r in results)
        self.notes["offered_ops_per_s"] = round(submitted / seconds, 1)
        self.notes["acked_in_time_share"] = round(
            sum(r["acked_in_time"] for r in results) / max(1, submitted), 4)

    def counts(self) -> dict:
        app = self.dep.stage.applier
        acked = sum(r["acked"] for r in self.results)
        return {
            "acked_ops": min(acked, app.ops_applied),
            "submitted_ops": sum(r["submitted"] for r in self.results),
            "ops_applied": app.ops_applied,
            "host_escalations": app.host_escalations,
            "drain_s": self.drain_s,
            "core_cpu_s": self.core_cpu_s,
            "core_spans": self.core_spans,
        }

    def span_arrays(self) -> dict:
        return {}

    def check(self) -> dict:
        try:
            return self._check()
        finally:
            self.close()

    def _check(self) -> dict:
        cfg, dep, results = self.cfg, self.dep, self.results
        tenant = cfg["tenant"]
        app = dep.stage.applier
        submitted = sum(r["submitted"] for r in results)
        acked = sum(r["acked"] for r in results)
        self.attempted = submitted
        self.failed = max(0, submitted - acked)
        errors = [e for r in results for e in r["errors"]]
        if errors:
            self.notes["client_errors"] = errors[:4]
        # the core dies and a fresh one reads the log back
        dep.core.kill()
        t = time.perf_counter()
        fresh = Core(self.children, dep.log_dir)
        logs = read_back(fresh.port, tenant, self.docs)
        fresh.kill()
        self.notes["read_back_s"] = round(time.perf_counter() - t, 3)
        gaps = 0
        sizes = {}
        by_seq = {}
        for doc, msgs in logs.items():
            seqs = [m.sequence_number for m in msgs]
            gaps += sum(1 for a, b in zip(seqs, seqs[1:]) if b != a + 1)
            if seqs and seqs[0] != 1:
                gaps += 1
            ops = reference_ops([msgs])
            sizes[doc] = len(ops)
            by_seq[doc] = {op[5]: op for op in ops}
        lost = 0
        for r in results:
            for doc, client, last, n, digest in r["boxcars"]:
                have = by_seq.get(doc, {})
                ops = [have.get(s) for s in range(last - n + 1, last + 1)]
                if (None in ops or any(op[7] != client for op in ops)
                        or ops_digest([op[:5] for op in ops]) != digest):
                    lost += n
        sample = sample_docs(sizes, cfg["check"]["sample_docs"],
                             seed_rng(self.seed, 1))
        texts = farm_texts(app, tenant, sample)
        escalated = app.host_escalations
        app_ops = app.ops_applied
        unapplied = acked - app_ops if not escalated else 0
        streams = {d: reference_ops([logs[d]]) for d in sample}
        t = time.perf_counter()
        differing, first = compare_docs(texts, streams)
        self.notes["reference_s"] = round(time.perf_counter() - t, 3)
        self.notes["ack_samples"] = len(self.samples["ack_ms"])
        self.notes["docs_compared"] = (
            f"{len(sample)} of {len(sizes)} (largest "
            f"{max(sizes.values(), default=0)} ops)")
        self.notes["slots_max"] = (
            f"{max(app.slot_count(tenant, d) for d in self.docs)} of "
            f"{cfg['applier']['max_slots']}")
        if first:
            self.notes["first_difference"] = first
        if escalated:
            self.notes["unapplied_ops"] = ("not counted: escalated docs "
                                           "leave the farm's op count")
        return {
            "ack_count_error": {"value": abs(submitted - acked), "limit": 0},
            "client_order_errors": {
                "value": sum(r["order_errors"] for r in results)
                + sum(r["nacked"] for r in results) + len(errors),
                "limit": 0},
            "seq_gaps": {"value": gaps, "limit": 0},
            "unapplied_ops": {"value": abs(unapplied), "limit": 0},
            "over_applied_ops": {"value": max(0, app_ops - acked),
                                 "limit": 0},
            "lost_after_restart": {"value": lost, "limit": 0},
            "docs_differing": {"value": differing, "limit": 0},
        }

    def close(self) -> None:
        """End every child and remove the run's directory, keeping the
        children's standard error as ``last_stderr.txt`` beside it."""
        self.children.kill()
        try:
            shutil.copy(os.path.join(self.run_dir, "stderr.txt"),
                        os.path.join(os.path.dirname(self.run_dir),
                                     "last_stderr.txt"))
        except OSError:
            pass
        dep = getattr(self, "dep", None)
        if dep is not None:
            try:
                dep.close()
            except Exception:
                pass
        shutil.rmtree(self.run_dir, ignore_errors=True)
