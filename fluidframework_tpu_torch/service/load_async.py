"""Asyncio load worker: thousands of socket clients per process.

JAX counterpart: ``fluidframework_tpu/service/load_async.py``; the port's
copy, imports rebased to this package. Run it as ``python -m
fluidframework_tpu_torch.service.load_async --port P ...``.

Ref: packages/test/service-load-test/src/nodeStressTest.ts — the
reference's orchestrator spawns runner processes, each hosting many
socket.io clients on one Node event loop. The thread-per-connection
driver stack (driver/network.py) is the right shape for a real client
app but caps a load WORKER at a few hundred connections; this worker
hosts each client as an asyncio task on one loop, which is what makes
the BASELINE config-4 geometry (1k docs × 10 clients = 10k sockets)
drivable from a handful of processes.

Clients speak the production wire protocol (front_end.py): JSON connect
handshake, binwire submit boxcars, binwire ops broadcasts. Each client
submits ``rounds`` boxcars of ``batch`` ops paced at ``rate_hz`` rounds
per second (absolute schedule, so pacing error does not accumulate), and
samples op-ack latency once per boxcar (submit → own last-op broadcast).

One JSON result line on stdout, same shape as load_gen's thread worker:
``{"ops", "acked", "seconds", "lat_ms", "hops"}``, with the wall-clock
epochs ``started_at`` (first submit) and ``ended_at`` (last ack) so an
orchestrator can time all workers over one window. ``--start-gate`` is a
barrier: the worker prints ``CONNECTED`` once every client has joined and
reads its start instant from stdin (the JAX worker's ``--start-at``,
a fixed instant that slow connects can overrun, is replaced by it).
"""

from __future__ import annotations

import asyncio
import json
import random
import socket as _socket
import time
from collections import defaultdict
from typing import Awaitable, Callable, Optional

from ..protocol import binwire
from ..protocol.messages import DocumentMessage, MessageType, TraceHop
from ..utils.telemetry import HOP_ACK, HOP_SUBMIT, hop_pairs
from .synthetic import SyntheticEditor


def _op_from_fields(d: dict) -> DocumentMessage:
    """Rebuild a DocumentMessage from the nack's echoed op fields (the
    wire dict has no _kind discriminator; traces are dropped — a
    resubmitted boxcar re-arms tracing itself if sampled)."""
    return DocumentMessage(
        client_sequence_number=d["client_sequence_number"],
        reference_sequence_number=d["reference_sequence_number"],
        type=MessageType(d["type"]),
        contents=d.get("contents"),
        metadata=d.get("metadata"))


class _AsyncClient:
    """One synthetic client: connection + editor + pacing schedule."""

    def __init__(self, host: str, port: int, tenant: str, doc: str,
                 rng: random.Random, batch: int, rounds: int,
                 trace_sample_n: int = 0):
        self.host, self.port = host, port
        self.tenant, self.doc = tenant, doc
        self.editor = SyntheticEditor(rng)
        self.batch = batch
        self.rounds = rounds
        #: 1-in-N columnar boxcar tracing (0 = disarmed): sampled frames
        #: carry the hoptail, and _observe folds it into the full
        #: per-tier breakdown instead of the two-leg deli split
        self.trace_sample_n = trace_sample_n
        # random phase spreads the fleet across the round period —
        # without it every client submits at the same instant and the
        # measurement becomes burst queueing, not steady-state load
        self.phase = rng.random()
        self.client_id: Optional[str] = None
        # boxcar-last cseq → (perf t0, wall t0)
        self.pending: dict[int, tuple] = {}
        self.lat_ms: list[float] = []
        self.acked = 0
        self.submitted = 0
        self.nacked = 0
        # admission-shed retry state: shed nacks echo the op back with
        # retry_after_ms; held here (keyed by cseq so resubmission can
        # restore clientSeq order) until the jittered deadline
        self.shed = 0
        self._rng = rng
        self._shed_ops: dict[int, dict] = {}
        self._resubmit_at: Optional[float] = None
        # per-hop splits: the two-leg deli split from the record's deli
        # stamp, or the full hoptail breakdown on sampled cols frames
        self.hops: dict[str, list] = defaultdict(list)
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.error: Optional[str] = None

    async def connect(self) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            self.host, self.port)
        sock = self.writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        body = json.dumps({"t": "connect", "tenant": self.tenant,
                           "doc": self.doc, "bin": 1, "rid": 1},
                          separators=(",", ":")).encode()
        self.writer.write(len(body).to_bytes(4, "big") + body)
        await self.writer.drain()
        # the connected reply may be preceded by pushed frames
        while self.client_id is None:
            frame = await self._read()
            if frame is None:
                raise ConnectionError("closed during handshake")

    async def _read(self):
        """Read one frame; dispatch pushes; return JSON reply dicts."""
        header = await self.reader.readexactly(4)
        body = await self.reader.readexactly(int.from_bytes(header, "big"))
        if binwire.is_binary(body):
            self._observe(body)
            return {}
        frame = json.loads(body.decode())
        if frame.get("t") == "connected":
            self.client_id = frame["clientId"]
        elif frame.get("t") == "nack":
            self._on_nack(frame.get("nack") or {})
        elif frame.get("t") == "error":
            raise RuntimeError(frame.get("message"))
        return frame

    def _on_nack(self, d: dict) -> None:
        retry_ms = d.get("retry_after_ms")
        op = d.get("operation")
        if not retry_ms or op is None:
            self.nacked += 1
            return
        # shed: honor the server's backoff with jitter, then resubmit.
        # The pending t0 stays untouched — the sampled latency includes
        # the backoff, which is exactly what an overloaded user feels.
        self.shed += 1
        self._shed_ops[op["client_sequence_number"]] = op
        self._resubmit_at = max(
            self._resubmit_at or 0.0,
            time.perf_counter()
            + (retry_ms / 1000.0) * (1.0 + 0.5 * self._rng.random()))

    async def shed_flush_loop(self) -> None:
        """Resubmit shed ops (cseq order) once their deadline passes;
        a re-shed just lands them back here with a fresh deadline."""
        try:
            while True:
                await asyncio.sleep(0.02)
                if not self._shed_ops:
                    continue
                at = self._resubmit_at
                if at is not None and time.perf_counter() < at:
                    continue
                items = sorted(self._shed_ops.items())
                self._shed_ops = {}
                self._resubmit_at = None
                ops = [_op_from_fields(d) for _, d in items]
                body = binwire.encode_submit_columns(ops)
                if body is None:
                    body = binwire.encode_submit(ops)
                self.writer.write(binwire.frame(body))
                await self.writer.drain()
        except (asyncio.CancelledError, ConnectionResetError, OSError):
            pass

    def _observe(self, body: bytes) -> None:
        """Track a broadcast via the lazy scan — no message objects.

        The editor only needs its visible-length lower bound and the
        latest ref seq; full decode of every subscriber's copy was the
        workers' largest CPU item at the knee."""
        me = self.client_id
        ed = self.editor
        # a sampled cols frame carries the accumulated hoptail at its
        # end (one boxcar = one submitting client, so the hops are ours
        # exactly when a record below matches our pending cseq)
        frame_hops = (binwire.read_hoptail(body)
                      if len(body) >= 2
                      and body[1] == binwire.FT_COLS_OPS else [])
        for cid, seq, cseq, deli_ts, delta in binwire.scan_ops(body):
            ed.ref_seq = seq
            if cid is None or me is None:
                continue
            if cid == me:
                self.acked += 1
                t0 = self.pending.pop(cseq, None)
                if t0 is not None:
                    now = time.perf_counter()
                    self.lat_ms.append((now - t0[0]) * 1e3)
                    wall = time.time()
                    if frame_hops:
                        # full breakdown: local submit/ack close the
                        # chain; the frame's own submit stamp (later in
                        # the list) wins over the local t0 fallback
                        for name, ms in hop_pairs(
                                [(HOP_SUBMIT, t0[1])] + list(frame_hops)
                                + [(HOP_ACK, wall)]):
                            self.hops[name].append(ms)
                    elif deli_ts is not None:
                        self.hops["submit_to_deli"].append(
                            (deli_ts - t0[1]) * 1e3)
                        self.hops["deli_to_ack"].append(
                            (wall - deli_ts) * 1e3)
            elif delta > 0:
                ed.length += delta
            elif delta < 0:
                ed.length = max(0, ed.length + delta)

    async def read_loop(self) -> None:
        try:
            while True:
                await self._read()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.CancelledError):
            pass
        except Exception as e:  # server error frame etc. — a silently
            # dead reader would surface only as a missing-acks timeout
            # with the actual cause lost (stderr is discarded)
            self.error = f"{type(e).__name__}: {e}"

    async def run_rounds(self, t0: float, rate_hz: float) -> None:
        for i in range(self.rounds):
            target = t0 + (i + self.phase) / rate_hz
            delay = target - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            ops = self.editor.next_ops(self.batch)
            # latency is timed per boxcar on its last op. Columnar
            # frames carry no traces — the deli stamp timestamp in the
            # sequenced frame IS the deli time for every record
            # (scan_ops yields it), so the hop split needs no per-op
            # trace. The rec-frame fallback keeps the client trace
            # stamp: deli's SAMPLED tracing only stamps pre-traced ops
            # (deli.py fast lane), and the stamp is what brings the
            # deli timestamp back for the hop split (submit→deli,
            # deli→ack) computed locally on ack
            body = binwire.encode_submit_columns(ops)
            if body is None:
                ops[-1].traces.append(TraceHop(
                    service="client", action="submit",
                    timestamp=time.time()))
                body = binwire.encode_submit(ops)
            elif self.trace_sample_n \
                    and i % self.trace_sample_n == 0:
                # arm the hoptail on every Nth columnar boxcar: tiers
                # append their hops in place and the ack broadcast
                # brings the chain back for the local breakdown
                body = binwire.append_hop(
                    body, HOP_SUBMIT, time.time())
            self.pending[ops[-1].client_sequence_number] = (
                time.perf_counter(), time.time())
            self.writer.write(binwire.frame(body))
            self.submitted += len(ops)
            await self.writer.drain()

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


async def run_load(host: str, port: int, n_docs: int, clients_per_doc: int,
                   rounds: int, batch: int, rate_hz: float, seed: int,
                   doc_prefix: str, tenant: str = "bench",
                   connect_concurrency: int = 64,
                   timeout: float = 120.0,
                   trace_sample_n: int = 0,
                   start_gate: Optional[Callable[[], Awaitable[float]]]
                   = None) -> dict:
    rng = random.Random(seed)
    clients = [
        _AsyncClient(host, port, tenant, f"{doc_prefix}{d}",
                     random.Random(rng.random()), batch, rounds,
                     trace_sample_n=trace_sample_n)
        for d in range(n_docs) for _ in range(clients_per_doc)
    ]
    # staged connects: a 10k-connection stampede overruns the listen
    # backlog and makes join storms the measurement instead of steady load
    sem = asyncio.Semaphore(connect_concurrency)

    async def staged_connect(c):
        async with sem:
            await c.connect()

    await asyncio.gather(*(staged_connect(c) for c in clients))
    readers = [asyncio.ensure_future(c.read_loop()) for c in clients]
    shed_flushers = [asyncio.ensure_future(c.shed_flush_loop())
                     for c in clients]

    late_s = 0.0
    if start_gate is not None:
        # cross-worker synchronized start: the orchestrator hands every
        # worker the same wall-clock instant, and only once every
        # worker's clients are connected, so no worker's trial runs
        # against another worker's connect storm. A worker that gets
        # the instant late reports by how much: that trial is TAINTED.
        delay = await start_gate() - time.time()
        if delay > 0:
            await asyncio.sleep(delay)
        else:
            late_s = -delay
    started_at = time.time()
    t0 = time.perf_counter()
    await asyncio.gather(*(c.run_rounds(t0, rate_hz) for c in clients))
    expected = sum(c.submitted for c in clients)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if sum(c.acked for c in clients) >= expected:
            break
        await asyncio.sleep(0.01)
    seconds = time.perf_counter() - t0
    ended_at = started_at + seconds

    lat = []
    hops: dict[str, list] = defaultdict(list)
    for c in clients:
        lat.extend(c.lat_ms)
        for name, vals in c.hops.items():
            hops[name].extend(vals)
    hops = dict(hops)
    for r in readers:
        r.cancel()
    for f in shed_flushers:
        f.cancel()
    for c in clients:
        c.close()
    return {
        "ops": expected,
        "acked": sum(c.acked for c in clients),
        "seconds": seconds,
        "lat_ms": lat,
        "hops": hops,
        "shed": sum(c.shed for c in clients),
        "errors": [c.error for c in clients if c.error],
        "late_s": round(late_s, 1),
        "started_at": started_at,
        "ended_at": ended_at,
    }


def main() -> None:
    import argparse
    import gc
    import sys

    p = argparse.ArgumentParser(description="asyncio socket load worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--docs", type=int, default=32)
    p.add_argument("--clients-per-doc", type=int, default=2)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rate", type=float, default=2.0,
                   help="boxcar rounds per second per client")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--doc-prefix", default="netdoc")
    p.add_argument("--tenant", default="bench")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="ack-wait ceiling after the rounds complete")
    p.add_argument("--start-gate", action="store_true",
                   help="print CONNECTED once every client has joined, "
                        "then read the start epoch from stdin")
    p.add_argument("--trace-sample-n", type=int, default=16,
                   help="arm the hoptail on every Nth columnar boxcar "
                        "(0 disables tracing)")
    args = p.parse_args()

    # the worker's op path allocates acyclic graphs only; the cycle
    # collector's periodic scans would show up directly as ack-latency
    # spikes in the measurement (the process is short-lived — leaked
    # cycles die with it)
    gc.collect()
    gc.freeze()
    gc.disable()

    async def start_gate() -> float:
        print("CONNECTED", flush=True)
        line = await asyncio.get_running_loop().run_in_executor(
            None, sys.stdin.readline)
        return float(line)

    result = asyncio.run(run_load(
        args.host, args.port, args.docs, args.clients_per_doc,
        args.rounds, args.batch, args.rate, args.seed, args.doc_prefix,
        tenant=args.tenant, timeout=args.timeout,
        trace_sample_n=args.trace_sample_n,
        start_gate=start_gate if args.start_gate else None))
    json.dump(result, sys.stdout)
    print()


if __name__ == "__main__":
    main()
