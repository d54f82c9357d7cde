"""Socket clients on an open-loop schedule: one load process of a socket cell.

A frozen copy of the program's ``service/load_async.py`` client (the
connect handshake, the columnar submit, the broadcast scan, the absolute
schedule with a random phase), kept here so that a change to the program
cannot change the load it is measured under. The ops come from the
benchmark's own ``SyntheticEditor``; the wire is the program's protocol
(``protocol/binwire.py``), its input.

    python -m portbench.yardstick.sockets <run dir>

The argument only names the run (a harness finds its children by it).
The process reads one JSON command a line on standard input and answers
on standard output:

- a ``phase`` (``host``, ``port``, ``tenant``, ``docs``,
  ``clients_per_doc``, ``boxcar``, the mix, ``period_s``, ``seed``,
  ``ack_timeout_s``): it connects every client (64 at a time) and prints
  ``{"connected": n}``; then it reads ``{"start_at", "seconds"}`` (the
  start instant a wall-clock epoch) on a line of its own. Client ``c``
  submits a boxcar
  at ``start + (i + phase_c) * period_s`` for every ``i`` whose instant
  falls before ``start + seconds``; each boxcar's ack (its last op in the
  client's own broadcast) is timed from that due instant. Once the
  schedule has ended and every boxcar is acked, or ``ack_timeout_s``
  after the schedule's end, it prints the phase's result and closes the
  clients.
- end of input: the process exits.

A phase's result: ``submitted`` and ``acked`` ops, ``acked_in_time`` (ops
acked before the schedule's end), ``order_errors``, ``nacked``,
``errors``, ``ack_ms`` (one a boxcar), ``ack_due_s`` (each of those
boxcars' due instant, seconds into the schedule), ``late_ms`` (each send's lateness
against its due instant), ``last_ack_at`` (wall clock), ``docs`` (each
doc's highest acked seq) and ``boxcars`` (each acked boxcar as ``[doc,
client id, last seq, ops, digest]``, ``digest`` being ``ops_digest`` of
its ops).
"""

from __future__ import annotations

import asyncio
import gc
import json
import random
import socket as _socket
import sys
import time
import zlib

from portbench.yardstick.synthetic import CHANNEL_ID, DS_ID, SyntheticEditor

CONNECT_CONCURRENCY = 64


def ops_digest(ops) -> int:
    """A digest of ops as ``(kind, a, b, text, props)`` tuples, the shape
    ``streams.reference_ops`` reads them in (``b`` 0 for an insert)."""
    return zlib.crc32(json.dumps(
        [[int(k), int(a), int(b), t, p] for k, a, b, t, p in ops],
        sort_keys=True, separators=(",", ":")).encode())


class _Box:
    """The editor's boxcar: its fields, as ``next_boxcar`` gives them."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def ops(self) -> list:
        off = self.text_off.tolist()
        props = self.props
        return [(k, a, b, self.text[off[i]:off[i + 1]],
                 props[i] if props else None)
                for i, (k, a, b) in enumerate(zip(
                    self.kind.tolist(), self.a.tolist(), self.b.tolist()))]


class _Client:
    """One socket client: its connection, its editor, its boxcars in
    flight."""

    def __init__(self, phase: "_Phase", doc: str, rng: random.Random):
        self.phase = phase
        self.doc = doc
        self.editor = SyntheticEditor(
            rng, _Box, phase.cmd["remove_fraction"],
            phase.cmd["annotate_fraction"], phase.cmd["max_insert"])
        self.offset = rng.random()  # the schedule's phase, of a period
        self.client_id = None
        self.reader = self.writer = None
        # last cseq of a boxcar in flight → (due perf time, ops, digest)
        self.pending: dict = {}
        self.expect = 1  # the next own cseq an ack should start at

    async def connect(self) -> None:
        cmd = self.phase.cmd
        self.reader, self.writer = await asyncio.open_connection(
            cmd["host"], cmd["port"])
        sock = self.writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        body = json.dumps({"t": "connect", "tenant": cmd["tenant"],
                           "doc": self.doc, "bin": 1, "rid": 1},
                          separators=(",", ":")).encode()
        self.writer.write(len(body).to_bytes(4, "big") + body)
        await self.writer.drain()
        while self.client_id is None:
            if await self._read() is None:
                raise ConnectionError("closed during the handshake")

    async def _read(self):
        """Read and handle one frame; None at the end of the stream."""
        try:
            header = await self.reader.readexactly(4)
            body = await self.reader.readexactly(
                int.from_bytes(header, "big"))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        if self.phase.binwire.is_binary(body):
            self._observe(body)
            return body
        frame = json.loads(body.decode())
        t = frame.get("t")
        if t == "connected":
            self.client_id = frame["clientId"]
            self.editor.ref_seq = max(self.editor.ref_seq, frame["seq"])
        elif t == "nack":
            self.phase.nacked += 1
        elif t == "error":
            raise RuntimeError(frame.get("message"))
        return body

    def _observe(self, body: bytes) -> None:
        """Track a broadcast: the editor's ref seq and length, and the
        own boxcar it acks."""
        me, ed, phase = self.client_id, self.editor, self.phase
        for cid, seq, cseq, _ts, delta in phase.binwire.scan_ops(body):
            ed.ref_seq = seq
            if cid != me:
                if delta > 0:
                    ed.length += delta
                elif delta < 0:
                    ed.length = max(0, ed.length + delta)
                continue
            flight = self.pending.pop(cseq, None)
            if flight is None:
                continue
            now = time.perf_counter()
            due, n, digest, first = flight
            if first != self.expect:
                phase.order_errors += 1
            self.expect = cseq + 1
            phase.acked += n
            if now <= phase.end_perf:
                phase.acked_in_time += n
            phase.ack_ms.append((now - due) * 1e3)
            phase.ack_due.append(due - phase.t0)
            phase.last_ack = now
            phase.boxcars.append([self.doc, me, seq, n, digest])
            if seq > phase.doc_seqs.get(self.doc, 0):
                phase.doc_seqs[self.doc] = seq

    async def read_loop(self) -> None:
        try:
            while await self._read() is not None:
                pass
        except asyncio.CancelledError:
            pass
        except Exception as exc:  # an error frame: the run is void
            self.phase.errors.append(f"{type(exc).__name__}: {exc}")

    def submit(self, due: float) -> None:
        phase = self.phase
        cmd = phase.cmd
        box = self.editor.next_boxcar(cmd["boxcar"], cmd["tenant"],
                                      self.doc, self.client_id)
        bw = phase.binwire
        body = (bytes((bw.MAGIC, bw.FT_COLS_SUBMIT))
                + bw.encode_cols(DS_ID, CHANNEL_ID, box.kind, box.a, box.b,
                                 box.cseq, box.rseq, box.text, box.text_off,
                                 box.props)
                + b"\x00")  # an empty hoptail
        n = len(box.kind)
        self.pending[int(box.cseq[-1])] = (due, n, ops_digest(box.ops()),
                                           int(box.cseq[0]))
        self.writer.write(bw.frame(body))
        phase.submitted += n

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


class _Phase:
    """One command: its clients, its schedule and what it counted."""

    def __init__(self, cmd: dict, binwire):
        self.cmd = cmd
        self.binwire = binwire
        self.submitted = self.acked = self.acked_in_time = 0
        self.order_errors = self.nacked = 0
        self.errors: list = []
        self.ack_ms: list = []
        self.ack_due: list = []
        self.t0 = 0.0
        self.late_ms: list = []
        self.boxcars: list = []
        self.doc_seqs: dict = {}
        self.last_ack = 0.0
        self.end_perf = float("inf")
        rng = random.Random(cmd["seed"])
        self.clients = [_Client(self, doc, random.Random(rng.random()))
                        for doc in cmd["docs"]
                        for _ in range(cmd["clients_per_doc"])]

    async def connect(self) -> None:
        sem = asyncio.Semaphore(CONNECT_CONCURRENCY)

        async def one(c):
            async with sem:
                await c.connect()

        await asyncio.gather(*(one(c) for c in self.clients))
        self.readers = [asyncio.ensure_future(c.read_loop())
                        for c in self.clients]

    async def run(self, start_at: float, seconds: float) -> dict:
        cmd = self.cmd
        period = cmd["period_s"]
        self.t0 = t0 = time.perf_counter() + (start_at - time.time())
        self.end_perf = t0 + seconds
        due = sorted((t0 + (i + c.offset) * period, k)
                     for k, c in enumerate(self.clients)
                     for i in range(int(seconds / period + 1))
                     if (i + c.offset) * period < seconds)
        clients = self.clients
        late = self.late_ms
        for at, k in due:
            delay = at - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            late.append(max(0.0, time.perf_counter() - at) * 1e3)
            clients[k].submit(at)
        until = self.end_perf + cmd["ack_timeout_s"]
        while not self.errors and (
                time.perf_counter() < self.end_perf
                or (self.acked < self.submitted
                    and time.perf_counter() < until)):
            await asyncio.sleep(0.002)
        for r in self.readers:
            r.cancel()
        for c in clients:
            c.close()
        return {
            "submitted": self.submitted, "acked": self.acked,
            "acked_in_time": self.acked_in_time,
            "order_errors": self.order_errors, "nacked": self.nacked,
            "errors": self.errors[:4], "ack_ms": self.ack_ms,
            "ack_due_s": self.ack_due,
            "late_ms": late,
            "last_ack_at": (time.time() - (time.perf_counter()
                                           - self.last_ack)
                            if self.last_ack else None),
            "docs": self.doc_seqs, "boxcars": self.boxcars,
        }


async def _serve() -> None:
    from fluidframework_tpu_torch.protocol import binwire

    loop = asyncio.get_running_loop()

    async def line() -> str:
        return await loop.run_in_executor(None, sys.stdin.readline)

    while True:
        text = await line()
        if not text.strip():
            return
        phase = _Phase(json.loads(text), binwire)
        await phase.connect()
        print(json.dumps({"connected": len(phase.clients)}), flush=True)
        start = json.loads(await line())
        print(json.dumps(await phase.run(start["start_at"],
                                         start["seconds"])), flush=True)


def main() -> None:
    # the client path makes no reference cycles: no collector pauses in
    # the timed acks (load_async's setting)
    gc.collect()
    gc.freeze()
    gc.disable()
    asyncio.run(_serve())


if __name__ == "__main__":
    main()
