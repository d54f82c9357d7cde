"""Flight recorder: bounded post-mortem state, dumped on failure.

JAX counterpart: ``fluidframework_tpu/obs/flight.py``; the port's copy,
imports rebased to this package.

A chaos invariant can say THAT it tripped; it cannot say what the wire
looked like in the seconds before. This module keeps two
always-on rings per process — cheap enough to never turn off:

- an event ring: recent telemetry events (boxcar admissions, tickets,
  crashes) as small dicts;
- per-connection frame rings: the last N frame DIGESTS (timestamp,
  direction, length, first bytes hex) seen on each socket — digests,
  not bodies, so a hot connection pins a few KB, not its throughput.

``dump(reason)`` snapshots both rings to a JSONL file and returns the
path. Triggers (wired at the call sites): the chaos ``InvariantMonitor``
firing, an injected orderer crash, an unhandled tier exception escaping
a connection handler. The soak attaches ``last_dump`` to its failure
report so a red run carries its own post-mortem.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

#: Ring capacities: telemetry events, frame digests per connection, and
#: distinct connections tracked (oldest-touched evicted beyond that).
EVENT_RING = 512
FRAME_RING = 64
MAX_CONNS = 256
#: Leading body bytes kept in a frame digest.
DIGEST_HEAD = 12
#: The fields of an admission event, in the order ``event`` writes them.
_ADMISSION_FIELDS = ("ts", "tier", "event", "doc", "client", "n")


class FlightRecorder:
    """Bounded rings + JSONL dump (see module docstring)."""

    def __init__(self, dump_dir: Optional[str] = None,
                 event_ring: int = EVENT_RING,
                 frame_ring: int = FRAME_RING,
                 max_conns: int = MAX_CONNS):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=event_ring)
        self._frames: OrderedDict[str, deque] = OrderedDict()
        self._frame_ring = frame_ring
        self._max_conns = max_conns
        self._dump_dir = dump_dir
        self._dump_n = 0
        self.last_dump: Optional[str] = None

    def event(self, tier: str, kind: str, **fields) -> None:
        """Record one telemetry event into the ring."""
        rec = {"ts": time.time(), "tier": tier, "event": kind}
        rec.update(fields)
        self._events.append(rec)

    def admission(self, kind: str, doc: str, client: str, n: int) -> None:
        """Record one boxcar admission: the event ``event("deli", kind,
        doc=doc, client=client, n=n)`` records, kept as a tuple on the
        submit path and expanded by ``dump``."""
        self._events.append((time.time(), "deli", kind, doc, client, n))

    def frame(self, conn: str, direction: str, body: bytes) -> None:
        """Record one frame digest on a connection's ring.

        ``direction`` is "in" (socket → tier) or "out" (tier → socket).
        """
        digest = {"ts": time.time(), "dir": direction, "len": len(body),
                  "head": bytes(body[:DIGEST_HEAD]).hex()}
        with self._lock:
            ring = self._frames.get(conn)
            if ring is None:
                while len(self._frames) >= self._max_conns:
                    self._frames.popitem(last=False)
                ring = self._frames[conn] = deque(maxlen=self._frame_ring)
            else:
                self._frames.move_to_end(conn)
            ring.append(digest)

    def dump(self, reason: str, **fields) -> str:
        """Snapshot both rings to a JSONL file; returns its path.

        Line 1 is the dump header ({"flight": reason, ...}); then the
        event ring oldest-first; then every connection's frame ring
        oldest-first — so the TAIL of the file is the frames that
        immediately preceded the trigger.
        """
        with self._lock:
            events = list(self._events)
            frames = [(conn, list(ring))
                      for conn, ring in self._frames.items()]
            self._dump_n += 1
            n = self._dump_n
        d = self._dump_dir or os.environ.get(
            "FLUID_FLIGHT_DIR") or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flight-{os.getpid()}-{n}.jsonl")
        with open(path, "w") as f:
            head = {"flight": reason, "ts": time.time(),
                    "events": len(events),
                    "conns": len(frames)}
            head.update(fields)
            f.write(json.dumps(head, default=str) + "\n")
            for rec in events:
                if type(rec) is tuple:
                    rec = dict(zip(_ADMISSION_FIELDS, rec))
                f.write(json.dumps({"kind": "event", **rec}, default=str)
                        + "\n")
            for conn, ring in frames:
                for digest in ring:
                    f.write(json.dumps(
                        {"kind": "frame", "conn": conn, **digest}) + "\n")
        self.last_dump = path
        return path


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder (lazily constructed singleton)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def reset_recorder() -> None:
    """Drop the singleton (test isolation only)."""
    global _recorder
    with _recorder_lock:
        _recorder = None
