"""Canary prober: synthetic blackbox probes through the REAL doors.

JAX counterpart: ``fluidframework_tpu/obs/probe.py``; the port's copy,
imports rebased to this package. The front end's ``--probe`` flag (or a
topology spec's ``health`` stanza) arms it beside the health engine
(``obs/health.py``).

The SLO engine only sees tenant traffic — a component that drops no
real request is invisible to it until a user arrives (the gray-failure
trap, Huang et al. HotOS'17). The prober closes that gap the way
Dapper closes the tracing gap: observe the system from its OWN doors.
A ticker thread per core dials the core's own listening socket like
any client and walks the doors end to end every tick on a reserved
``__canary__`` tenant:

``connect``   fresh TCP dial + connect frame → ``connected`` reply
              (auth, routing, session setup — the whole front door)
``submit``    one op on that session → its own broadcast push (the
              full submit → admit → deli → fanout round trip)
``history``   ``history_log`` on the canary doc (the history plane's
              read door)
``snapshot``  ``get_versions`` (the storage/boot read door; armed only
              when the core has a storage tier attached)
``route``     ping → pong against peer cores from the placement
              membership, cross-host peers FIRST on multi-host
              topologies (the door a gateway would route through)

Each door records ``health.probe.ms{door=...}`` into the windowed
registry and ``health.probe.failures{door=...}`` on error; door state
CHANGES (ok→fail, fail→ok) journal a ``health.probe`` entry. Peer
reachability rows feed the HealthEngine's placement component — three
dead peers on one host id IS the doctor's unreachable-host-group rule,
evaluated live.

Isolation: ``__canary__`` traffic is excluded at the admission seams
(service/front_end.py, service/admission.py) from placement heat,
tenant token buckets, and SLO hop accounting — probing can never
trigger rebalancing or shedding).

Layering: obs imports nothing above utils, so the transport is an
injected ``dial(host, port) -> channel`` factory (the service wiring
passes the driver's ``_Transport``) and ops ride as plain dict frames.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils.affinity import ticker_thread
from .journal import get_journal
from .metrics import get_registry

#: the reserved synthetic tenant; every isolation seam keys on this
CANARY_TENANT = "__canary__"
#: canary doc name prefix — the wiring picks a suffix this core owns
CANARY_DOC = "__probe__"


class CanaryProber:
    """Drives the doors once per tick; see the module docstring.

    ``dial(host, port)`` must return a channel with ``request_rid``,
    ``send``, ``on_push``, and ``close`` (the driver ``_Transport``
    contract). ``doc_fn`` returns a canary doc name routed to THIS
    core (or None while the core owns no partitions — the session
    doors then idle without counting failures). ``peers_fn`` returns
    ``owner -> {"addr": .., "host": ..}`` for the route door.
    ``token_fn(tenant, doc)`` mints a canary token on enforcing
    deployments (None in dev mode).
    """

    def __init__(self, dial: Callable, host: str, port: int,
                 core: str = "",
                 doc_fn: Optional[Callable] = None,
                 peers_fn: Optional[Callable] = None,
                 token_fn: Optional[Callable] = None,
                 registry=None, journal=None,
                 tick_s: float = 2.0, timeout: float = 5.0,
                 snapshot: bool = False, max_route_peers: int = 2):
        self._dial = dial
        self.host = host
        self.port = port
        self.core = core
        self._doc_fn = doc_fn
        self._peers_fn = peers_fn
        self._token_fn = token_fn
        self._reg = registry or get_registry()
        self.journal = journal if journal is not None else get_journal()
        self.tick_s = tick_s
        self.timeout = timeout
        self.snapshot = snapshot
        self.max_route_peers = max(0, int(max_route_peers))
        self._doors: dict = {}
        self._peer_rows: dict = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---------------------------------------------------------- verdicts

    def _record(self, door: str, ok: bool, ms: float,
                error: Optional[str] = None) -> None:
        self._reg.observe_windowed("health.probe.ms", ms, door=door)
        with self._lock:
            d = self._doors.setdefault(
                door, {"ok": True, "consec_failures": 0, "probes": 0,
                       "last_ms": 0.0, "last_error": None})
            d["probes"] += 1
            d["last_ms"] = round(ms, 3)
            was_ok = d["ok"]
            if ok:
                d["ok"] = True
                d["consec_failures"] = 0
                d["last_error"] = None
            else:
                d["ok"] = False
                d["consec_failures"] += 1
                d["last_error"] = error
                self._reg.inc("health.probe.failures", door=door)
        if ok is not was_ok:
            self.journal.emit(
                "health.probe", door=door,
                state="ok" if ok else "fail", error=error,
                ms=round(ms, 3))

    def status(self) -> dict:
        with self._lock:
            return {"doors": {k: dict(v)
                              for k, v in sorted(self._doors.items())},
                    "peers": {k: dict(v)
                              for k, v in self._peer_rows.items()}}

    def peer_rows(self) -> dict:
        """owner → manifest-shaped row (``error`` set when the route
        probe can't reach it) — the HealthEngine's ``cores_fn``."""
        with self._lock:
            return {k: dict(v) for k, v in self._peer_rows.items()}

    # ------------------------------------------------------------- doors

    def _timed(self, door: str, fn: Callable) -> bool:
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — a failed door is data
            self._record(door, False,
                         (time.monotonic() - t0) * 1000.0, str(e))
            return False
        self._record(door, True, (time.monotonic() - t0) * 1000.0)
        return True

    def _probe_session_doors(self) -> None:
        """connect → submit/ack → history → snapshot, one fresh
        session through the real front door."""
        doc = self._doc_fn() if self._doc_fn is not None else CANARY_DOC
        if doc is None:
            return  # no owned partitions yet: nothing routes here
        token = (self._token_fn(CANARY_TENANT, doc)
                 if self._token_fn is not None else None)
        chan = None
        try:
            state: dict = {}

            def connect():
                state["chan"] = self._dial(self.host, self.port)
                _, reply = state["chan"].request_rid(
                    {"t": "connect", "tenant": CANARY_TENANT,
                     "doc": doc, "token": token, "bin": 0})
                state["client_id"] = reply.get("clientId")
                # the doc's current sequence number: a fresh session
                # must reference it or deli nacks the op ("refSeq below
                # msn") once an earlier probe advanced the MSN
                state["seq"] = int(reply.get("seq") or 0)

            if not self._timed("connect", connect):
                return
            chan = state["chan"]

            def submit():
                cid = state["client_id"]
                got = threading.Event()

                def seen(frame):
                    return any(m.get("client_id") == cid
                               for m in frame.get("msgs", []))

                chan.on_push("ops", lambda f: seen(f) and got.set())
                # one op in the driver's wire encoding
                # (protocol/serialization.py message_to_dict shape) —
                # a fresh session, so clientSeq starts at 1
                chan.send({"t": "submit", "ops": [{
                    "_kind": "doc",
                    "client_sequence_number": 1,
                    "reference_sequence_number": state["seq"],
                    "type": "op",
                    "contents": {"canary": self.core},
                    "metadata": None, "traces": []}]})
                if not got.wait(self.timeout):
                    raise TimeoutError(
                        f"own broadcast not seen in {self.timeout}s")

            self._timed("submit", submit)

            def history():
                chan.request_rid({"t": "history_log",
                                  "tenant": CANARY_TENANT, "doc": doc,
                                  "token": token})

            self._timed("history", history)

            if self.snapshot:
                def snapshot():
                    chan.request_rid({"t": "get_versions",
                                      "tenant": CANARY_TENANT,
                                      "doc": doc, "token": token,
                                      "count": 1})

                self._timed("snapshot", snapshot)

            try:
                chan.send({"t": "disconnect"})
            except Exception:
                pass
        finally:
            if chan is not None:
                try:
                    chan.close()
                except Exception:
                    pass

    def _probe_route(self) -> None:
        """ping → pong against peer cores, cross-host first: the leg a
        gateway (or a migrating partition) would actually traverse."""
        peers = dict(self._peers_fn() or {}) if self._peers_fn else {}
        with self._lock:
            for owner in list(self._peer_rows):
                if owner not in peers:
                    del self._peer_rows[owner]
        if not peers:
            return
        my_host = peers.pop(self.core, {}).get("host")
        ranked = sorted(
            peers.items(),
            key=lambda kv: (kv[1].get("host") == my_host, kv[0]))
        for owner, row in ranked[:self.max_route_peers]:
            addr = row.get("addr") or ""
            host, _, port = addr.rpartition(":")

            def route(owner=owner, addr=addr, host=host, port=port):
                try:
                    chan = self._dial(host or "127.0.0.1", int(port))
                except Exception as e:
                    raise ConnectionError(
                        f"{owner} ({addr}): {e}") from None
                try:
                    ev = threading.Event()
                    chan.on_push("pong", lambda f: ev.set())
                    chan.send({"t": "ping"})
                    if not ev.wait(self.timeout):
                        raise TimeoutError(
                            f"no pong from {owner} ({addr}) within "
                            f"{self.timeout}s")
                finally:
                    try:
                        chan.close()
                    except Exception:
                        pass

            ok = self._timed("route", route)
            with self._lock:
                prow = {"addr": addr, "host": row.get("host")}
                if not ok:
                    prow["error"] = (self._doors.get("route") or {}).get(
                        "last_error") or "unreachable"
                self._peer_rows[owner] = prow

    def probe_once(self) -> dict:
        """One full pass over every armed door; returns status()."""
        self._probe_session_doors()
        self._probe_route()
        return self.status()

    # ------------------------------------------------------------ thread

    def start(self) -> "CanaryProber":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="fluid-probe-ticker",
                daemon=True)
            self._thread.start()
        return self

    @ticker_thread("probe")
    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.probe_once()
            except Exception:
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
