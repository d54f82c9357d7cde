"""Control-plane audit journal: the fleet's durable "why did that
happen" log.

JAX counterpart: ``fluidframework_tpu/obs/journal.py``; the port's copy,
imports rebased to this package. It is the port's own process-wide
journal, separate from the JAX package's, as the metrics registry is.

Ref: Routerlicious funnels every service decision through the
Lumberjack structured logger precisely because a no-merge-logic-
on-the-server design pushes all debugging onto observability (SURVEY
§2). The control plane acts — bumps an epoch, transfers a lease, seals
a partition, suppresses a rebalance, records a history commit — and
counters alone record THAT something happened, never WHY. This module is
the audit spine: every control-plane event appends one structured
JSONL entry to a per-core journal file on the shard dir, and entries
link to the event that caused them, so ``admin journal --fleet``
reconstructs causal chains across cores ("partition 3 moved at 14:02
because rebalance plan core0:41 saw heat 12k ops/s").

Entry schema (one JSON object per line, schema documented in
ARCHITECTURE.md "Fleet observability"):

    id     "<core>:<seq>" — globally unique, the cause-link target
    seq    per-core monotonic (recovered from the file tail on restart,
           so restarts never reuse ids)
    ts     wall-clock seconds (time.time) — human-correlatable
    core   emitting core id
    epoch  placement epoch at emit time (None when no table is bound)
    kind   one key of :data:`KINDS` — the closed registry fluidlint's
           ``journal-kind`` check enforces at lint time
    cause  the ``id`` of the triggering entry (or an opaque string such
           as a flight-dump path), None for root events
    labels free-form JSON-safe details (doc, part, reason, heat, ...)

Armament: the journal is DISARMED by default — ``emit`` on a disarmed
journal is one attribute test and a return (the bench A/B requirement:
disarmed overhead ~0). A core arms the process singleton when it has a
shard dir to persist on (``arm_journal``); in-process multi-core tests
construct private :class:`Journal` instances and inject them instead.

Durability: entries are flushed per write (control-plane events are
rare — never on the op hot path); the file rotates at ``max_bytes``
into a single ``.1`` generation, and readers tolerate torn tails (a
crash mid-write loses at most the last line).
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

from ..utils.affinity import any_thread

#: kind → one-line meaning. THE closed registry: every ``emit(kind)``
#: literal in the tree must be a key here — fluidlint's journal-kind
#: pass parses this table (a pure literal, keep it that way) and fails
#: the build on an undeclared kind, so the journal's vocabulary can
#: never drift silently.
KINDS = {
    "core.start": "core process started serving",
    "core.recover": "core recovered state after restart/crash",
    "core.stop": "core stopped serving (clean shutdown)",
    "lease.claim": "core claimed a partition lease",
    "lease.release": "core released a partition lease",
    "lease.takeover": "core revoked a peer's expired lease",
    "epoch.bump": "placement epoch advanced",
    "core.state": "core membership state changed (active/draining/drained)",
    "migration.seal": "partition sealed for migration (submits bounced)",
    "migration.fence": "migration fenced the partition's final seq",
    "migration.checkpoint": "sealed partition checkpointed + flushed",
    "migration.ship": "sealed log dir shipped cross-host via storage",
    "migration.adopt": "target core adopted the partition",
    "migration.commit": "migration committed (lease transferred)",
    "migration.fail": "migration failed and the source reclaimed",
    "rebalance.plan": "rebalancer produced an actionable plan",
    "rebalance.suppressed": "rebalancer suppressed a plan (with reason)",
    "rebalance.actuate": "rebalancer actuated one planned move",
    "slo.state": "SLO state transition (ok/warn/violated)",
    "summary.commit": "summarizer committed a summary",
    "flight.dump": "flight recorder wrote a dump",
    "operator.command": "operator-issued admin command",
    "history.commit": "history plane recorded a commit (ref advanced)",
    "history.fork": "doc forked from a parent commit",
    "history.integrate": "fork tail integrated back into its parent",
    "history.ref.recover": "recovery adopted/discarded a pending fork",
    "history.gc": "chunk GC swept unreferenced snapshot chunks",
    "core.cold_boot": "cold core armed lazy rehydration over its claims",
    "part.rehydrated": "partition served its first lazy doc boot",
    "part.checkpoint_fail": "one doc's checkpoint raised (others kept going)",
    "health.state": "health engine component transition (ok/degraded/critical)",
    "health.probe": "canary probe door failed or recovered",
}


class Journal:
    """Per-core durable audit journal (see module docstring).

    Disarmed (``path=None``) every method is a cheap no-op; ``arm``
    binds a file and recovers the monotonic seq from its tail.
    """

    def __init__(self, path: Optional[str] = None, core: str = "",
                 epoch_fn: Optional[Callable[[], Optional[int]]] = None,
                 max_bytes: int = 4 << 20):
        self._lock = threading.Lock()
        self._fh: Optional[io.TextIOWrapper] = None
        self._registry = None
        self.path: Optional[str] = None
        self.core = core
        self.epoch_fn = epoch_fn
        self.max_bytes = max_bytes
        self.seq = 0
        if path is not None:
            self.arm(path, core=core, epoch_fn=epoch_fn)

    @property
    def armed(self) -> bool:
        return self._fh is not None

    def arm(self, path: str, core: str = "",
            epoch_fn: Optional[Callable[[], Optional[int]]] = None) -> None:
        """Bind the journal to ``path`` and recover seq from its tail
        (a restarted core continues the id space instead of reusing
        ids, which would corrupt cause links in merged views)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self.path = path
            if core:
                self.core = core
            if epoch_fn is not None:
                self.epoch_fn = epoch_fn
            last = 0
            for entry in _read_file(path):
                if entry.get("seq", 0) > last:
                    last = entry["seq"]
            self.seq = last
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")

    def disarm(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self._fh = None
            self.path = None

    close = disarm

    def _metrics(self):
        if self._registry is None:
            from .metrics import get_registry

            self._registry = get_registry()
        return self._registry

    @any_thread
    def emit(self, kind: str, cause: Optional[str] = None,
             epoch: Optional[int] = None, **labels) -> Optional[str]:
        """Append one entry; returns its id (the cause link for
        downstream events), or None when disarmed."""
        if self._fh is None:
            return None
        if kind not in KINDS:
            raise ValueError(f"undeclared journal kind {kind!r} "
                             f"(add it to obs.journal.KINDS)")
        if epoch is None and self.epoch_fn is not None:
            try:
                epoch = self.epoch_fn()
            except Exception:
                epoch = None
        with self._lock:
            if self._fh is None:
                return None
            self.seq += 1
            entry = {
                "id": f"{self.core}:{self.seq}",
                "seq": self.seq,
                "ts": time.time(),
                "core": self.core,
                "epoch": epoch,
                "kind": kind,
                "cause": cause,
                "labels": labels,
            }
            try:
                line = json.dumps(entry, separators=(",", ":"),
                                  default=str)
                self._fh.write(line + "\n")
                self._fh.flush()
                reg = self._metrics()
                reg.inc("obs.journal.entries", kind=kind)
                reg.inc("obs.journal.bytes", len(line) + 1)
                if self._fh.tell() >= self.max_bytes:
                    self._rotate_locked()
            except OSError:
                self._metrics().inc("obs.journal.errors")
                return None
            return entry["id"]

    def _rotate_locked(self) -> None:
        """One-generation rotation: current → ``.1`` (replacing the
        previous generation), fresh current. seq continues."""
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            self._metrics().inc("obs.journal.errors")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._metrics().inc("obs.journal.rotations")

    def tail(self, n: int = 100, kind: Optional[str] = None,
             doc: Optional[str] = None,
             part: Optional[int] = None) -> list[dict]:
        """The last ``n`` entries (rotated generation included),
        optionally filtered — the ``admin_journal`` read path."""
        if self.path is None:
            return []
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        entries = read_journal(self.path)
        return filter_entries(entries, kind=kind, doc=doc, part=part)[-n:]


def _read_file(path: str) -> Iterable[dict]:
    """Entries of one JSONL file; corrupt/torn lines are skipped (a
    crash mid-write must not poison every later read)."""
    try:
        f = open(path, encoding="utf-8")
    except OSError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if isinstance(entry, dict) and "kind" in entry:
                yield entry


def read_journal(path: str) -> list[dict]:
    """Entries of a journal file, rotated generation first."""
    out = list(_read_file(path + ".1"))
    out.extend(_read_file(path))
    return out


def filter_entries(entries, kind: Optional[str] = None,
                   doc: Optional[str] = None,
                   part: Optional[int] = None) -> list[dict]:
    """Filter by kind prefix (``migration.`` matches every phase) and
    by the doc/part labels."""
    out = []
    for e in entries:
        if kind and not e.get("kind", "").startswith(kind):
            continue
        labels = e.get("labels") or {}
        if doc is not None and str(labels.get("doc")) != str(doc):
            continue
        if part is not None and str(labels.get("part")) != str(part):
            continue
        out.append(e)
    return out


def merge_entries(per_core: Iterable[list]) -> list[dict]:
    """Fleet merge: entries from many cores ordered by (epoch, ts,
    core, seq).

    Epoch leads wall time deliberately — the epoch table is the
    fleet's shared logical clock, so cross-core causality (seal on the
    source, adopt on the target) orders correctly even under wall-clock
    skew between hosts; ts only breaks ties within an epoch."""
    merged = [e for entries in per_core for e in entries]
    merged.sort(key=lambda e: (
        e.get("epoch") if isinstance(e.get("epoch"), (int, float)) else -1,
        e.get("ts", 0.0), str(e.get("core", "")), e.get("seq", 0)))
    return merged


def causal_chain(entries: list[dict], entry_id: str,
                 max_depth: int = 32) -> list[dict]:
    """Walk ``cause`` links backwards from ``entry_id`` → the chain
    root-first. Opaque causes (flight-dump paths) terminate the walk;
    cycles are cut by ``max_depth``."""
    by_id = {e["id"]: e for e in entries if "id" in e}
    chain: list[dict] = []
    seen: set[str] = set()
    cur = by_id.get(entry_id)
    while cur is not None and len(chain) < max_depth:
        if cur["id"] in seen:
            break
        seen.add(cur["id"])
        chain.append(cur)
        cause = cur.get("cause")
        cur = by_id.get(cause) if cause else None
    chain.reverse()
    return chain


_journal = Journal()


def get_journal() -> Journal:
    """The process-wide journal — disarmed (free) until a core with a
    shard dir arms it. Module-held singleton: the control-plane
    components that emit into it hold it for the process lifetime."""
    return _journal


def arm_journal(path: str, core: str = "",
                epoch_fn: Optional[Callable[[], Optional[int]]] = None
                ) -> Journal:
    """Arm the process singleton (idempotent re-arm rebinds)."""
    _journal.arm(path, core=core, epoch_fn=epoch_fn)
    return _journal


def reset_journal() -> None:
    """Disarm and reset the singleton IN PLACE (test isolation only) —
    components hold the object, so identity must survive the reset."""
    _journal.disarm()
    _journal.seq = 0
    _journal.core = ""
    _journal.epoch_fn = None
