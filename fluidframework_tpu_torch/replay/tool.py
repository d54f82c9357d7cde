"""Replay recorded op logs through the REAL client stack and the replica
farm, asserting byte-identical state fingerprints across versions.

JAX counterpart: ``fluidframework_tpu/replay/tool.py``; the port's copy,
imports rebased to this package. ``replay_through_applier`` feeds the
port's ``GpuDocumentApplier``, on ``cuda`` unless given ``device="cpu"``.
No driver of the port has a history surface yet (ROADMAP A4), so every
replay takes the legacy whole-log path, and ``main`` replays file-driver
document directories only (the JAX tool's ``--port`` replays a live doc
through the network driver).

Ref: replay-tool/src/replayMessages.ts (drives loader+runtime over the
replay driver, snapshotting at intervals) and
packages/test/snapshots/src/replayMultipleFiles.ts:33 (Write mode records
expectations, Compare mode fails on any drift). A fingerprint mismatch
against a committed corpus means a semantic change to the CRDT — either
an intentional format bump (re-record the corpus) or a regression.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from ..driver.file import FileDocumentService
from ..loader.container import Container
from ..obs import tier_counters
from ..protocol.messages import MessageType

DS_ID = "default"
TEXT_CHANNEL = "text"


def state_fingerprint(container: Container) -> str:
    """Canonical sha256 over the container's full replica state — the
    byte-identity the snapshot-regression suite compares across code
    versions (dict key order normalized; no timestamps included)."""
    state = {
        "protocol": container.protocol.snapshot(),
        "runtime": container.runtime.snapshot(),
        "sequence_number": container.delta_manager.last_processed_seq,
    }
    blob = json.dumps(state, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


class ReplayController:
    """Pumps a document through a real Container in steps.

    Boot is history-first: when the service exposes a history surface
    holding a committed version (live local/network docs the history
    plane tracks), the container boots O(snapshot) from the newest
    commit through the replay driver and only the tail above its base
    is pumped. Otherwise — file-driver corpus docs, docs never
    summarized — the legacy path replays the recorded log from its
    start and is counted under ``history.replay.legacy`` so deployments
    can see how many offline replays still bypass the commit graph."""

    def __init__(self, service):
        self.service = service
        self.counters = tier_counters("driver")
        self.history = self._resolve_history(service)
        if self.history is not None:
            self._last = self._history_head(self.history)
            self.container = Container(
                self.history.replay_service(self._last)).load(connect=False)
        else:
            self._last = service.connect_to_delta_storage().last_seq
            self.container = Container(service).load(connect=False)
            self.counters.inc("history.replay.legacy")

    @staticmethod
    def _resolve_history(service):
        try:
            history = service.history()
        except NotImplementedError:
            return None
        return history if history.log(1) else None

    @staticmethod
    def _history_head(history) -> int:
        """Last sequenced seq the history plane can serve: the newest
        commit's base plus its durable tail."""
        base = history.at(10 ** 9)["base_seq"]
        tail = history.deltas(base, 10 ** 9)
        return tail[-1].sequence_number if tail else base

    def run(self, snapshot_every: int = 50) -> dict:
        """Replay to the end, fingerprinting every ``snapshot_every``
        sequenced ops; returns the expectations record. The fingerprint
        grid stays anchored at multiples of ``snapshot_every`` whatever
        the boot base, so history-first and legacy replays of the same
        doc agree on every seq they both cover."""
        last = self._last
        snapshots: dict[str, str] = {}
        base = self.container.delta_manager.last_processed_seq
        seq = base - (base % snapshot_every)
        while seq < last:
            seq = min(seq + snapshot_every, last)
            at = self.container.delta_manager.advance_to(seq)
            snapshots[str(at)] = state_fingerprint(self.container)
        return {
            "last_seq": last,
            "snapshots": snapshots,
            "final_text": self.final_text(),
        }

    def final_text(self) -> Optional[str]:
        ds = self.container.runtime.data_stores.get(DS_ID)
        if ds is None or TEXT_CHANNEL not in ds.channels:
            return None
        return ds.get_channel(TEXT_CHANNEL).get_text()


def replay_and_compare(doc_dir: str, expect: dict,
                       snapshot_every: int = 50) -> list[str]:
    """Compare mode: replay ``doc_dir`` and diff against committed
    expectations. Returns human-readable mismatches (empty = pass)."""
    got = ReplayController(
        FileDocumentService.from_dir(doc_dir)).run(snapshot_every)
    problems = []
    if got["last_seq"] != expect["last_seq"]:
        problems.append(
            f"last_seq: got {got['last_seq']}, want {expect['last_seq']}")
    if got["final_text"] != expect["final_text"]:
        problems.append(
            f"final_text drift: got {got['final_text']!r}, "
            f"want {expect['final_text']!r}")
    for seq, want in expect["snapshots"].items():
        have = got["snapshots"].get(seq)
        if have != want:
            problems.append(f"fingerprint @seq {seq}: {have} != {want}")
    return problems


def replay_through_applier(doc_dir: str, applier=None,
                           device=None) -> str:
    """Feed the recorded doc's text-channel stream through a
    GpuDocumentApplier (the scribe-replay role, BASELINE config 5) and
    return the device-side final text. ``device`` places the default
    applier (``cuda`` when None, which raises without a card); a given
    ``applier`` keeps its own."""
    from ..service.gpu_applier import GpuDocumentApplier

    service = FileDocumentService.from_dir(doc_dir)
    msgs = service.connect_to_delta_storage().get_deltas(0, 10**9)
    if applier is None:
        applier = GpuDocumentApplier(max_docs=4, max_slots=512,
                                     ops_per_dispatch=16, device=device)
    applier.set_replay_source(lambda t, d: [])
    pairs = []
    for m in msgs:
        if m.type != MessageType.OPERATION:
            continue
        env = m.contents
        if not isinstance(env, dict) or env.get("kind") != "chanop":
            continue
        if env["address"] != DS_ID:
            continue
        inner = env["contents"]
        if inner.get("address") != TEXT_CHANNEL or "attach" in inner:
            continue
        pairs.append((m, inner["contents"]))
    applier.ingest_batch("replay", os.path.basename(doc_dir), pairs)
    applier.finalize()
    return applier.get_text("replay", os.path.basename(doc_dir))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="replay a recorded doc through the real client stack")
    p.add_argument("target", help="a file-driver doc dir")
    p.add_argument("--every", type=int, default=50,
                   help="fingerprint interval in sequenced ops")
    args = p.parse_args(argv)
    controller = ReplayController(FileDocumentService.from_dir(args.target))
    got = controller.run(args.every)
    mode = ("history-first" if controller.history is not None
            else "legacy whole-log")
    print(f"{mode} replay to seq {got['last_seq']}: "
          f"{len(got['snapshots'])} fingerprint(s)")
    print(f"final text: {got['final_text']!r}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
