"""Chaos cold-start campaign: kill -9 the WHOLE fleet mid-traffic,
restart it from its topology spec, and audit exact-once delivery.

JAX counterpart: ``fluidframework_tpu/chaos/coldstart.py``; the port's copy,
imports rebased to this package.

``python -m fluidframework_tpu_torch.chaos.coldstart --seed N`` runs a seeded
campaign against a real subprocess fleet (service/topology.py): cores +
storage tier started from one TopologySpec on pinned ports, seeded
clients inserting globally-unique tokens, then three acts:

1. **The kill.** SIGKILL every process at once — cores, storage — with
   the last submissions still in flight. No checkpoint, no goodbye.
2. **The crashed recovery.** Restart from the SAME spec with the
   rehydration crash seam armed (``FLUID_CHAOS_BOOT_CRASH=K``): each
   core dies with exactly K doc boots admitted, mid-storm — proving a
   crash INSIDE lazy rehydration is just another cold start.
3. **The clean recovery.** Restart again, seam disarmed. Clients
   reconnect, catch up, and resubmit only the tokens the sequenced
   history does NOT already hold (content-filtered resubmission — an
   op can be durably sequenced but unacked at kill time, so blind
   resubmit would double it).

The verdict, per doc, through a fresh verifier client booting from the
rehydrated state: every token appears in the final text EXACTLY once —
no token lost by the kill, none doubled by tail replay across two
crash/restart cycles. The campaign also asserts the lazy-boot
contract fleet-wide via ``admin_boot_status``: every summarized +
checkpointed doc rehydrates lazily (``boot.part.full_replay == 0``)
and at least one crash-seam core actually died with exit code 9.
Same seed ⇒ same token streams and kill points. Exit 1 on violation.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import socket
import sys
import tempfile
import time

from ..utils.telemetry import Counters
from ..obs import tier_counters
from .monitor import InvariantViolation

TENANT = "chaos"

#: lease TTL — short, so the restarted generation claims the dead
#: generation's partitions in well under a second
TTL = 0.75

#: the crash seam: each core of the crashed generation dies after this
#: many doc boots have been admitted by its rehydration executor
BOOT_CRASH_AFTER = 2


def _free_ports(n: int) -> list:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _wait(cond, timeout=30.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class TokenClient:
    """One doc's client: inserts unique tokens, survives fleet death by
    re-resolving, and resubmits content-filtered after recovery."""

    def __init__(self, doc: str, port: int, rng: random.Random):
        self.doc = doc
        self.port = port
        self.rng = rng
        self.tokens: list[str] = []  # every token this client ever sent
        self.container = None
        self.string = None

    def connect(self) -> None:
        from ..driver.network import NetworkDocumentServiceFactory
        from ..loader import Loader

        loader = Loader(NetworkDocumentServiceFactory(
            "127.0.0.1", self.port))
        self.container = loader.resolve(TENANT, self.doc)
        rt = self.container.runtime
        if "default" not in rt.data_stores:
            ds = rt.create_data_store("default")
        else:
            ds = rt.get_data_store("default")
        if "text" not in ds.channels:
            self.string = ds.create_channel("text", "shared-string")
        else:
            self.string = ds.get_channel("text")

    def _boundary(self) -> int:
        # only ever insert at token boundaries — a mid-token insert
        # would split an earlier token and break the substring audit
        text = self.string.get_text()
        spots = [0] + [i + 1 for i, ch in enumerate(text) if ch == " "]
        return self.rng.choice(spots)

    def insert(self, token: str) -> None:
        self.tokens.append(token)
        self.string.insert_text(self._boundary(), token + " ")

    def drained(self) -> bool:
        return self.container.runtime.pending.count == 0

    def abandon(self) -> None:
        self.container = None
        self.string = None

    def resubmit_missing(self) -> int:
        """Content-filtered recovery: re-insert only tokens the
        sequenced history does not hold. Returns how many."""
        text = self.string.get_text()
        missing = [t for t in self.tokens if t not in text]
        for t in missing:
            self.string.insert_text(self._boundary(), t + " ")
        return len(missing)


def run_campaign(seed: int, counters: Counters,
                 quick: bool = False) -> dict:
    from ..driver.network import _Transport
    from ..service.stage_runner import doc_partition
    from ..service.topology import Fleet, default_spec

    rng = random.Random(seed)
    n_docs = 4 if quick else 8
    tokens_each = 6 if quick else 10
    n_parts, n_cores = 4, 2
    work_dir = tempfile.mkdtemp(prefix="chaos-coldstart-")
    fl = None
    try:
        spec = default_spec(os.path.join(work_dir, "fleet"),
                            n_cores=n_cores, n_partitions=n_parts,
                            lease_ttl=TTL, summarize_every=1000,
                            boot_rate=50.0, boot_burst=2)
        # pinned ports: reconnecting clients must find the RESTARTED
        # generation at the address the spec declares
        for core, port in zip(spec.cores, _free_ports(n_cores)):
            core.port = port
        fl = Fleet(spec, subprocess=True, env={}).start()
        fl.wait_claimed()

        def core_port_for(doc: str) -> int:
            # route by the ACTUAL owner in the epoch table, not the
            # spec's prefer map — after a kill/restart cycle stale-lease
            # takeover may land a partition on a non-prefer core
            from ..service.placement_plane import EpochTable

            part = doc_partition(TENANT, doc, n_parts)
            rec = EpochTable.for_shard_dir(
                spec.shard_dir).read()["parts"][str(part)]
            return int(rec["addr"].rsplit(":", 1)[1])

        def reroute_and_connect(c: "TokenClient") -> None:
            # ownership can still churn for a beat after wait_claimed;
            # re-resolve the owner and retry briefly on routing errors
            deadline = time.monotonic() + 20.0
            while True:
                c.port = core_port_for(c.doc)
                try:
                    c.connect()
                    return
                except RuntimeError as e:
                    if ("not the owner" not in str(e)
                            or time.monotonic() >= deadline):
                        raise
                    time.sleep(0.2)

        clients = []
        for i in range(n_docs):
            doc = f"cs{i}"
            c = TokenClient(doc, core_port_for(doc),
                            random.Random(seed * 1000 + i))
            c.connect()
            clients.append(c)

        # ---- seeded traffic, then summaries + checkpoints ----------
        for j in range(tokens_each - 2):
            for i, c in enumerate(clients):
                c.insert(f"T{seed}d{i}n{j:03d}")
        if not _wait(lambda: all(c.drained() for c in clients)):
            raise InvariantViolation("pre-kill traffic never drained")
        for c in clients:
            t = _Transport("127.0.0.1", c.port)
            t.request_rid({"t": "admin_summarize", "tenant": TENANT,
                           "doc": c.doc})
            t.close()
        time.sleep(2.5)  # one checkpoint-ticker pass past the summary

        # ---- the kill: last submissions still in flight ------------
        for j in range(tokens_each - 2, tokens_each):
            for i, c in enumerate(clients):
                c.insert(f"T{seed}d{i}n{j:03d}")
        counters.inc("chaos.injected.fleet_kill")
        fl.kill()
        for c in clients:
            c.abandon()

        # ---- act 2: recovery that itself crashes mid-rehydration ---
        fl.env = {"FLUID_CHAOS_BOOT_CRASH": str(BOOT_CRASH_AFTER)}
        fl.start()
        fl.wait_claimed()
        crash_procs = dict(fl.procs)
        # reconnecting clients ARE the boot storm; the seam kills each
        # core after BOOT_CRASH_AFTER admitted boots
        for c in clients:
            try:
                c.port = core_port_for(c.doc)
                c.connect()
            except Exception:  # noqa: BLE001 — core died mid-storm
                pass
        crashed = 0
        for p in crash_procs.values():
            try:
                if p.wait(timeout=30) == 9:
                    crashed += 1
            except Exception:
                pass
        if crashed == 0:
            raise InvariantViolation(
                "FLUID_CHAOS_BOOT_CRASH armed but no core died with "
                "exit code 9 — the rehydration crash seam never fired")
        counters.inc("chaos.injected.boot_crash", crashed)
        for c in clients:
            c.abandon()

        # ---- act 3: the clean recovery -----------------------------
        fl.env = {}
        fl.restart()
        fl.wait_claimed()
        resubmitted = 0
        for c in clients:
            reroute_and_connect(c)
            counters.inc("chaos.recovered.reconnect")
        # catch-up settles (the driver boots from snapshot + fetches
        # the tail) before the content filter decides what to resend
        if not _wait(lambda: all(c.drained() for c in clients)):
            raise InvariantViolation("post-restart catch-up never "
                                     "drained")
        for c in clients:
            n = c.resubmit_missing()
            resubmitted += n
            if n:
                counters.inc("chaos.recovered.resubmit", n)
        if not _wait(lambda: all(c.drained() for c in clients)):
            raise InvariantViolation("resubmitted tokens never drained")

        # ---- the verdict: exact-once, through fresh verifiers ------
        losses, dupes = [], []
        detail: dict = {}
        for c in clients:
            v = TokenClient(c.doc, c.port, random.Random(0))
            v.connect()
            ok = _wait(lambda: "default" in v.container.runtime.data_stores
                       and "text" in v.container.runtime.get_data_store(
                           "default").channels, 20)
            if not ok:
                raise InvariantViolation(
                    f"verifier for {c.doc} never booted")
            text = v.container.runtime.get_data_store(
                "default").get_channel("text").get_text()
            lost_here = []
            for t in c.tokens:
                n = text.count(t)
                if n == 0:
                    losses.append(t)
                    lost_here.append(t)
                elif n > 1:
                    dupes.append((t, n))
            detail[c.doc] = {"lost": lost_here, "len": len(text)}
        if losses:
            raise InvariantViolation(
                f"{len(losses)} tokens LOST across the crash/restart "
                f"cycles (first: {losses[0]}; detail: {detail})")
        if dupes:
            raise InvariantViolation(
                f"{len(dupes)} tokens DUPLICATED by tail replay "
                f"(first: {dupes[0]})")

        # ---- the lazy-boot contract, fleet-wide --------------------
        boot_counts: dict = {}
        for i in range(n_cores):
            t = _Transport("127.0.0.1", spec.cores[i].port)
            _, reply = t.request_rid({"t": "admin_boot_status"})
            t.close()
            for k, v in reply["boot"]["counters"].items():
                boot_counts[k] = boot_counts.get(k, 0) + v
        if boot_counts.get("boot.part.full_replay", 0) != 0:
            raise InvariantViolation(
                "a summarized + checkpointed doc whole-log replayed: "
                f"{boot_counts}")
        if boot_counts.get("boot.part.lazy", 0) < n_docs:
            raise InvariantViolation(
                f"expected >= {n_docs} lazy boots in the final "
                f"generation, saw {boot_counts}")

        return {
            "seed": seed,
            "quick": quick,
            "docs": n_docs,
            "tokens": n_docs * tokens_each,
            "boot_crashed_cores": crashed,
            "resubmitted": resubmitted,
            "boot": {k: v for k, v in sorted(boot_counts.items())
                     if k.startswith("boot.")},
            "counters": {k: v for k, v in sorted(
                counters.snapshot().items()) if k.startswith("chaos.")},
        }
    finally:
        if fl is not None:
            fl.stop()
        shutil.rmtree(work_dir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="chaos cold-start campaign: kill -9 the whole "
                    "fleet mid-traffic, restart it from its topology "
                    "spec, audit exact-once delivery")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="fewer docs/tokens (CI smoke)")
    args = parser.parse_args(argv)
    counters = tier_counters("chaos")
    try:
        result = run_campaign(args.seed, counters, quick=args.quick)
    except InvariantViolation as e:
        print(f"COLD-START CAMPAIGN FAILED (seed {args.seed}): {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
