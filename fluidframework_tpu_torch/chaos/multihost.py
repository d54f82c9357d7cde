"""Chaos host-kill campaign: kill -9 ONE host group mid-traffic,
respawn it from its spec copy, and audit exact-once delivery.

JAX counterpart: ``fluidframework_tpu/chaos/multihost.py``; the port's copy,
imports rebased to this package.

``python -m fluidframework_tpu_torch.chaos.multihost --seed N`` runs a seeded
campaign against a real 2-host-group subprocess fleet
(service/topology.py ``multihost_spec``): ``h0`` is the placement host
(shard dir, storage tier, table door), ``h1`` runs in a DISJOINT
working dir with its core on ``RemoteTableClient`` — the lease/epoch
plane reached only over the ``admin_table_*`` door. Acts:

1. **The host kill.** ``Fleet.kill_host("h1")`` SIGKILLs h1's entire
   process group with the last submissions still in flight — a machine
   dying, not a process crashing. The placement host must not notice:
   its clients' in-flight traffic drains while h1 is dead (the blast
   radius is ONE host group).
2. **The crashed recovery.** Respawn h1 with the rehydration crash
   seam armed (``FLUID_CHAOS_BOOT_CRASH=K``): the respawned core dies
   with exit code 9 mid-boot-storm — a crash INSIDE the remote-table
   boot path is just another host start.
3. **The clean recovery.** Respawn again, seam disarmed. h1's clients
   reconnect, catch up through the door-routed boot path, and resubmit
   only the tokens the sequenced history does NOT already hold.

The verdict, per doc, through a fresh verifier client: every token
appears in the final text EXACTLY once — none lost by the host kill,
none doubled by tail replay. The campaign also asserts the lazy-boot
contract (``boot.part.full_replay == 0`` fleet-wide — the respawned
group boots O(snapshot+tail) THROUGH THE DOOR, never via a shared
file) and that the epoch table names exactly one owner per partition
after recovery (exactly one sequencer — the door's fence refused any
zombie write). Same seed ⇒ same token streams and kill points.
Exit 1 on violation.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time

from ..obs import tier_counters
from ..utils.telemetry import Counters
from .coldstart import TENANT, TTL, BOOT_CRASH_AFTER, TokenClient, _wait
from .monitor import InvariantViolation

#: the host group this campaign kills (the non-placement group)
VICTIM = "h1"


def run_campaign(seed: int, counters: Counters,
                 quick: bool = False) -> dict:
    from ..driver.network import _Transport
    from ..service.placement_plane import EpochTable
    from ..service.stage_runner import doc_partition
    from ..service.topology import Fleet, multihost_spec

    n_parts, n_hosts = 4, 2
    docs_per_host = 2 if quick else 4
    tokens_each = 6 if quick else 10
    work_dir = tempfile.mkdtemp(prefix="chaos-multihost-")
    fl = None
    try:
        spec = multihost_spec(os.path.join(work_dir, "fleet"),
                              n_hosts=n_hosts, cores_per_host=1,
                              n_partitions=n_parts, lease_ttl=TTL,
                              gateway_per_host=False,
                              summarize_every=1000,
                              boot_rate=50.0, boot_burst=2)
        host_parts = {h: set(spec.cores[h].prefer)
                      for h in range(n_hosts)}
        fl = Fleet(spec, subprocess=True, env={}).start()
        fl.wait_claimed()
        table = EpochTable.for_shard_dir(spec.shard_dir)

        def core_port_for(doc: str) -> int:
            part = doc_partition(TENANT, doc, n_parts)
            rec = table.read()["parts"][str(part)]
            return int(rec["addr"].rsplit(":", 1)[1])

        def reroute_and_connect(c: "TokenClient") -> None:
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    c.port = core_port_for(c.doc)
                    c.connect()
                    return
                except (RuntimeError, ConnectionError, KeyError) as e:
                    if time.monotonic() >= deadline:
                        raise
                    if isinstance(e, RuntimeError) \
                            and "not the owner" not in str(e) \
                            and "refused" not in str(e).lower():
                        raise
                    time.sleep(0.2)

        # doc names mined per host: the audit must know which docs died
        # with the victim and which never left the placement host
        def mine_docs(h: int, n: int) -> list:
            out, t = [], 0
            while len(out) < n:
                doc = f"mh{h}t{t}"
                t += 1
                if doc_partition(TENANT, doc, n_parts) in host_parts[h]:
                    out.append(doc)
            return out

        doc_sets = {h: mine_docs(h, docs_per_host)
                    for h in range(n_hosts)}
        clients = {h: [] for h in range(n_hosts)}
        for h in range(n_hosts):
            for i, doc in enumerate(doc_sets[h]):
                c = TokenClient(doc, core_port_for(doc),
                                random.Random(seed * 1000 + h * 100 + i))
                c.connect()
                clients[h].append(c)
        everyone = clients[0] + clients[1]

        # ---- seeded traffic, then summaries + checkpoints ----------
        for j in range(tokens_each - 2):
            for h in range(n_hosts):
                for i, c in enumerate(clients[h]):
                    c.insert(f"T{seed}h{h}d{i}n{j:03d}")
        if not _wait(lambda: all(c.drained() for c in everyone)):
            raise InvariantViolation("pre-kill traffic never drained")
        for c in everyone:
            t = _Transport("127.0.0.1", c.port)
            t.request_rid({"t": "admin_summarize", "tenant": TENANT,
                           "doc": c.doc})
            t.close()
        time.sleep(2.5)  # one checkpoint-ticker pass past the summary

        # ---- act 1: kill ONE host group, submissions in flight -----
        for j in range(tokens_each - 2, tokens_each):
            for h in range(n_hosts):
                for i, c in enumerate(clients[h]):
                    c.insert(f"T{seed}h{h}d{i}n{j:03d}")
        counters.inc("chaos.injected.host_kill")
        fl.kill_host(VICTIM)
        for c in clients[1]:
            c.abandon()
        # blast radius: the surviving host's in-flight traffic drains
        # while the victim is dead — the placement plane never blinked
        if not _wait(lambda: all(c.drained() for c in clients[0])):
            raise InvariantViolation(
                "the SURVIVING host's traffic stalled after a peer "
                "host group died — blast radius exceeded one host")

        # ---- act 2: respawn that crashes mid-rehydration -----------
        fl._env_cache = {**os.environ,
                         "FLUID_CHAOS_BOOT_CRASH": str(BOOT_CRASH_AFTER)}
        fl.start_host(VICTIM)
        fl.wait_claimed(parts=host_parts[1])
        crash_proc = fl.procs[1]
        # reconnecting clients ARE the boot storm; the seam kills the
        # respawned core after BOOT_CRASH_AFTER admitted boots
        for c in clients[1]:
            try:
                c.port = core_port_for(c.doc)
                c.connect()
            except Exception:  # noqa: BLE001 — core died mid-storm
                pass
        try:
            rc = crash_proc.wait(timeout=30)
        except Exception:
            rc = None
        if rc != 9:
            raise InvariantViolation(
                f"FLUID_CHAOS_BOOT_CRASH armed but the respawned core "
                f"exited {rc!r}, not 9 — the crash seam never fired "
                f"inside the remote-table boot path")
        counters.inc("chaos.injected.boot_crash")
        for c in clients[1]:
            c.abandon()
        fl.kill_host(VICTIM)  # reap the dead generation's bookkeeping

        # ---- act 3: the clean recovery -----------------------------
        fl._env_cache = dict(os.environ)
        fl.start_host(VICTIM)
        fl.wait_claimed(parts=host_parts[1])
        resubmitted = 0
        for c in clients[1]:
            reroute_and_connect(c)
            counters.inc("chaos.recovered.reconnect")
        if not _wait(lambda: all(c.drained() for c in clients[1])):
            raise InvariantViolation("post-respawn catch-up never "
                                     "drained")
        for c in clients[1]:
            n = c.resubmit_missing()
            resubmitted += n
            if n:
                counters.inc("chaos.recovered.resubmit", n)
        if not _wait(lambda: all(c.drained() for c in everyone)):
            raise InvariantViolation("resubmitted tokens never drained")

        # ---- the verdict: exact-once, through fresh verifiers ------
        losses, dupes = [], []
        for c in everyone:
            v = TokenClient(c.doc, core_port_for(c.doc),
                            random.Random(0))
            v.connect()
            ok = _wait(lambda: "default" in v.container.runtime.data_stores
                       and "text" in v.container.runtime.get_data_store(
                           "default").channels, 20)
            if not ok:
                raise InvariantViolation(
                    f"verifier for {c.doc} never booted")
            text = v.container.runtime.get_data_store(
                "default").get_channel("text").get_text()
            for t in c.tokens:
                n = text.count(t)
                if n == 0:
                    losses.append(t)
                elif n > 1:
                    dupes.append((t, n))
        if losses:
            raise InvariantViolation(
                f"{len(losses)} tokens LOST across the host-kill "
                f"cycles (first: {losses[0]})")
        if dupes:
            raise InvariantViolation(
                f"{len(dupes)} tokens DUPLICATED by tail replay "
                f"(first: {dupes[0]})")

        # ---- exactly one sequencer per partition -------------------
        rec = table.read()
        owners = {int(k): p["owner"] for k, p in rec["parts"].items()}
        if set(owners) != set(range(n_parts)):
            raise InvariantViolation(
                f"partitions unowned after recovery: {owners}")

        # ---- the lazy-boot contract, fleet-wide --------------------
        boot_counts: dict = {}
        for i, port in fl.core_ports.items():
            t = _Transport("127.0.0.1", port)
            _, reply = t.request_rid({"t": "admin_boot_status"})
            t.close()
            for k, v2 in reply["boot"]["counters"].items():
                boot_counts[k] = boot_counts.get(k, 0) + v2
        if boot_counts.get("boot.part.full_replay", 0) != 0:
            raise InvariantViolation(
                "a summarized + checkpointed doc whole-log replayed "
                f"through the remote-table boot path: {boot_counts}")
        if boot_counts.get("boot.part.lazy", 0) < docs_per_host:
            raise InvariantViolation(
                f"expected >= {docs_per_host} lazy boots on the "
                f"respawned host, saw {boot_counts}")

        return {
            "seed": seed,
            "quick": quick,
            "docs": 2 * docs_per_host,
            "tokens": 2 * docs_per_host * tokens_each,
            "resubmitted": resubmitted,
            "owners": {k: owners[k] for k in sorted(owners)},
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
        description="chaos host-kill campaign: kill -9 one host group "
                    "mid-traffic, respawn it from its spec copy, audit "
                    "exact-once delivery through the remote table door")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="fewer docs/tokens (CI smoke)")
    args = parser.parse_args(argv)
    counters = tier_counters("chaos")
    try:
        result = run_campaign(args.seed, counters, quick=args.quick)
    except InvariantViolation as e:
        print(f"HOST-KILL CAMPAIGN FAILED (seed {args.seed}): {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
