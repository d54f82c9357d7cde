"""Admin CLI: tenant CRUD + per-doc pipeline status over the admin RPCs.

JAX counterpart: ``fluidframework_tpu/admin.py``; the port's copy, every
subcommand kept, against the port's core (``service/front_end.py`` serves
the same ``admin_*`` frames). One difference: ``bundle`` captures no
``lint.json``. The JAX ``bundle`` runs ``python -m tools.fluidlint``,
whose passes lint the JAX package, so in the port it would report the
wrong build; the port's manifest says ``"lint": "not captured: fluidlint
lints fluidframework_tpu"`` instead, and the port's offline doctor
(``python -m fluidframework_tpu_torch.tools.doctor``) reads the missing
file as not captured.

Ref: server/admin (the reference's management portal) and riddler's
tenantManager REST (routerlicious/src/riddler/tenantManager.ts) — here
one CLI against the ordering core's admin frames (front_end.py
``_handle_admin``; gateways relay nothing admin — point this at a core).

    python -m fluidframework_tpu_torch.admin status TENANT DOC --port P
    python -m fluidframework_tpu_torch.admin docs --port P
    python -m fluidframework_tpu_torch.admin tenants --port P
    python -m fluidframework_tpu_torch.admin tenant-add ID SECRET --port P
    python -m fluidframework_tpu_torch.admin tenant-rm ID --port P
    python -m fluidframework_tpu_torch.admin monitor --port P [--interval S]
                                               [--count N]
    python -m fluidframework_tpu_torch.admin metrics --port P [--history]
                                               [--name METRIC]
    python -m fluidframework_tpu_torch.admin journal --port P [-n N]
        [--kind PREFIX] [--doc DOC] [--part K] [--fleet] [--chain ID]
    python -m fluidframework_tpu_torch.admin flight dump --port P [--reason R]
    python -m fluidframework_tpu_torch.admin bundle --out DIR --port P
    python -m fluidframework_tpu_torch.admin --port P slo
    python -m fluidframework_tpu_torch.admin placement --port P [--fleet]
    python -m fluidframework_tpu_torch.admin placement heat --port P
    python -m fluidframework_tpu_torch.admin placement boot --port P [--fleet]
    python -m fluidframework_tpu_torch.admin placement rebalance --port P
    python -m fluidframework_tpu_torch.admin placement drain CORE --port P
    python -m fluidframework_tpu_torch.admin migrate TENANT DOC TARGET --port P

``placement`` prints the core's view of the routing plane: the epoch
table (global epoch + per-partition owner/addr/epoch), the core
membership (active/draining/drained), the partitions this core serves,
the lease liveness view, and the ``placement.*`` counter snapshot
(``--fleet`` sums the counters across every reachable core).
``placement heat`` fans out to every member and prints the windowed
per-partition heat table the rebalancer plans from; ``placement boot``
shows a cold-starting core's rehydration progress — docs booted vs
still pending per owned partition, the admission executor's state
(rate/burst/tokens, parked boots) and the ``boot.*`` counters proving
the lazy contract (``--fleet`` fans out to every member and prints the
fleet totals: the operator's one-stop view mid boot storm); ``placement
rebalance`` shows the self-driving loop's status (last plan,
suppression counts, flap count); ``placement drain CORE`` marks a
member draining — the loop evacuates its partitions and flips it to
drained for clean decommission. ``migrate`` triggers a live migration
of the doc's partition to the core at TARGET (a ``host:port`` address
as published in the epoch table) — point it at the CURRENT owner.

``slo`` prints one row per armed SLO spec — windowed p99 vs budget,
state (ok/warn/violated), burn progress — plus whether SLO-burn
shedding is armed (front_end ``--slo`` / ``--no-shed``).

``journal`` tails the core's control-plane audit journal
(obs/journal.py): every epoch bump, lease transfer, migration phase,
rebalance decision (suppressions included), SLO transition and flight
dump, each entry causally linked to what triggered it. ``--fleet``
fans out to every registered core and merges the journals ordered by
(epoch, ts) — the epoch table is the fleet's shared logical clock, so
a cross-core migration reads as one connected chain even under
wall-clock skew. ``--chain ID`` prints just the causal chain ending at
the given entry id, root first. ``metrics --history`` prints the
windowed series' retained history rings (~15 min at 10 s resolution)
instead of the instantaneous scrape. ``flight dump`` forces a flight-
recorder dump now and journals it. ``bundle --out DIR`` snapshots the
whole debug surface — placement table, per-core scrape + history +
journal tail + SLO/rebalancer status, reachable flight dumps — into
DIR for the port's ``tools/doctor.py`` to triage offline.

``monitor`` is the service-monitor role (ref: server/service-monitor):
each tick it measures the front door's ping RTT (event-loop health) and
prints one line per live doc — seq, msn, connected clients, applier
lag (seq - applierSeq; "-" when no applier stage reports).

``--admin-secret`` must match the core's ``--admin-secret`` whenever one
is configured (and always on a tenancy-enforcing deployment).
"""

from __future__ import annotations

import argparse
import json
import sys

#: the manifest's ``lint`` entry: the port's bundle runs no fluidlint
LINT_NOT_CAPTURED = "not captured: fluidlint lints fluidframework_tpu"


def _request(args, frame: dict) -> dict:
    from .driver.network import _Transport

    t = _Transport(args.host, args.port, timeout=10.0)
    try:
        return t.request(_frame(args, frame))
    finally:
        t.close()


def _monitor(args) -> int:
    """The service-monitor role: ping RTT + per-doc pipeline lag, one
    block per tick on stdout (ref: server/service-monitor)."""
    import time

    from .driver.network import _Transport

    t = _Transport(args.host, args.port, timeout=10.0)
    try:
        tick = 0
        while True:
            tick += 1
            t0 = time.perf_counter()
            docs = t.request(_frame(args, {"t": "admin_docs"}))["docs"]
            rtt_ms = (time.perf_counter() - t0) * 1e3
            print(f"tick {tick} rtt {rtt_ms:.1f}ms docs {len(docs)}")
            for d in docs:
                tenant, _, doc = d.partition("/")
                st = t.request(_frame(args, {
                    "t": "admin_status", "tenant": tenant,
                    "doc": doc}))["status"]
                if st is None:
                    continue
                lag = ("-" if st["applierSeq"] is None
                       else st["seq"] - st["applierSeq"])
                print(f"  {d}: seq {st['seq']} msn {st['msn']} "
                      f"clients {len(st['clients'])} applier_lag {lag}")
            if args.count and tick >= args.count:
                return 0
            time.sleep(args.interval)
    finally:
        t.close()


def _frame(args, frame: dict) -> dict:
    if args.admin_secret:
        frame["secret"] = args.admin_secret
    return frame


def _peer_request(args, addr: str, frame: dict) -> dict:
    """One admin RPC against a peer core at ``addr`` (host:port from the
    epoch table's membership) — the CLI-side fan-out for `placement
    heat`, sharing the deployment-wide admin secret."""
    from .driver.network import _Transport

    host, _, port = addr.rpartition(":")
    t = _Transport(host or "127.0.0.1", int(port), timeout=10.0)
    try:
        return t.request(_frame(args, dict(frame)))
    finally:
        t.close()


def _placement(args) -> int:
    if args.action == "drain":
        if not args.core:
            print("drain requires a CORE owner id "
                  "(see `admin placement` membership)")
            return 1
        reply = _request(args, {"t": "admin_placement_drain",
                                "owner": args.core})
        print(f"core {reply['owner']} marked draining: the rebalancer "
              "evacuates its partitions, then flips it to drained")
        return 0
    if args.action == "rebalance":
        frame = {"t": "admin_rebalance_status"}
        if args.fleet:
            frame["fleet"] = True
        st = _request(args, frame)["rebalance"]
        if not st.get("armed"):
            print("rebalancer: disarmed (start the core with --rebalance)")
            return 1
        drain = (" DRAINED" if st.get("drained")
                 else " draining" if st.get("draining") else "")
        print(f"rebalancer: armed on {st['owner']}{drain}  "
              f"tick {st['tick_s']}s dwell {st['dwell_s']}s "
              f"budget {st['budget']} improvement {st['improvement']}")
        print(f"  flaps {st['flaps']}  last_error {st['last_error']}")
        plan = st.get("last_plan")
        if plan is not None:
            print(f"  last plan: {len(plan['moves'])} move(s)  "
                  f"spread {plan['spread_before']} -> "
                  f"{plan['spread_after']}  "
                  f"suppressed hysteresis={plan['suppressed_hysteresis']} "
                  f"budget={plan['suppressed_budget']}")
            for m in plan["moves"]:
                print(f"    part {m['k']}: {m['src']} -> {m['dst']} "
                      f"(load {m['load']})")
        for h in st.get("history", []):
            print(f"  moved part {h['k']}: {h['src']} -> {h['dst']}")
        for name, v in sorted(st.get("fleet_counters", {}).items()):
            print(f"  {name} {v}")
        return 0
    if args.action == "boot":
        return _placement_boot(args)
    frame = {"t": "admin_placement"}
    if args.fleet:
        frame["fleet"] = True
    reply = _request(args, frame)
    pl = reply.get("placement")
    if pl is None:
        print("not a sharded core (no placement plane)")
        return 1
    if args.action == "heat":
        # per-core fan-out: every registered member answers for its own
        # windowed series (heat lives in each core's process registry)
        for owner, row in sorted(pl.get("cores", {}).items()):
            try:
                heat = _peer_request(args, row["addr"],
                                     {"t": "admin_core_heat"})["heat"]
            except (OSError, ValueError, RuntimeError) as e:
                print(f"core {owner} @ {row['addr']} [{row['state']}] "
                      f"unreachable: {e}")
                continue
            total = sum(h["ops"] for h in heat["parts"].values())
            drain = " (draining)" if heat["draining"] else ""
            print(f"core {owner} @ {row['addr']} [{row['state']}]"
                  f"{drain}  total {total:.1f} ops/s "
                  f"(window {heat['window_s']}s)")
            for k in sorted(heat["parts"], key=int):
                h = heat["parts"][k]
                print(f"  part {k}: {h['ops']:.1f} ops/s  "
                      f"{h['bytes']:.0f} B/s")
        return 0
    print(f"core {pl['owner']} @ {pl['address']}  "
          f"epoch {pl['epoch']}  owns {pl['owned']}")
    for owner, row in sorted(pl.get("cores", {}).items()):
        print(f"  core {owner} @ {row['addr']} [{row['state']}]")
    for k in sorted(pl["parts"], key=int):
        part = pl["parts"][k]
        print(f"  part {k}: {part['owner']} @ {part['addr']} "
              f"(epoch {part['epoch']})")
    for k, row in sorted(pl["leases"].items()):
        print(f"  lease {k}: {row}")
    for name, v in sorted(pl["counters"].items()):
        print(f"  {name} {v}")
    return 0


def _boot_row(owner: str, addr: str, boot: dict) -> tuple:
    """Print one core's rehydration progress; returns its (booted,
    pending, counters) contribution to the fleet totals."""
    ex = boot.get("executor") or {}
    booted = sum(p["docs_booted"] for p in boot.get("parts", []))
    pending = sum(p["docs_pending"] for p in boot.get("parts", []))
    print(f"core {boot.get('owner', owner)} @ {addr}  "
          f"booted {booted} pending {pending}  "
          f"executor rate {ex.get('rate')}/s burst {ex.get('burst')} "
          f"tokens {ex.get('tokens')} parked {ex.get('parked', 0)}")
    for part in boot.get("parts", []):
        print(f"  part {part['part']}: booted {part['docs_booted']} "
              f"pending {part['docs_pending']}")
    for name, v in sorted((boot.get("counters") or {}).items()):
        print(f"  {name} {v}")
    return booted, pending, boot.get("counters") or {}


def _placement_boot(args) -> int:
    """Rehydration progress (``placement boot``): how far a cold core
    is through its boot storm — per-partition booted/pending docs, the
    admission executor's bucket, and the ``boot.*`` counters. With
    ``--fleet``, fans out to every member and sums."""
    if not args.fleet:
        reply = _request(args, {"t": "admin_boot_status"})
        boot = reply.get("boot")
        if boot is None:
            print("not a sharded core (no boot plane)")
            return 1
        _boot_row("local", f"{args.host}:{args.port}", boot)
        return 0
    totals: dict = {}
    booted = pending = reached = 0
    for owner, addr in _fleet_cores(args).items():
        try:
            boot = _peer_request(
                args, addr, {"t": "admin_boot_status"})["boot"]
        except (OSError, ValueError, RuntimeError) as e:
            print(f"core {owner} @ {addr} unreachable: {e}")
            continue
        b, p, counters = _boot_row(owner, addr, boot)
        booted += b
        pending += p
        reached += 1
        for name, v in counters.items():
            totals[name] = totals.get(name, 0) + v
    print(f"fleet: {reached} core(s)  booted {booted} pending {pending}")
    for name, v in sorted(totals.items()):
        print(f"  {name} {v}")
    if totals.get("boot.part.full_replay", 0):
        print("WARNING: boot.part.full_replay nonzero — some doc paid "
              "a whole-log replay (missing summary or checkpoint?)")
        return 1
    return 0


def _fmt_entry(e: dict) -> str:
    import datetime

    try:
        ts = datetime.datetime.fromtimestamp(
            e.get("ts", 0)).strftime("%H:%M:%S.%f")[:-3]
    except (OverflowError, OSError, ValueError):
        ts = str(e.get("ts"))
    labels = " ".join(f"{k}={v}" for k, v in
                      sorted((e.get("labels") or {}).items()))
    cause = f" <- {e['cause']}" if e.get("cause") else ""
    epoch = e.get("epoch")
    return (f"{ts} e{epoch if epoch is not None else '-'} "
            f"[{e.get('id')}] {e.get('kind')}{cause}  {labels}")


def _journal_frame(args) -> dict:
    frame = {"t": "admin_journal", "n": args.n}
    if args.kind:
        frame["kind"] = args.kind
    if args.doc:
        frame["doc"] = args.doc
    if args.part is not None:
        frame["part"] = args.part
    return frame


def _fleet_cores(args) -> dict:
    """owner → addr for every registered member (falls back to the
    queried core alone on an unsharded deployment). Every member is
    captured — an ex-owner's journal is exactly what a migration
    post-mortem needs — but the BUNDLE marks members holding no
    partition as unrouted so the doctor's reachability rules skip
    them (membership rows never expire; a kill -9'd core's stale row
    must not read as an outage after its parts were re-claimed)."""
    pl = _request(args, {"t": "admin_placement"}).get("placement")
    if pl is None or not pl.get("cores"):
        return {"local": f"{args.host}:{args.port}"}
    return {owner: row["addr"]
            for owner, row in sorted(pl["cores"].items())}


def _journal_cmd(args) -> int:
    from .obs.journal import causal_chain, merge_entries

    if args.fleet:
        per_core = []
        for owner, addr in _fleet_cores(args).items():
            try:
                j = _peer_request(args, addr, _journal_frame(args))[
                    "journal"]
            except (OSError, ValueError, RuntimeError) as e:
                print(f"# core {owner} @ {addr} unreachable: {e}")
                continue
            per_core.append(j["entries"])
        entries = merge_entries(per_core)
    else:
        j = _request(args, _journal_frame(args))["journal"]
        if not j["armed"] and not j["entries"]:
            print("journal: disarmed on this core (sharded cores arm "
                  "automatically; single cores need --journal PATH)")
            return 1
        entries = j["entries"]
    if args.chain:
        entries = causal_chain(entries, args.chain)
        if not entries:
            print(f"no entry {args.chain!r} in the fetched window "
                  "(raise -n or check the id)")
            return 1
    for e in entries:
        print(_fmt_entry(e))
    return 0


def _metrics_history(args) -> int:
    reply = _request(args, {"t": "admin_metrics_history",
                            "name": args.name})
    # points carry the CORE's monotonic clock; rebase onto wall time
    # through the paired now stamps the RPC ships
    offset = reply["now_wall"] - reply["now_mono"]
    import datetime

    for name, series in sorted(reply["history"].items()):
        for s in series:
            labels = ",".join(f"{k}={v}" for k, v in
                              sorted(s["labels"].items()))
            print(f"{name}{{{labels}}}")
            for pt in s["points"]:
                wall = pt["t"] + offset
                hhmm = datetime.datetime.fromtimestamp(
                    wall).strftime("%H:%M:%S")
                mean = pt["sum"] / pt["count"] if pt["count"] else 0.0
                print(f"  {hhmm} count {pt['count']} "
                      f"mean {mean:.3f} max {pt['max']:.3f}")
    return 0


def _bundle(args) -> int:
    """Snapshot the fleet's debug surface into ``--out`` (the operator
    door the port's ``tools/doctor.py`` triages from)."""
    import os
    import shutil
    import time

    out = args.out
    os.makedirs(out, exist_ok=True)
    manifest: dict = {"created": time.time(),
                      "entry": f"{args.host}:{args.port}", "cores": {}}
    pl = _request(args, {"t": "admin_placement"}).get("placement")
    if pl is not None:
        with open(os.path.join(out, "placement.json"), "w") as f:
            json.dump(pl, f, indent=2, default=str)
    routed = {p.get("owner")
              for p in ((pl or {}).get("parts") or {}).values()}
    cores = _fleet_cores(args)
    for owner, addr in cores.items():
        cdir = os.path.join(out, "cores", owner)
        os.makedirs(cdir, exist_ok=True)
        row: dict = {"addr": addr}
        if pl is not None and owner not in routed:
            # owns no partition at capture time: journals still matter
            # (migration chains live on ex-owners), but a failed
            # capture of a stale membership row is not an outage
            row["routed"] = False
        manifest["cores"][owner] = row
        try:
            scrape = _peer_request(
                args, addr, {"t": "admin_metrics_scrape"})["scrape"]
            with open(os.path.join(cdir, "scrape.prom"), "w") as f:
                f.write(scrape)
            counters = _peer_request(
                args, addr, {"t": "admin_counters"})["counters"]
            with open(os.path.join(cdir, "counters.json"), "w") as f:
                json.dump(counters, f, indent=2, default=str)
            hist = _peer_request(args, addr,
                                 {"t": "admin_metrics_history"})
            with open(os.path.join(cdir, "history.json"), "w") as f:
                json.dump(hist, f, default=str)
            slo = _peer_request(args, addr, {"t": "admin_slo_status"})
            with open(os.path.join(cdir, "slo.json"), "w") as f:
                json.dump({"slos": slo.get("slos", []),
                           "shedding": slo.get("shedding")}, f, indent=2)
            reb = _peer_request(
                args, addr,
                {"t": "admin_rebalance_status"})["rebalance"]
            with open(os.path.join(cdir, "rebalance.json"), "w") as f:
                json.dump(reb, f, indent=2, default=str)
            boot = _peer_request(
                args, addr, {"t": "admin_boot_status"}).get("boot")
            if boot is not None:
                with open(os.path.join(cdir, "boot.json"), "w") as f:
                    json.dump(boot, f, indent=2, default=str)
            j = _peer_request(args, addr, {"t": "admin_journal",
                                           "n": 1000})["journal"]
            row["journal_armed"] = j["armed"]
            with open(os.path.join(cdir, "journal.jsonl"), "w") as f:
                for e in j["entries"]:
                    f.write(json.dumps(e, separators=(",", ":"),
                                       default=str) + "\n")
            # flight dumps the journal references, when their paths are
            # readable from here (same-host deployments — the common
            # debug case; remote cores just keep the path breadcrumbs)
            copied = 0
            for e in j["entries"]:
                if e.get("kind") != "flight.dump":
                    continue
                path = (e.get("labels") or {}).get("path")
                if path and os.path.isfile(path):
                    fdir = os.path.join(cdir, "flight")
                    os.makedirs(fdir, exist_ok=True)
                    try:
                        shutil.copy(path, fdir)
                        copied += 1
                    except OSError:
                        pass
            row["flight_dumps_copied"] = copied
        except (OSError, ValueError, RuntimeError) as e:
            row["error"] = str(e)
            print(f"# core {owner} @ {addr} partially captured: {e}")
    # no static-contract capture: fluidlint's passes lint the JAX
    # package, not this build (the doctor reads a missing lint.json as
    # "not captured")
    manifest["lint"] = LINT_NOT_CAPTURED
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"bundle written to {out} ({len(cores)} core(s)); triage "
          f"with: python -m fluidframework_tpu_torch.tools.doctor {out}")
    return 0


def _history_cmd(args) -> int:
    """Doc history plane views/actions over the ``history_*`` doors.
    These ride the tenant token (doc scopes), not the admin secret —
    forking or time-traveling a doc is a data-plane act."""
    from .driver.network import _Transport

    t = _Transport(args.host, args.port, timeout=30.0)
    try:
        base = {"tenant": args.tenant, "doc": args.doc,
                "token": args.token}
        if args.action == "log":
            rid, reply = t.request_rid(dict(
                base, t="history_log", count=args.n or None))
            commits = t.take_history(rid)
            heads = {cid: name for name, cid in
                     (reply.get("refs") or {}).items()}
            for c in commits:
                head = heads.get(c["id"])
                fork_of = (c.get("extra") or {}).get("fork_of")
                line = (f"{c['id']} {c['version']} @seq {c['base_seq']} "
                        f"chunks {len(c['chunk_ids'])}")
                if head:
                    line += f" [{head}]"
                if fork_of:
                    line += f" fork-of {fork_of['doc']}@{fork_of['seq']}"
                print(line)
            return 0
        if args.action == "at":
            if args.seq is None:
                print("history at requires --seq", file=sys.stderr)
                return 2
            at = t.request(dict(base, t="history_at",
                                seq=args.seq))["at"]
            print(json.dumps(at, indent=2))
            return 0
        if args.action == "fork":
            res = t.request(dict(base, t="history_fork", seq=args.seq,
                                 new_doc=args.new_doc))["fork"]
            print(f"forked {args.tenant}/{args.doc}@{res['fork_seq']} "
                  f"-> {res['doc']} (base {res['version']} seq "
                  f"{res['base_seq']}, {res['shared_chunks']} shared "
                  f"chunk(s), {res['tail_ops']} tail op(s))")
            return 0
        # integrate: args.doc IS the fork
        res = t.request(dict(base, t="history_integrate"))["integrate"]
        print(f"integrated {res['ops']} op(s) from {res['fork']} "
              f"into {res['parent']}")
        return 0
    finally:
        t.close()


def _print_core_health(h: dict, indent: str = "") -> None:
    comps = h.get("components") or {}
    doors = ((h.get("probes") or {}).get("doors") or {})
    armed = h.get("armed", True)
    print(f"{indent}core {h.get('core') or '?'}: "
          f"{str(h.get('verdict', 'unknown')).upper()}"
          + ("" if armed else "  (health plane unarmed)"))
    for name, c in sorted(comps.items()):
        state = c.get("state", "?")
        mark = {"ok": " ", "degraded": "~",
                "critical": "!"}.get(state, "?")
        line = f"{indent}  {mark} {name:<10} {state}"
        if c.get("streak"):
            line += f"  (streak {c['streak']})"
        print(line)
        for reason in c.get("reasons", []):
            print(f"{indent}      - {reason}")
    if doors:
        print(f"{indent}  doors: " + "  ".join(
            f"{d}={v.get('last_ms', 0):.1f}ms"
            + ("" if v.get("ok")
               else f"[FAIL x{v.get('consec_failures')}]")
            for d, v in sorted(doors.items())))
    for r in h.get("slo_burn") or []:
        print(f"{indent}  burn: {r.get('slo')} [{r.get('state')}] "
              f"p99 {r.get('p99_ms')}ms / {r.get('budget_ms')}ms")
    for reason in h.get("reasons") or []:
        # synthetic row for an unreachable peer (no components)
        print(f"{indent}  - {reason}")


def _health_cmd(args) -> int:
    """`admin health [--fleet]`: the live go/no-go verdict. Exit 0
    only on OK — CI and the rolling-upgrade loop gate on the code, the
    way the doctor gates on a quiet bundle."""
    frame = {"t": "admin_health"}
    if args.fleet:
        frame["fleet"] = 1
    reply = _request(args, frame)
    h = reply.get("health") or {}
    if args.fleet:
        verdict = str(h.get("verdict", "unknown"))
        cores = h.get("cores") or {}
        print(f"fleet: {verdict.upper()}  ({len(cores)} core(s))")
        for _owner, core_h in sorted(cores.items()):
            _print_core_health(core_h, indent="  ")
        return 0 if verdict == "ok" else 1
    _print_core_health(h)
    return 0 if h.get("verdict") == "ok" else 1


def main(argv=None) -> int:
    # the connection options are accepted before OR after the
    # subcommand (`admin --port P slo` and `admin slo --port P` both
    # work): the sub-level copies default to SUPPRESS so they override
    # the main-level values only when actually given
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--host", default=argparse.SUPPRESS)
    common.add_argument("--port", type=int, default=argparse.SUPPRESS)
    common.add_argument("--admin-secret", default=argparse.SUPPRESS)
    p = argparse.ArgumentParser(description="fluid service admin")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--admin-secret", default=None)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("status", help="one doc's pipeline status",
                       parents=[common])
    s.add_argument("tenant")
    s.add_argument("doc")
    sub.add_parser("docs", help="list live docs", parents=[common])
    sub.add_parser("tenants", help="list registered tenants",
                   parents=[common])
    s = sub.add_parser("tenant-add", help="register a tenant",
                       parents=[common])
    s.add_argument("id")
    s.add_argument("secret")
    s = sub.add_parser("tenant-rm", help="deregister a tenant",
                       parents=[common])
    s.add_argument("id")
    s = sub.add_parser("monitor", help="live per-doc status ticker",
                       parents=[common])
    s.add_argument("--interval", type=float, default=2.0)
    s.add_argument("--count", type=int, default=0,
                   help="ticks before exiting (0 = forever)")
    s = sub.add_parser("metrics", parents=[common],
                       help="Prometheus text scrape of the core's "
                            "registry (--history: retained windowed "
                            "series rings instead)")
    s.add_argument("--history", action="store_true",
                   help="print the ~15 min windowed-series history "
                        "rings instead of the instantaneous scrape")
    s.add_argument("--name", default=None,
                   help="restrict --history to one windowed metric")
    s = sub.add_parser("journal", parents=[common],
                       help="tail the control-plane audit journal "
                            "(epoch bumps, leases, migrations, "
                            "rebalance decisions, SLO transitions)")
    s.add_argument("-n", type=int, default=100,
                   help="entries per core (default 100)")
    s.add_argument("--kind", default=None,
                   help="kind prefix filter (e.g. migration.)")
    s.add_argument("--doc", default=None, help="doc label filter")
    s.add_argument("--part", type=int, default=None,
                   help="partition label filter")
    s.add_argument("--fleet", action="store_true",
                   help="merge every core's journal ordered by "
                        "(epoch, ts)")
    s.add_argument("--chain", default=None, metavar="ID",
                   help="print the causal chain ending at entry ID, "
                        "root first")
    s = sub.add_parser("flight", parents=[common],
                       help="flight recorder controls: `flight dump` "
                            "forces a dump now and journals it")
    s.add_argument("action", choices=["dump"])
    s.add_argument("--reason", default=None,
                   help="free-text reason recorded in the journal")
    s = sub.add_parser("bundle", parents=[common],
                       help="capture a fleet debug bundle (placement, "
                            "scrapes, history, journals, SLO status, "
                            "flight dumps) into --out")
    s.add_argument("--out", required=True, metavar="DIR")
    sub.add_parser("slo", parents=[common],
                   help="armed SLO specs: windowed p99 vs "
                        "budget, state, burn progress")
    s = sub.add_parser("health", parents=[common],
                       help="live health plane: the streaming "
                            "doctor's verdict — canary probe doors, "
                            "per-component states with reasons; exit "
                            "0 only when OK (the go/no-go gate)")
    s.add_argument("--fleet", action="store_true",
                   help="fan out to every core in the epoch table; "
                        "worst verdict wins and an unreachable core "
                        "is critical")
    s = sub.add_parser("placement", parents=[common],
                       help="routing plane: epoch table, membership, "
                            "owned partitions, leases, placement.* "
                            "counters; subviews: heat / rebalance / "
                            "drain CORE")
    s.add_argument("action", nargs="?", default=None,
                   choices=["heat", "rebalance", "drain", "boot"],
                   help="heat: per-core per-partition heat table; "
                        "boot: cold-start rehydration progress "
                        "(booted/pending docs, executor, boot.* "
                        "counters; --fleet sums every core); "
                        "rebalance: loop status + last plan; "
                        "drain: mark CORE draining (evacuate + "
                        "decommission)")
    s.add_argument("core", nargs="?", default=None,
                   help="core owner id (drain only)")
    s.add_argument("--fleet", action="store_true",
                   help="sum placement counters across every reachable "
                        "core instead of just the queried one")
    s = sub.add_parser("history", parents=[common],
                       help="doc history plane: commit log, fork a doc "
                            "at a seq, resolve a point-in-time read, "
                            "integrate a fork back into its parent")
    s.add_argument("action", choices=["log", "fork", "at", "integrate"])
    s.add_argument("tenant")
    s.add_argument("doc", help="the doc (for integrate: the FORK doc)")
    s.add_argument("--seq", type=int, default=None,
                   help="fork/read-at sequence number (fork default: "
                        "head)")
    s.add_argument("--new-doc", default=None,
                   help="fork target doc id (default: generated)")
    s.add_argument("-n", type=int, default=20,
                   help="commits to list (log; 0 = all)")
    s.add_argument("--token", default=None,
                   help="tenant JWT when tenancy is enforcing")
    s = sub.add_parser("migrate", parents=[common],
                       help="live-migrate a doc's partition to another "
                            "core (point --port at the current owner)")
    s.add_argument("tenant")
    s.add_argument("doc")
    s.add_argument("target", help="target core address (host:port)")
    args = p.parse_args(argv)
    if args.port is None:
        p.error("--port is required")

    if args.cmd == "monitor":
        return _monitor(args)

    if args.cmd == "status":
        reply = _request(args, {"t": "admin_status", "tenant": args.tenant,
                                "doc": args.doc})
        if reply.get("status") is None:
            print(f"no live pipeline for {args.tenant}/{args.doc}")
            return 1
        print(json.dumps(reply["status"], indent=2))
    elif args.cmd == "metrics":
        if args.history:
            return _metrics_history(args)
        reply = _request(args, {"t": "admin_metrics_scrape"})
        sys.stdout.write(reply["scrape"])
    elif args.cmd == "journal":
        return _journal_cmd(args)
    elif args.cmd == "flight":
        reply = _request(args, {"t": "admin_flight_dump",
                                "reason": args.reason})
        print(f"dumped {reply['path']} (journal {reply['journal']})")
    elif args.cmd == "bundle":
        return _bundle(args)
    elif args.cmd == "slo":
        reply = _request(args, {"t": "admin_slo_status"})
        shed = "armed" if reply.get("shedding") else "off"
        rows = reply.get("slos", [])
        print(f"shedding: {shed}  specs: {len(rows)}")
        for r in rows:
            scope = r["pair"] + (f"@{r['tenant']}" if r["tenant"] else "")
            print(f"  {r['slo']}: {scope} p99 {r['p99_ms']}ms / "
                  f"budget {r['budget_ms']}ms [{r['state']}] "
                  f"burn {r['burn']}/{r['burn_ticks']} "
                  f"n={r['count']} window {r['window_s']}s")
    elif args.cmd == "health":
        return _health_cmd(args)
    elif args.cmd == "docs":
        reply = _request(args, {"t": "admin_docs"})
        for d in reply["docs"]:
            print(d)
    elif args.cmd == "placement":
        return _placement(args)
    elif args.cmd == "history":
        return _history_cmd(args)
    elif args.cmd == "migrate":
        reply = _request(args, {"t": "admin_migrate_doc",
                                "tenant": args.tenant, "doc": args.doc,
                                "target": args.target})
        fences = reply["fences"]
        if isinstance(fences, dict):
            fences = sum(fences.values())
        print(f"migrated partition {reply['k']} -> {reply['target']} "
              f"(epoch {reply['epoch']}, {fences} submit(s) fenced)")
    elif args.cmd == "tenants":
        reply = _request(args, {"t": "admin_tenants"})
        for tenant in reply["tenants"]:
            print(tenant)
    elif args.cmd == "tenant-add":
        _request(args, {"t": "admin_tenant_add", "id": args.id,
                        "tenant_secret": args.secret})
        print(f"registered {args.id}")
    elif args.cmd == "tenant-rm":
        reply = _request(args, {"t": "admin_tenant_remove",
                                "id": args.id})
        if not reply.get("ok"):
            print(f"unknown tenant {args.id}")
            return 1
        print(f"removed {args.id}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
