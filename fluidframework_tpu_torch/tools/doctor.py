"""Bundle triage: read an ``admin bundle`` directory and print what an
on-call operator needs first.

    python -m fluidframework_tpu_torch.tools.doctor BUNDLE_DIR

JAX counterpart: the repo's ``tools/doctor.py``; the port's copy, over
the port's own ``obs/doctor_rules.py`` and ``obs/journal.py`` (no
``sys.path`` reach into the repo's ``tools/``). The port's ``admin
bundle`` captures no ``lint.json`` (its manifest says why), so the
static-contract section reads "not captured".

The bundle (the port's ``admin.py`` ``bundle --out DIR``) holds the
fleet's debug surface frozen at capture time: ``placement.json`` (epoch
table + membership), and per core under ``cores/<owner>/`` the metrics
scrape (``scrape.prom``), windowed history rings (``history.json``),
journal tail (``journal.jsonl``), SLO status (``slo.json``), rebalancer
status (``rebalance.json``) and any flight dumps that were readable at
capture (``flight/``); plus ``lint.json`` — the capturing build's
``fluidlint --json`` report — whenever the repo checkout was present.
The doctor joins these into a triage report:

1. fleet summary — cores, states, capture errors;
2. hop-pair latency table — the slowest legs of the pipeline by mean,
   from each core's scrape (where the tail latency actually lives:
   relay depth, shed parking, device dispatch);
3. SLO burn — specs not in ``ok``, with their windowed p99 vs budget;
4. recent migrations — each commit/fail with its CAUSAL CHAIN walked
   root-first through the merged fleet journal (operator command or
   rebalance plan → seal → fence → checkpoint → adopt → epoch bump);
5. anomalies — orphaned partitions (owner not in the membership),
   draining/drained cores still owning partitions, migration failures,
   rebalance suppression storms, version-skew hop drops
   (``obs.trace.unknown_hops``), disarmed journals, journal write
   errors, cold-start regressions from ``boot.json`` (a doc that paid
   a whole-log replay, or parked boots idling against a refilled
   admission bucket — the storm stalled), static-contract
   violations in the capturing build (a dirty ``lint.json`` in
   production is an incident signal of its own — someone deployed past
   the gate), wedged migrations (a ``migration.fence`` with no
   commit/fail while the journal kept moving — the partition sealed
   with nobody coming to adopt it), and the multi-host trio: an UNREACHABLE HOST GROUP
   (every core a host id advertises failed capture — a machine down,
   not a core restarting), a CROSS-HOST EPOCH REGRESSION (a later
   ``epoch.bump`` with a lower epoch for the same partition — two
   cores wrote the table through different planes), and remote-table
   writes rejected by the door's fence
   (``placement.table.stale_rejections`` in a scrape — a zombie
   ex-owner kept writing after takeover).

Read-only; exit 0 with "healthy" when nothing needs attention, exit 1
when any anomaly or active SLO burn was found (so a CI gate can assert
a bundle is quiet — or assert it ISN'T after a forced incident).

The anomaly rules themselves live in the port's ``obs/doctor_rules.py``,
shared verbatim with the in-process streaming doctor (``obs/health.py``)
— the live verdict and the post-incident bundle verdict run the SAME
code, never a re-derivation.
"""

from __future__ import annotations

import json
import os
import re
import sys

from ..obs import doctor_rules as rules
from ..obs.doctor_rules import (  # noqa: F401  (re-exported names)
    STORM_THRESHOLD,
    scrape_counter as _scrape_counter,
)
from ..obs.journal import causal_chain, merge_entries

#: scrape lines for the hop summaries: fluid_obs_hop_ms_count{...} N
_SCRAPE_RE = re.compile(
    r'^fluid_obs_hop_ms_(count|sum)\{([^}]*)\}\s+([0-9.eE+-]+)')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_journal(path) -> list:
    out = []
    try:
        f = open(path)
    except OSError:
        return out
    with f:
        for line in f:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if isinstance(e, dict) and "kind" in e:
                out.append(e)
    return out


def _hop_table(scrape_text: str) -> dict:
    """pair → (count, sum_ms) from one core's Prometheus scrape."""
    acc: dict = {}
    for line in scrape_text.splitlines():
        m = _SCRAPE_RE.match(line)
        if m is None:
            continue
        stat, labels_s, val = m.group(1), m.group(2), float(m.group(3))
        labels = dict(_LABEL_RE.findall(labels_s))
        pair = labels.get("pair")
        if pair is None:
            continue
        count, total = acc.get(pair, (0.0, 0.0))
        if stat == "count":
            count += val
        else:
            total += val
        acc[pair] = (count, total)
    return acc


def _fmt_entry(e: dict) -> str:
    labels = " ".join(f"{k}={v}" for k, v in
                      sorted((e.get("labels") or {}).items()))
    epoch = e.get("epoch")
    return (f"e{epoch if epoch is not None else '-'} "
            f"[{e.get('id')}] {e.get('kind')}  {labels}")


def diagnose(bundle_dir: str) -> dict:
    """Parse the bundle into a triage dict (the printable report's
    data source — tests and the net_smoke gate assert on this)."""
    report: dict = {"cores": {}, "hop_pairs": [], "slo_burn": [],
                    "migrations": [], "anomalies": [], "lint": None}
    anomalies = report["anomalies"]
    manifest = _load_json(os.path.join(bundle_dir, "manifest.json")) or {}
    # static-contract status of the build that captured the bundle
    # (admin bundle runs `fluidlint --json` when the repo is present):
    # a dirty tree in production is itself an incident signal
    lint = _load_json(os.path.join(bundle_dir, "lint.json"))
    report["lint"] = lint
    anomalies.extend(rules.lint_anomalies(lint))
    placement = _load_json(os.path.join(bundle_dir, "placement.json"))
    cores_dir = os.path.join(bundle_dir, "cores")
    owners = (sorted(os.listdir(cores_dir))
              if os.path.isdir(cores_dir) else [])

    hop_acc: dict = {}
    per_core_journals = []
    for owner in owners:
        cdir = os.path.join(cores_dir, owner)
        row = dict(manifest.get("cores", {}).get(owner, {}))
        report["cores"][owner] = row
        anomalies.extend(rules.capture_error_anomalies(owner, row))
        scrape_path = os.path.join(cdir, "scrape.prom")
        try:
            with open(scrape_path) as f:
                scrape = f.read()
        except OSError:
            scrape = ""
        for pair, (count, total) in _hop_table(scrape).items():
            c, t = hop_acc.get(pair, (0.0, 0.0))
            hop_acc[pair] = (c + count, t + total)
        anomalies.extend(rules.scrape_anomalies(owner, scrape))
        journal = _load_journal(os.path.join(cdir, "journal.jsonl"))
        per_core_journals.append(journal)
        anomalies.extend(
            rules.journal_disarmed_anomalies(owner, row, journal))
        err = sum(1 for e in journal if e.get("kind") == "core.recover")
        if err:
            row["recoveries"] = err
        slo = _load_json(os.path.join(cdir, "slo.json")) or {}
        report["slo_burn"].extend(rules.slo_burn_rows(owner, slo))
        # cold-start surface: rehydration progress at capture time
        boot = _load_json(os.path.join(cdir, "boot.json"))
        if boot is not None:
            ex = boot.get("executor") or {}
            booted = sum(p.get("docs_booted", 0)
                         for p in boot.get("parts", []))
            pending = sum(p.get("docs_pending", 0)
                          for p in boot.get("parts", []))
            row["boot"] = {"booted": booted, "pending": pending,
                           "parked": ex.get("parked", 0)}
            anomalies.extend(rules.boot_anomalies(owner, boot))
        anomalies.extend(
            rules.suppression_storm_anomalies(owner, journal))

    report["hop_pairs"] = sorted(
        ((pair, count, total / count if count else 0.0, total)
         for pair, (count, total) in hop_acc.items()),
        key=lambda r: -r[3])

    merged = merge_entries(per_core_journals)
    report["journal_merged"] = merged
    # cross-host epoch regressions, then wedged migrations (a fence
    # with no commit/fail while the journal kept moving) — both over
    # the wall-clock-merged fleet journal
    anomalies.extend(rules.epoch_regression_anomalies(merged))
    anomalies.extend(rules.fence_without_commit_anomalies(merged))
    for e in merged:
        if e.get("kind") in ("migration.commit", "migration.fail"):
            report["migrations"].append(
                {"entry": e, "chain": causal_chain(merged, e["id"])})
            if e["kind"] == "migration.fail":
                anomalies.append(rules.migration_fail_anomaly(e))
    report["migrations"] = report["migrations"][-5:]

    anomalies.extend(
        rules.placement_anomalies(placement, report["cores"]))
    return report


def print_report(report: dict) -> None:
    print("== fleet ==")
    for owner, row in sorted(report["cores"].items()):
        extra = ""
        if row.get("recoveries"):
            extra += f"  recoveries={row['recoveries']}"
        if row.get("boot"):
            b = row["boot"]
            extra += (f"  boot={b['booted']}/"
                      f"{b['booted'] + b['pending']}")
        if row.get("error"):
            extra += "  CAPTURE-ERROR"
        print(f"  core {owner} @ {row.get('addr', '?')}"
              f"  journal={'armed' if row.get('journal_armed') else 'off'}"
              f"{extra}")
    print("\n== slowest hop pairs (fleet, by total ms) ==")
    if not report["hop_pairs"]:
        print("  (no hop observations in any scrape)")
    for pair, count, mean, total in report["hop_pairs"][:8]:
        print(f"  {pair:<22} n={int(count):<8} mean {mean:8.3f} ms  "
              f"total {total:10.1f} ms")
    print("\n== SLO burn ==")
    if not report["slo_burn"]:
        print("  all specs ok")
    for r in report["slo_burn"]:
        print(f"  [{r['state'].upper()}] {r['slo']} on {r['core']}: "
              f"p99 {r['p99_ms']}ms / budget {r['budget_ms']}ms "
              f"(burn {r['burn']}/{r['burn_ticks']})")
    print("\n== recent migrations (causal chains, root first) ==")
    if not report["migrations"]:
        print("  none in the journal window")
    for m in report["migrations"]:
        print(f"  {_fmt_entry(m['entry'])}")
        for link in m["chain"]:
            print(f"    {_fmt_entry(link)}")
    print("\n== static contracts (capturing build) ==")
    lint = report.get("lint")
    if lint is None:
        print("  (no lint.json in bundle — not captured)")
    elif lint.get("clean"):
        waived = lint.get("waived", [])
        print(f"  clean ({len(lint.get('passes', []))} passes"
              f", {len(waived)} waived concurrency finding(s))")
    else:
        print(f"  DIRTY: {len(lint.get('violations', []))} "
              "violation(s) — see anomalies")
    print("\n== anomalies ==")
    if not report["anomalies"]:
        print("  none — healthy")
    for a in report["anomalies"]:
        print(f"  ! {a}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 2
    bundle_dir = argv[0]
    if not os.path.isdir(bundle_dir):
        print(f"not a bundle directory: {bundle_dir}")
        return 2
    report = diagnose(bundle_dir)
    print_report(report)
    return 1 if report["anomalies"] or report["slo_burn"] else 0


if __name__ == "__main__":
    sys.exit(main())
