"""The doctor's anomaly rules, the port's own copy.

JAX counterpart: ``tools/doctor_rules.py``, copied whole. The JAX
package's ``obs/health.py`` reaches that file through a ``sys.path``
insert into the repo's ``tools/``; the port keeps this copy inside its
package instead, so ``obs/health.py`` imports it like any module.

One rule = one function over a bundle-shaped artifact (a Prometheus
scrape text, a journal entry list, the placement dict, a core's boot
status) returning a list of anomaly strings. Two consumers share the
rule code verbatim: the offline bundle triage (``tools/doctor.py``)
and the in-process ``HealthEngine`` (``obs/health.py``), which builds
the same artifact shapes from the live process and evaluates
continuously. ``tests/test_torch_health_plane.py`` feeds one incident
through the port's engine and the offline doctor and compares them.

Pure stdlib on purpose.
"""

from __future__ import annotations

import re

#: consecutive rebalance.suppressed entries (no plan between) that
#: count as a storm — the loop wants to move but can't
STORM_THRESHOLD = 10

#: a migration.fence with no commit/fail/adopt for its partition, and
#: the journal still moved on for at least this long after it: the
#: migration wedged between fencing and lease transfer (the partition
#: is sealed and bouncing submits with nobody coming to adopt it)
FENCE_STALL_S = 10.0


def scrape_counter(scrape_text: str, name: str) -> float:
    """Sum every sample of a (possibly labeled) counter in a scrape."""
    total = 0.0
    pat = re.compile(r"^" + re.escape(name) + r'(?:\{[^}]*\})?\s+'
                     r"([0-9.eE+-]+)")
    for line in scrape_text.splitlines():
        m = pat.match(line)
        if m is not None:
            total += float(m.group(1))
    return total


# ---------------------------------------------------------- per-core


def lint_anomalies(lint) -> list:
    """A dirty fluidlint report in the capturing build."""
    out = []
    if lint is not None and not lint.get("clean", True):
        for v in lint.get("violations", []):
            out.append(
                f"lint [{v.get('pass')}]: {v.get('message')} "
                f"({v.get('path')}:{v.get('line')})")
    return out


def capture_error_anomalies(owner: str, row: dict) -> list:
    """A core that could not be reached at bundle/probe time.

    Rows marked ``routed: False`` (members holding no partition when
    the bundle was captured) are skipped: membership never expires, so
    a kill -9'd core's stale row would otherwise read as an outage
    forever after its partitions were re-claimed."""
    if row.get("routed") is False:
        return []
    if row.get("error"):
        return [f"core {owner}: capture error ({row['error']}) — "
                "unreachable or mid-restart at bundle time"]
    return []


def scrape_anomalies(owner: str, scrape_text: str) -> list:
    """Version-skew hop drops and door-fence rejections, from one
    core's Prometheus scrape."""
    out = []
    unknown = scrape_counter(scrape_text, "fluid_obs_trace_unknown_hops")
    if unknown:
        out.append(
            f"core {owner}: {int(unknown)} hop stamp(s) outside "
            "this build's taxonomy (version-skewed client?) — "
            "the breakdown is missing legs")
    rejected = scrape_counter(
        scrape_text, "fluid_placement_table_stale_rejections")
    if rejected:
        out.append(
            f"core {owner}: {int(rejected)} remote-table write(s) "
            "rejected by the door's fence — a zombie ex-owner kept "
            "writing the epoch table after takeover (the fence held, "
            "but that core's lease view is stale: check its host "
            "group's clock and network)")
    return out


def journal_disarmed_anomalies(owner: str, row: dict,
                               journal: list) -> list:
    if row.get("journal_armed") is False and not journal:
        return [f"core {owner}: journal disarmed — no audit trail "
                "from this core"]
    return []


def slo_burn_rows(owner: str, slo: dict) -> list:
    """Specs not in ``ok`` → burn rows (the report's slo_burn table;
    the doctor's exit code and the engine's slo component key on
    these)."""
    return [{"core": owner, **r} for r in (slo or {}).get("slos", [])
            if r.get("state") != "ok"]


def boot_anomalies(owner: str, boot) -> list:
    """Cold-start regressions: paid whole-log replays, or a stalled
    admission storm (parked boots idling against a refilled bucket)."""
    out = []
    if boot is None:
        return out
    ex = boot.get("executor") or {}
    pending = sum(p.get("docs_pending", 0)
                  for p in boot.get("parts", []))
    replays = (boot.get("counters") or {}).get(
        "boot.part.full_replay", 0)
    if replays:
        out.append(
            f"core {owner}: {replays} doc boot(s) paid a "
            "WHOLE-LOG replay — a summary or checkpoint is "
            "missing, so the cold-start bound is gone for "
            "those docs")
    if (pending and ex.get("parked", 0)
            and ex.get("tokens", 0) >= 1):
        out.append(
            f"core {owner}: {pending} doc(s) still pending "
            f"with {ex['parked']} boot(s) parked against a "
            "refilled admission bucket — the storm stalled "
            "(clients gave up retrying, or first routes never "
            "arrived)")
    return out


def suppression_storm_anomalies(owner: str, journal: list) -> list:
    """Longest run of rebalance.suppressed without an actionable plan
    breaking it."""
    run = best = 0
    for e in journal:
        kind = e.get("kind", "")
        if kind == "rebalance.suppressed":
            run += 1
            best = max(best, run)
        elif kind == "rebalance.plan":
            run = 0
    if best >= STORM_THRESHOLD:
        return [f"core {owner}: rebalance suppression storm ({best} "
                "consecutive suppressed ticks) — the loop wants to "
                "move but hysteresis/budget keeps refusing; check "
                "dwell/budget settings vs the heat imbalance"]
    return []


# ------------------------------------------------- merged journal


def epoch_regression_anomalies(merged: list) -> list:
    """Replayed in WALL-CLOCK order, each partition's epoch.bump
    sequence must only move forward — a later bump with a lower epoch
    means two cores wrote the table through different planes (a host
    group split-brained past the fence)."""
    out = []
    last_bump: dict = {}
    for e in sorted((e for e in merged if e.get("kind") == "epoch.bump"),
                    key=lambda e: (e.get("ts", 0.0), e.get("epoch", 0))):
        part = (e.get("labels") or {}).get("part")
        epoch = e.get("epoch")
        if part is None or epoch is None:
            continue
        prev = last_bump.get(part)
        if prev is not None and epoch < prev[0]:
            out.append(
                f"part {part}: epoch regressed e{epoch} on "
                f"{e.get('core')} after e{prev[0]} on {prev[1]} — two "
                "cores wrote the epoch table through different planes "
                "(a remote group bypassing the table door?)")
        if prev is None or epoch > prev[0]:
            last_bump[part] = (epoch, e.get("core"))
    return out


def fence_without_commit_anomalies(merged: list) -> list:
    """A fence that never became a commit (or a fail): the partition
    is sealed at a final seq, submits bounce, and no adopt/commit/fail
    ever followed while the journal kept moving for FENCE_STALL_S past
    the fence — the migration wedged mid-flight."""
    out = []
    fences: dict = {}
    for e in merged:
        kind = e.get("kind")
        part = (e.get("labels") or {}).get("part")
        if part is None:
            continue
        if kind == "migration.fence":
            fences[part] = e
        elif kind in ("migration.adopt", "migration.commit",
                      "migration.fail"):
            fences.pop(part, None)
    if not fences:
        return out
    horizon = max((e.get("ts", 0.0) for e in merged), default=0.0)
    for part in sorted(fences, key=str):
        e = fences[part]
        stalled_s = horizon - e.get("ts", 0.0)
        if stalled_s >= FENCE_STALL_S:
            out.append(
                f"part {part}: fenced on {e.get('core')} "
                f"[{e.get('id')}] with no commit/fail "
                f"{stalled_s:.0f}s later — the migration wedged "
                "after sealing (submits are bouncing with nobody "
                "coming to adopt; check the target core and the "
                "lease plane)")
    return out


def migration_fail_anomaly(e: dict) -> str:
    """One migration.fail entry → its anomaly line."""
    return (f"migration of part "
            f"{(e.get('labels') or {}).get('part')} FAILED on "
            f"{e.get('core')}: "
            f"{(e.get('labels') or {}).get('error')}")


# ------------------------------------------------------- placement


def placement_anomalies(placement, core_rows: dict) -> list:
    """Orphaned partitions, draining-but-owning cores, and the
    unreachable-host-group rule. ``core_rows`` maps owner → the
    capture row (the doctor's manifest rows; the engine's probe-backed
    peer reachability rows) — only its ``error`` field is read."""
    out = []
    if placement is None:
        return out
    member_states = {owner: row.get("state")
                     for owner, row in
                     (placement.get("cores") or {}).items()}
    owned_by: dict = {}
    for k, part in (placement.get("parts") or {}).items():
        owned_by.setdefault(part.get("owner"), []).append(k)
        if member_states and part.get("owner") not in member_states:
            out.append(
                f"part {k}: owner {part.get('owner')} is not in "
                "the core membership — orphaned routing entry "
                "(stale lease / dead core?)")
    for owner, state in member_states.items():
        if state in ("draining", "drained") and owned_by.get(owner):
            out.append(
                f"core {owner} is {state} but still owns parts "
                f"{sorted(owned_by[owner])} — evacuation stuck?")
    # unreachable host group: every core a host id advertises in the
    # membership failed capture — that is a machine (or its network)
    # down, not a core restarting; triage the host first
    by_host: dict = {}
    for owner, row in (placement.get("cores") or {}).items():
        host = row.get("host")
        if host is not None:
            by_host.setdefault(host, []).append(owner)
    for host, members in sorted(by_host.items()):
        # unrouted rows (no partitions at capture) carry no liveness
        # signal — same exclusion as capture_error_anomalies
        captured = [o for o in members if o in core_rows
                    and core_rows[o].get("routed") is not False]
        if captured and all(core_rows[o].get("error")
                            for o in captured):
            out.append(
                f"host group {host}: all {len(captured)} core(s) "
                f"({', '.join(sorted(captured))}) unreachable at "
                "capture — the whole host group is down or "
                "partitioned from the entry core")
    return out
