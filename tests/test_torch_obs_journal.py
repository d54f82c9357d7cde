"""The port's control-plane audit journal on the CPU, and against the JAX
package's.

The journal-only tests of ``tests/test_obs_journal.py`` (the codec, the
torn-tail and garbage-line reads, rotation with seq recovery across a
restart, tail filters, cause links and the fleet merge), run on the
port's ``obs.journal``; then one emit script through both packages'
journals: the same entries, field for field but the wall-clock ``ts``,
and the same closed registry of kinds. The port's journal is its own
process-wide object, and its entries count into the port's registry.
"""

from __future__ import annotations

import os
import random
import string

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

from fluidframework_tpu_torch.obs import get_registry
from fluidframework_tpu_torch.obs.journal import (
    KINDS,
    Journal,
    arm_journal,
    causal_chain,
    filter_entries,
    get_journal,
    merge_entries,
    read_journal,
    reset_journal,
)


# ------------------------------------------------------------ codec basics


def test_emit_roundtrip_disarmed_noop_and_kind_guard(tmp_path):
    path = str(tmp_path / "j" / "core.jsonl")
    jr = Journal(path, core="c0", epoch_fn=lambda: 7)
    eid = jr.emit("core.start", owner="c0", shards=2)
    assert eid == "c0:1"
    e2 = jr.emit("lease.claim", cause=eid, part=3)
    assert e2 == "c0:2"
    entries = read_journal(path)
    assert [e["id"] for e in entries] == ["c0:1", "c0:2"]
    assert entries[0]["kind"] == "core.start"
    assert entries[0]["epoch"] == 7
    assert entries[0]["labels"] == {"owner": "c0", "shards": 2}
    assert entries[1]["cause"] == eid
    # an undeclared kind must explode at emit time on an ARMED journal
    with pytest.raises(ValueError):
        jr.emit("migration.sealed", part=3)
    jr.close()
    # disarmed: emit is a no-op returning None (the bench A/B contract)
    off = Journal()
    assert not off.armed
    assert off.emit("core.start") is None
    assert off.emit("not.even.a.kind") is None  # no validation when free


def test_codec_fuzz_and_torn_tail(tmp_path):
    """200 fuzzed entries round-trip; garbage and a torn final line are
    skipped without poisoning the earlier reads."""
    rng = random.Random(14)
    path = str(tmp_path / "fuzz.jsonl")
    jr = Journal(path, core="fz")
    kinds = sorted(KINDS)
    emitted = []
    for i in range(200):
        labels = {
            "s": "".join(rng.choices(string.printable, k=rng.randrange(20))),
            "u": "μ→漢 \x00" * rng.randrange(3),
            "n": rng.choice([None, rng.random(), rng.randrange(1 << 40)]),
            "nest": {"a": [1, {"b": rng.random()}]},
        }
        kind = rng.choice(kinds)
        emitted.append((kind, jr.emit(kind, **labels), labels))
    jr.close()
    # torn tail: a crash mid-write leaves a partial line; plus junk
    with open(path, "a", encoding="utf-8", errors="surrogateescape") as f:
        f.write("not json at all\n")
        f.write('{"noise": true}\n')      # wrong shape (no kind)
        f.write('[1, 2, 3]\n')            # not an object
        f.write('{"id":"fz:999","seq":999,"kind":"core.st')  # torn
    entries = read_journal(path)
    assert len(entries) == 200
    for (kind, eid, labels), e in zip(emitted, entries):
        assert e["kind"] == kind and e["id"] == eid
        assert e["labels"]["nest"] == labels["nest"]
    assert [e["seq"] for e in entries] == list(range(1, 201))


def test_rotation_and_seq_recovery_across_restart(tmp_path):
    """Rotation keeps one prior generation; a re-armed journal recovers
    the seq from the tail so restarted cores never reuse ids."""
    path = str(tmp_path / "rot.jsonl")
    jr = Journal(path, core="r0", max_bytes=2048)
    n = 0
    while not os.path.exists(path + ".1") and n < 500:
        n += 1
        jr.emit("epoch.bump", epoch=n, part=n % 4)
    assert os.path.exists(path + ".1"), "rotation never happened"
    for _ in range(5):  # land entries in the fresh generation too
        n += 1
        jr.emit("epoch.bump", epoch=n)
    jr.close()
    entries = read_journal(path)  # rotated generation first
    seqs = [e["seq"] for e in entries]
    assert seqs == sorted(seqs)
    assert seqs[-1] == n
    # restart: a new instance on the same path continues the id space
    jr2 = Journal(path, core="r0")
    assert jr2.seq == n
    assert jr2.emit("core.recover", owner="r0") == f"r0:{n + 1}"
    jr2.close()


def test_tail_filters_kind_prefix_doc_and_part(tmp_path):
    path = str(tmp_path / "t.jsonl")
    jr = Journal(path, core="t0")
    jr.emit("migration.seal", part=1, doc="d1")
    jr.emit("migration.commit", part=1)
    jr.emit("lease.claim", part=2)
    jr.emit("summary.commit", doc="d1", tenant="t")
    assert [e["kind"] for e in jr.tail(kind="migration.")] == [
        "migration.seal", "migration.commit"]
    assert [e["kind"] for e in jr.tail(part=2)] == ["lease.claim"]
    assert [e["kind"] for e in jr.tail(doc="d1")] == [
        "migration.seal", "summary.commit"]
    assert len(jr.tail(n=2)) == 2
    jr.close()
    # the same filters over raw entry lists (the admin --fleet path)
    entries = read_journal(path)
    assert len(filter_entries(entries, kind="migration.", part=1)) == 2


# ------------------------------------------------------------- cause links


def _entry(core, seq, kind, cause=None, epoch=None, ts=0.0, **labels):
    return {"id": f"{core}:{seq}", "seq": seq, "ts": ts, "core": core,
            "epoch": epoch, "kind": kind, "cause": cause, "labels": labels}


def test_causal_chain_root_first_opaque_and_cycles():
    entries = [
        _entry("a", 1, "operator.command"),
        _entry("a", 2, "migration.seal", cause="a:1"),
        _entry("b", 1, "migration.adopt", cause="a:2"),
        _entry("a", 3, "migration.commit", cause="b:1"),
        # opaque cause (a flight-dump path) terminates the walk cleanly
        _entry("a", 4, "flight.dump", cause="/var/dumps/x.json"),
        # a cause cycle must not hang the walker
        _entry("c", 1, "lease.claim", cause="c:2"),
        _entry("c", 2, "lease.release", cause="c:1"),
    ]
    chain = causal_chain(entries, "a:3")
    assert [e["id"] for e in chain] == ["a:1", "a:2", "b:1", "a:3"]
    assert [e["id"] for e in causal_chain(entries, "a:4")] == ["a:4"]
    cyc = causal_chain(entries, "c:1")
    assert {e["id"] for e in cyc} == {"c:1", "c:2"}  # visited once each
    assert causal_chain(entries, "nope:1") == []


def test_fleet_merge_epoch_leads_wall_clock_skew():
    """core A's wall clock runs 100 s AHEAD of core B's. The shared
    epoch must still order the cross-core handoff correctly — ts only
    breaks ties within an epoch."""
    core_a = [  # skewed fast: big ts, SMALL epochs
        _entry("a", 1, "migration.seal", epoch=5, ts=1100.0),
        _entry("a", 2, "migration.commit", epoch=7, ts=1101.0),
    ]
    core_b = [  # adopt happened between, on the slow clock
        _entry("b", 1, "migration.adopt", epoch=6, ts=1000.5),
        _entry("b", 2, "epoch.bump", epoch=6, ts=1000.9),
    ]
    merged = merge_entries([core_a, core_b])
    assert [e["id"] for e in merged] == ["a:1", "b:1", "b:2", "a:2"]
    # entries with no epoch (unbound journal) sort before any epoch
    merged2 = merge_entries([[_entry("c", 1, "core.start", ts=999.0)],
                             core_b])
    assert merged2[0]["id"] == "c:1"


# ----------------------------------------------------- the two packages


def _emit_script(journal_mod, path: str) -> list:
    jr = journal_mod.Journal(path, core="c7", epoch_fn=lambda: 3)
    root = jr.emit("operator.command", cmd="fork", doc="d")
    cid = jr.emit("history.fork", cause=root, tenant="t", doc="d",
                  fork="d-fork", seq=41, base=30)
    jr.emit("history.integrate", cause=cid, doc="d", fork="d-fork", ops=5)
    jr.emit("history.gc", tenant="t", scanned=9, pinned=4, deleted=5,
            epoch=4)
    jr.close()
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in journal_mod.read_journal(path)]


def test_journal_entries_equal_jax(tmp_path):
    from fluidframework_tpu.obs import journal as jax_journal
    from fluidframework_tpu_torch.obs import journal as port_journal

    assert KINDS == jax_journal.KINDS
    got = _emit_script(port_journal, str(tmp_path / "port.jsonl"))
    want = _emit_script(jax_journal, str(tmp_path / "jax.jsonl"))
    assert got == want and len(got) == 4
    assert [e["id"] for e in causal_chain(got, "c7:3")] == [
        "c7:1", "c7:2", "c7:3"]


def test_process_journal_is_the_ports_own(tmp_path):
    """Arming the port's singleton leaves the JAX package's disarmed, and
    each emit counts into the port's registry."""
    from fluidframework_tpu.obs.journal import get_journal as jax_journal

    reset_journal()
    try:
        jr = arm_journal(str(tmp_path / "core.jsonl"), core="p0")
        assert jr is get_journal() and jr.armed
        assert not jax_journal().armed
        before = get_registry().scrape()
        assert jr.emit("history.commit", tenant="t", doc="d") == "p0:1"
        assert get_registry().scrape() != before
        assert read_journal(str(tmp_path / "core.jsonl"))[0]["kind"] \
            == "history.commit"
    finally:
        reset_journal()
    assert not get_journal().armed and get_journal().seq == 0
