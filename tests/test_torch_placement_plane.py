"""Placement control plane twin: the port's ``placement``,
``placement_plane``, ``ShardHost``, deli's epoch fence and
``chaos/migrate.py`` against the JAX package's, on the CPU.

Each case of ``tests/test_placement_plane.py`` runs through both packages
and the two are compared: the epoch table's order and the routing cache's
decisions, the stale-epoch refusal (nack code, message, seqs), the
migration equivalence fuzz at seeds 0, 7 and 42 (texts and every
replica's fingerprint), the double-owner race, the driver's redirect
retry in client-sequence order, and the quick ``chaos.migrate`` campaign
(its verdict and the fingerprints its monitors gate on). A shard dir
written by either package's ``ShardHost`` (leases, ``placement/table.json``,
``tenants.json``, each ``log-<k>``) is adopted by the other's, which then
serves the same docs at the same seqs and epochs.
"""

import random
import threading
import time
from importlib import import_module
from types import SimpleNamespace

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

TENANT = "chaos"
ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def _pkg(name: str) -> SimpleNamespace:
    root = ROOTS[name]

    def mod(path):
        return import_module(f"{root}.{path}")

    migrate = mod("chaos.migrate")
    plane = mod("service.placement_plane")
    messages = mod("protocol.messages")
    return SimpleNamespace(
        name=name, root=root, mod=mod,
        MigrateClient=migrate.MigrateClient,
        doc_for_partition=migrate._doc_for_partition,
        log_fingerprint=migrate._log_fingerprint,
        run_campaign=migrate.run_campaign,
        InvariantMonitor=mod("chaos.monitor").InvariantMonitor,
        replica_fingerprint=mod("chaos.soak")._replica_fingerprint,
        tier_snapshot=mod("obs").tier_snapshot,
        DocumentMessage=messages.DocumentMessage,
        MessageType=messages.MessageType,
        ShardHost=mod("service.front_end").ShardHost,
        NetworkFrontEnd=mod("service.front_end").NetworkFrontEnd,
        LocalServer=mod("service.local_server").LocalServer,
        PlacementDir=mod("service.placement").PlacementDir,
        EpochTable=plane.EpochTable,
        MigrationEngine=plane.MigrationEngine,
        RoutingCache=plane.RoutingCache,
        doc_partition=mod("service.stage_runner").doc_partition,
        Counters=mod("utils.telemetry").Counters,
        sign_token=mod("service.tenants").sign_token,
    )


PKGS = {name: _pkg(name) for name in ROOTS}


@pytest.fixture(autouse=True)
def _fresh_placement_counters(monkeypatch):
    """Test isolation: ``placement_counters()`` keeps the ``Counters`` it
    made first, registered with the metrics registry of that moment. A
    test file that ran earlier in this process may have dropped that
    registry (``reset_registry``), so that ``tier_snapshot`` no longer
    sees the counts; each case starts without one, and the seams
    register a fresh one with the current registry."""
    for P in PKGS.values():
        monkeypatch.setattr(P.mod("service.placement_plane"),
                            "_SHARED_COUNTERS", None)


def wait_for(pred, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


def _op(P, cseq: int, ref_seq: int = 0):
    return P.DocumentMessage(
        client_sequence_number=cseq, reference_sequence_number=ref_seq,
        type=P.MessageType.OPERATION, contents={"i": cseq})


def _host(P, shard_dir, prefer=(), n=2, ttl_s=30.0):
    h = P.ShardHost(str(shard_dir), n, prefer=prefer, ttl_s=ttl_s)
    h.address = f"inproc/{h.owner_id}"
    h.poll()
    return h


def _close(*hosts) -> None:
    for h in hosts:
        for s in list(h.servers.values()):
            s.log.close()


# ----------------------------------------------------------- epoch table


def _epoch_and_cache(P, tmp_path) -> list:
    table = P.EpochTable(str(tmp_path / "placement"))
    e1 = table.record_claim(0, "a", "addr-a")
    e2 = table.record_claim(1, "a", "addr-a")
    e3 = table.record_claim(0, "b", "addr-b")
    assert e1 < e2 < e3
    assert table.epoch_of(0) == e3 and table.addr_of(0) == "addr-b"
    e4 = table.record_release(1, "a")
    assert e4 > e3 and table.addr_of(1) is None
    assert table.record_release(0, "a") is None
    assert table.global_epoch() == e4
    cache = P.RoutingCache(
        P.PlacementDir(str(tmp_path / "placement"), 2, 1.0), table)
    seen = [e1, e2, e3, e4, cache.resolve(0),
            cache.note_epoch(0, "addr-a", e1), cache.resolve(0),
            cache.note_epoch(0, "addr-c", e4 + 1), cache.resolve(0)]
    cache.invalidate(0)
    seen += [cache.note_epoch(0, "addr-a", e1),
             cache.note_epoch(0, "addr-d", e4 + 2), cache.resolve(0)]
    return seen


def test_epoch_monotonicity_and_cache_ordering(tmp_path):
    """Every ownership change bumps the global epoch; a routing cache at
    epoch E refuses any older push. Both packages decide alike, and each
    reads the other's table file."""
    got = _epoch_and_cache(PKGS["torch"], tmp_path / "torch")
    want = _epoch_and_cache(PKGS["jax"], tmp_path / "jax")
    assert got == want
    assert got[4:] == ["addr-b", False, "addr-b", True, "addr-c", False,
                       True, "addr-d"]
    for reader, writer in (("jax", "torch"), ("torch", "jax")):
        table = PKGS[reader].EpochTable(str(tmp_path / writer / "placement"))
        assert table.read() == PKGS[writer].EpochTable(
            str(tmp_path / writer / "placement")).read()


# ------------------------------------------------------ stale-epoch fence


def _stale_epoch(P, tmp_path) -> dict:
    sh = _host(P, tmp_path, prefer=(0, 1))
    try:
        k = P.doc_partition("t1", "doc-x", 2)
        server = sh.servers[k]
        conn = server.connect("t1", "doc-x")
        nacks = []
        conn.on_nack = nacks.append
        conn.submit([_op(P, 1)])
        server.drain()
        assert not nacks
        seq_before = server.doc_sequence_numbers()["t1/doc-x"]
        before = P.tier_snapshot("placement").get(
            "placement.epoch.stale_nacks", 0)
        current = sh.table.record_claim(k, "other-core", "inproc/other")
        sh.table_epochs = sh.table.part_epochs()
        conn.submit([_op(P, 2)])
        server.drain()
        assert len(nacks) == 1
        nack = nacks[0]
        assert nack.code == 410 and f"epoch {current}" in nack.message
        assert nack.operation.client_sequence_number == 2
        assert server.doc_sequence_numbers()["t1/doc-x"] == seq_before
        assert P.tier_snapshot("placement").get(
            "placement.epoch.stale_nacks", 0) == before + 1
        return {"k": k, "seq": seq_before, "current": current,
                "nack": (nack.code, str(nack.type), nack.message,
                         nack.sequence_number,
                         nack.operation.client_sequence_number)}
    finally:
        _close(sh)


def test_stale_epoch_submit_refused(tmp_path):
    """Deli refuses a record whose partition epoch is stale: nacked with
    the current epoch, nothing sequenced, offset consumed."""
    got = _stale_epoch(PKGS["torch"], tmp_path / "torch")
    assert got == _stale_epoch(PKGS["jax"], tmp_path / "jax")


# ------------------------------------------------- migration equivalence


def _edit_stream(P, tmp_path, migrate_rounds, seed: int) -> tuple:
    """Seeded two-client edit stream over partition 0, migrated between
    two cores at the given rounds: the converged text and every
    replica's fingerprint."""
    a = _host(P, tmp_path, prefer=(0, 1))
    b = _host(P, tmp_path)
    hosts = [a, b]
    doc = P.doc_for_partition(0, 2)
    counters = P.Counters()
    monitor = P.InvariantMonitor(counters)

    def owner():
        for h in hosts:
            s = h.servers.get(0)
            if s is not None and not s.sealed:
                return s
        return None

    def drain_all():
        for h in hosts:
            for s in list(h.servers.values()):
                s.drain()

    clients = [P.MigrateClient(doc, owner, monitor, counters,
                               random.Random(seed * 101 + i))
               for i in range(2)]
    try:
        for c in clients:
            assert c.connect()
        drain_all()
        for rnd in range(30):
            for c in clients:
                if c.conn is None or c.severed:
                    assert c.reconnect()
            drain_all()
            for c in clients:
                c.edit(2)
            drain_all()
            if rnd in migrate_rounds:
                src = next(h for h in hosts if 0 in h.servers)
                tgt = next(h for h in hosts if h is not src)
                res = P.MigrationEngine(src).migrate(
                    0, tgt.address,
                    adopt=lambda k, addr, s=src, t=tgt:
                    P.MigrationEngine(t).adopt(k, s.owner_id))
                assert res["target"] == tgt.address
                for c in clients:
                    c.sever()
        for _ in range(10):
            drain_all()
            if all(c.settled for c in clients):
                break
            for c in clients:
                if not c.settled:
                    c.reconnect()
        drain_all()
        for c in clients:
            c.catch_up()
        final = owner()
        monitor.attach(final.log, f"deltas/{TENANT}/{doc}")
        final.drain()
        fps = {str(i): P.replica_fingerprint(c.replica)
               for i, c in enumerate(clients)}
        fps["oracle"] = P.log_fingerprint(final, doc)
        assert len(set(fps.values())) == 1, fps
        monitor.check_quiescent(fps)
        return clients[0].replica.get_text(), fps
    finally:
        _close(*hosts)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_migration_equivalence_fuzz(tmp_path, seed):
    """The same seeded stream gives the same document whether partition 0
    stayed put or migrated A→B and back, in both packages, with every
    fingerprint equal to the JAX package's."""
    out = {}
    for name, P in PKGS.items():
        for arm, rounds in (("migrated", {9, 19}), ("control", set())):
            out[name, arm] = _edit_stream(P, tmp_path / name / arm, rounds,
                                          seed)
    assert len(set(repr(v) for v in out.values())) == 1, out
    assert len(out["torch", "control"][0]) > 20


# ------------------------------------------------------ double-owner race


def _race(P, tmp_path) -> tuple:
    a = _host(P, tmp_path, prefer=(0,), n=1)
    b = _host(P, tmp_path, n=1)
    c = _host(P, tmp_path, n=1)
    try:
        conn = a.servers[0].connect("t1", "doc-r")
        conn.submit([_op(P, 1)])
        a.servers[0].drain()
        winners, barrier = [], threading.Barrier(2)

        def race(host):
            barrier.wait()
            try:
                winners.append((host, P.MigrationEngine(host).adopt(
                    0, a.owner_id)))
            except RuntimeError:
                pass  # lost the transfer race

        threads = [threading.Thread(target=race, args=(h,)) for h in (b, c)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(winners) == 1
        winner = winners[0][0]
        loser = b if winner is c else c
        assert 0 in winner.servers and 0 not in loser.servers
        wconn = winner.servers[0].connect("t1", "doc-r")
        wconn.submit([_op(P, 1)])
        winner.servers[0].drain()
        nacks = []
        conn.on_nack = nacks.append
        a.table_epochs = a.table.part_epochs()
        conn.submit([_op(P, 2)])
        a.servers[0].drain()
        assert len(nacks) == 1 and nacks[0].code == 410
        wseq = winner.servers[0].doc_sequence_numbers()["t1/doc-r"]
        aseq = a.servers[0].doc_sequence_numbers()["t1/doc-r"]
        assert wseq > aseq
        return len(winners), nacks[0].code, aseq, wseq
    finally:
        _close(a, b, c)


def test_double_owner_race_exactly_one_sequences(tmp_path):
    """Two cores race to adopt one partition: exactly one wins, and the
    ex-owner's next submit is fenced. Same outcome in both packages."""
    assert _race(PKGS["torch"], tmp_path / "torch") == \
        _race(PKGS["jax"], tmp_path / "jax")


# ------------------------------------------- driver redirect retry order


def _redirect_retry(P) -> list:
    factory_mod = P.mod("driver.network")
    front = P.NetworkFrontEnd(P.LocalServer()).start_background()
    factory = factory_mod.NetworkDocumentServiceFactory("127.0.0.1",
                                                        front.port)
    try:
        conn = factory.create_document_service(
            "t", "doc-m").connect_to_delta_stream()
        acked, hard = {}, []
        conn.on_op = lambda m: (
            m.client_id == conn.client_id
            and acked.__setitem__(m.client_sequence_number,
                                  m.sequence_number))
        conn.on_nack = hard.append
        conn.submit([_op(P, 1), _op(P, 2)])
        assert wait_for(lambda: len(acked) == 2)
        redirects = P.tier_snapshot("placement").get(
            "placement.submits.redirected", 0)
        front.server.seal()
        snap = factory.counters.snapshot
        shed_before = snap().get("driver.submit.shed_retries", 0)
        conn.submit([_op(P, c) for c in range(3, 13)])
        assert wait_for(
            lambda: snap().get("driver.submit.shed_retries", 0)
            > shed_before)
        assert len(acked) == 2
        assert P.tier_snapshot("placement").get(
            "placement.submits.redirected", 0) > redirects
        front.server.unseal()
        assert wait_for(lambda: len(acked) == 12, timeout=30.0)
        assert not hard, f"hard nack leaked: {hard[0]}"
        seqs = [acked[cs] for cs in range(3, 13)]
        assert seqs == sorted(seqs)
        conn.close()
        return [acked[cs] - acked[1] for cs in range(1, 13)]
    finally:
        front.stop()


def test_driver_redirect_retry_preserves_cseq_order():
    """Submits hitting a sealed port server bounce on the shed-retry lane
    and land after the unseal, in cseq order, with no hard nack."""
    got = _redirect_retry(PKGS["torch"])
    assert got == _redirect_retry(PKGS["jax"]) == list(range(12))


# ---------------------------------------------------- campaign smoke run


def _campaign(P, seed: int, monkeypatch) -> dict:
    monitor = P.mod("chaos.monitor")
    fps = []
    gate = monitor.InvariantMonitor.check_quiescent

    def capture(self, fingerprints):
        fps.append(dict(fingerprints))
        return gate(self, fingerprints)

    monkeypatch.setattr(monitor.InvariantMonitor, "check_quiescent",
                        capture)
    out = P.run_campaign(seed, P.Counters(), quick=True)
    out["fingerprints"] = fps
    return out


def test_chaos_migrate_quick_campaign(monkeypatch):
    """The quick campaign (one source crash at pre_handoff, one clean
    migration, a zombie ex-owner fenced): the port's verdict, counters
    and fingerprints equal the JAX package's."""
    got = _campaign(PKGS["torch"], 11, monkeypatch)
    want = _campaign(PKGS["jax"], 11, monkeypatch)
    assert got == want
    assert got["recoveries"] == 1
    assert got["placement"]["placement.migration.committed"] >= 1
    assert got["sequenced"]["doc0"] > 20
    assert all(len(set(f.values())) == 1 for f in got["fingerprints"])


# ------------------------------------------------------ shard-dir interop


DOCS = [f"doc{i}" for i in range(6)]


def _write(P, shard_dir) -> None:
    """A core of package ``P`` claims both partitions of a fresh shard
    dir, registers a tenant and writes three ops a doc, then releases."""
    sh = _host(P, shard_dir, prefer=(0, 1), ttl_s=30.0)
    sh.tenants.register("acme", "s3cret")
    sh.save_tenants()
    try:
        for i, doc in enumerate(DOCS):
            server = sh.servers[P.doc_partition("acme", doc, 2)]
            conn = server.connect("acme", doc, token=P.sign_token(
                "acme", doc, "s3cret"))
            conn.submit([_op(P, c) for c in range(1, 4 + i % 2)])
            server.drain()
        for server in sh.servers.values():
            server.checkpoint_all()
            server.log.flush()
    finally:
        sh.release_all()
        _close(sh)


def _adopt(P, shard_dir) -> dict:
    """A core of package ``P`` adopts the shard dir: the tenant registry,
    each doc's seq and sequenced stream, and the partitions' epochs."""
    sh = _host(P, shard_dir, prefer=(0, 1), ttl_s=30.0)
    try:
        out = {"tenants": sh.tenants.list_tenants(),
               "claims": dict(sh.claim_epochs), "docs": {}}
        for doc in DOCS:
            server = sh.servers[P.doc_partition("acme", doc, 2)]
            token = P.sign_token("acme", doc, "s3cret")
            server._client_epoch = "e0"  # run-independent client ids
            server.connect("acme", doc, token=token)
            server.drain()
            out["docs"][doc] = (
                server.doc_sequence_numbers()[f"acme/{doc}"],
                [(m.sequence_number, str(m.type), m.contents,
                  m.client_sequence_number)
                 for m in server.get_deltas("acme", doc, 0, 10_000)])
        out["epochs"] = sh.table.part_epochs()
        return out
    finally:
        sh.release_all()
        _close(sh)


@pytest.mark.parametrize("writer, reader", [("jax", "torch"),
                                            ("torch", "jax")])
def test_shard_dir_interop(tmp_path, writer, reader):
    """A shard dir written by one package's ShardHost is adopted by the
    other's exactly as by the writer's own: same tenants, the same docs
    at the same seqs, the same epochs."""
    import shutil

    _write(PKGS[writer], tmp_path / "w")
    shutil.copytree(tmp_path / "w", tmp_path / "own")
    theirs = _adopt(PKGS[reader], tmp_path / "w")
    own = _adopt(PKGS[writer], tmp_path / "own")
    assert theirs == own
    assert theirs["tenants"] == ["acme"]
    assert all(seq >= 5 for seq, _ in theirs["docs"].values())
    # the writer's claims (1, 2) and releases (3, 4), then the re-claims
    assert theirs["epochs"] == {0: 5, 1: 6}
    assert theirs["claims"] == {0: 5, 1: 6}
