"""Partition runtime twin: the port's ``service/partitions.py`` against the
JAX package's, on the CPU.

The four cases of ``tests/test_partitions.py`` run through both packages:
routing, a rebalance with checkpoint handoff, crash recovery from the
checkpoint plus a raw-log replay, and a single host's graceful release.
Each case keeps its own assertions, and the sequenced streams the two
packages broadcast are compared message by message (seq, client, type,
contents).
"""

from types import SimpleNamespace

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)

N_PARTS = 8
DOCS = [f"doc{i}" for i in range(10)]


def _pkg(name: str) -> SimpleNamespace:
    if name == "jax":
        from fluidframework_tpu.protocol.messages import (
            DocumentMessage, MessageType)
        from fluidframework_tpu.service.broadcaster import (
            BroadcasterLambda, PubSub)
        from fluidframework_tpu.service.core import InMemoryDb
        from fluidframework_tpu.service.deli import RawMessage
        from fluidframework_tpu.service.local_log import LocalLog
        from fluidframework_tpu.service.partitions import (
            PartitionManager, partition_of)
    else:
        from fluidframework_tpu_torch.protocol.messages import (
            DocumentMessage, MessageType)
        from fluidframework_tpu_torch.service.broadcaster import (
            BroadcasterLambda, PubSub)
        from fluidframework_tpu_torch.service.core import InMemoryDb
        from fluidframework_tpu_torch.service.deli import RawMessage
        from fluidframework_tpu_torch.service.local_log import LocalLog
        from fluidframework_tpu_torch.service.partitions import (
            PartitionManager, partition_of)
    return SimpleNamespace(**locals())


class _Run:
    """One package's partition manager, log and subscriptions."""

    def __init__(self, name: str):
        self.p = _pkg(name)
        self.log, self.db, self.pubsub = (self.p.LocalLog(),
                                          self.p.InMemoryDb(),
                                          self.p.PubSub())
        self.pm = self.p.PartitionManager(N_PARTS, self.log, self.db,
                                          self.pubsub)
        self.seen: dict = {}

    def collect(self, doc):
        into = self.seen.setdefault(doc, [])
        self.pubsub.subscribe(self.p.BroadcasterLambda.topic("t", doc),
                              lambda batch: into.extend(batch))

    def _order(self, doc, client_id, cseq, ref, typ, contents):
        self.pm.order(self.p.RawMessage(
            tenant_id="t", document_id=doc, client_id=client_id,
            operation=self.p.DocumentMessage(
                client_sequence_number=cseq, reference_sequence_number=ref,
                type=typ, contents=contents),
            timestamp=1.0))
        self.log.drain()

    def join(self, doc, client_id):
        self._order(doc, None, -1, -1, self.p.MessageType.CLIENT_JOIN,
                    {"clientId": client_id})

    def submit(self, doc, client_id, cseq, ref):
        self._order(doc, client_id, cseq, ref,
                    self.p.MessageType.OPERATION, {"n": cseq})

    def streams(self) -> dict:
        return {d: [(m.sequence_number, m.client_id, str(m.type),
                     m.contents) for m in ms]
                for d, ms in self.seen.items()}


def _both(scenario):
    out = {name: scenario(_Run(name)) for name in ("jax", "torch")}
    assert out["torch"] == out["jax"]
    return out["torch"]


def test_routing_is_stable_and_spread():
    jax_p, port_p = _pkg("jax"), _pkg("torch")
    pids = {port_p.partition_of("t", d, N_PARTS) for d in DOCS}
    assert len(pids) > 2  # docs spread over partitions
    for n in (1, 2, 3, N_PARTS, 64):
        for d in DOCS + [f"x{i}" for i in range(200)]:
            assert port_p.partition_of("t", d, n) == \
                jax_p.partition_of("t", d, n) == \
                port_p.partition_of("t", d, n)


def test_rebalance_preserves_sequencing():
    def scenario(r):
        r.pm.add_host("hostA")
        for d in DOCS:
            r.collect(d)
            r.join(d, "c1")
            r.submit(d, "c1", 1, 0)
        r.pm.add_host("hostB")
        assert set(r.pm.assignment.values()) == {"hostA", "hostB"}
        for d in DOCS:
            r.submit(d, "c1", 2, 1)
            r.submit(d, "c1", 3, 1)
        for d in DOCS:
            seqs = [m.sequence_number for m in r.seen[d]]
            assert seqs == [1, 2, 3, 4], (d, seqs)
        return r.streams(), dict(r.pm.assignment)

    _both(scenario)


def test_crash_recovery_resumes_from_checkpoint():
    def scenario(r):
        r.pm.add_host("hostA")
        r.pm.add_host("hostB")
        doc = DOCS[0]
        part = r.p.partition_of("t", doc, N_PARTS)
        owner = r.pm.assignment[part]
        r.collect(doc)
        r.join(doc, "c1")
        r.submit(doc, "c1", 1, 0)
        r.pm.checkpoint_all()
        r.submit(doc, "c1", 2, 1)
        r.pm.remove_host(owner, crashed=True)
        assert r.pm.assignment[part] != owner
        r.submit(doc, "c1", 3, 2)
        by_seq = {}
        for m in r.seen[doc]:
            if m.sequence_number in by_seq:
                prev = by_seq[m.sequence_number]
                assert (prev.contents, prev.client_id, prev.type) == \
                    (m.contents, m.client_id, m.type)
            by_seq[m.sequence_number] = m
        assert sorted(by_seq) == [1, 2, 3, 4]
        assert [by_seq[s].contents.get("n") for s in (2, 3, 4)] == [1, 2, 3]
        return r.streams()

    _both(scenario)


def test_single_host_gets_everything_and_release_is_graceful():
    def scenario(r):
        host = r.pm.add_host("solo")
        for d in DOCS:
            r.collect(d)
            r.join(d, "c1")
        assert set(r.pm.assignment.values()) == {"solo"}
        assert sum(len(p.orderers)
                   for p in host.partitions.values()) == len(DOCS)
        r.pm.remove_host("solo")
        assert not r.pm.assignment
        return r.streams()

    _both(scenario)
