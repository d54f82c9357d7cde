"""Service-path load generator (BASELINE config 4 analog).

JAX counterpart: ``fluidframework_tpu/service/load_gen.py``; the port's
copy of ``LoadStats``, ``wire_applier``, ``run_inproc``, ``run_network``
(socket clients through the network driver against a live front end) and
its subprocess worker, imports rebased to this package.
``run_inproc_on`` is the port's own: ``run_inproc`` on a server the
caller holds, so that what the run leaves (the doc's storage, its
orderers) can be summarised and booted from afterwards.

Ref: packages/test/service-load-test/src/nodeStressTest.ts + README.md:5-30
— an orchestrator driving N synthetic SharedString clients against a live
service, measuring end-to-end throughput and op-ack latency.

The synthetic editor submits VALID merge-tree wire ops without running a
full client replica: it tracks its own perspective's visible length from
the broadcast stream (+insert len, −remove span — its tracked length is a
lower bound on the true perspective length, so generated positions are
always resolvable), which is O(1) per op. Ops are real chanop envelopes,
so the GpuDocumentApplier can ride the same stream.

``run_inproc``: deli → scriptorium/scribe/broadcaster (+ optional
GpuDocumentApplier) all in-process — the pipeline-throughput number.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from ..protocol.messages import MessageType
from ..utils.telemetry import percentile
from .broadcaster import BroadcasterLambda
from .local_server import LocalServer
from .synthetic import CHANNEL_ID, DS_ID, SyntheticEditor


@dataclass
class LoadStats:
    ops_submitted: int = 0
    ops_acked: int = 0
    seconds: float = 0.0
    ack_latencies_ms: list[float] = field(default_factory=list)
    applier_ops: int = 0
    applier_escalations: int = 0
    # per-hop wire-trace latency (submit→deli, deli→ack), SURVEY §5.1
    hops: dict = field(default_factory=dict)

    @property
    def ops_per_sec(self) -> float:
        return self.ops_submitted / self.seconds if self.seconds else 0.0

    def latency_ms(self, p: float) -> float:
        return percentile(sorted(self.ack_latencies_ms), p)

    def summary(self) -> dict:
        return {
            "ops": self.ops_submitted,
            "acked": self.ops_acked,
            "seconds": round(self.seconds, 3),
            "ops_per_sec": round(self.ops_per_sec, 1),
            "p50_ack_ms": round(self.latency_ms(0.50), 3),
            "p99_ack_ms": round(self.latency_ms(0.99), 3),
        }


def wire_applier(server: LocalServer, applier, tenant: str, docs: list[str]):
    """Subscribe a GpuDocumentApplier to the live broadcast of each doc
    (the scribe-position consumer of the sequenced stream). Op topics
    carry batches; the applier stages each batch in one call."""
    op_t = MessageType.OPERATION

    def make_cb(doc):
        def cb(batch):
            if type(batch) is not list:  # array lane: bulk ingest
                box = batch.boxcar
                if box.ds_id == DS_ID and box.channel_id == CHANNEL_ID:
                    applier.ingest_array_batch(tenant, doc, batch)
                return
            pairs = []
            for msg in batch:
                if msg.type is not op_t:
                    continue
                env = msg.contents
                if type(env) is not dict or env.get("kind") != "chanop":
                    continue
                if env["address"] != DS_ID:
                    continue
                inner = env["contents"]
                if inner.get("address") != CHANNEL_ID or "attach" in inner:
                    continue
                pairs.append((msg, inner["contents"]))
            if pairs:
                applier.ingest_batch(tenant, doc, pairs)
        return cb

    for doc in docs:
        server.pubsub.subscribe(
            BroadcasterLambda.topic(tenant, doc), make_cb(doc))


def run_inproc(
    n_docs: int = 64,
    clients_per_doc: int = 2,
    ops_per_client: int = 50,
    seed: int = 0,
    applier=None,
    flush_every: int = 256,
    tenant: str = "bench",
    batch_size: int = 1,
    array_lane: bool = False,
    log=None,
) -> LoadStats:
    """Drive the full in-process pipeline at max rate; measure throughput.

    Every submitted op passes deli ticketing, scriptorium persistence,
    scribe protocol tracking, broadcast fan-out to every connected
    client, and (optionally) the applier's device batch.

    ``batch_size``: ops each client submits per round as one boxcar (the
    outbound DeltaQueue flush / Kafka boxcar analog). ``ops_per_client``
    must be a multiple of it.

    ``array_lane``: submit ArrayBoxcars (service/array_batch.py) — deli
    tickets with numpy, the applier bulk-loads chunks, subscribers consume
    batches without per-op message objects. Semantically equivalent to the
    dict lane.

    ``log``: the server's ordered log (a fresh ``LocalLog`` when None);
    pass one to read the sequenced stream (its ``deltas/...`` topics)
    after the run.
    """
    return run_inproc_on(
        LocalServer(log=log), n_docs=n_docs, clients_per_doc=clients_per_doc,
        ops_per_client=ops_per_client, seed=seed, applier=applier,
        flush_every=flush_every, tenant=tenant, batch_size=batch_size,
        array_lane=array_lane)


def run_inproc_on(
    server: LocalServer,
    n_docs: int = 64,
    clients_per_doc: int = 2,
    ops_per_client: int = 50,
    seed: int = 0,
    applier=None,
    flush_every: int = 256,
    tenant: str = "bench",
    batch_size: int = 1,
    array_lane: bool = False,
) -> LoadStats:
    """``run_inproc`` on ``server``: the same clients, ops and applier
    wiring; the sessions stay connected when it returns."""
    if ops_per_client % batch_size:
        raise ValueError(f"ops_per_client={ops_per_client} is not a "
                         f"multiple of batch_size={batch_size}")
    rng = random.Random(seed)
    docs = [f"doc{i}" for i in range(n_docs)]
    stats = LoadStats()

    if applier is not None:
        applier.set_replay_source(lambda t, d: [])
        wire_applier(server, applier, tenant, docs)

    sessions = []  # (conn, editor)
    submit_t = [0.0]  # the in-flight boxcar's submit timestamp
    for doc in docs:
        for _ in range(clients_per_doc):
            conn = server.connect(tenant, doc)
            editor = SyntheticEditor(rng)
            # track every broadcast op EXCEPT own (already tracked at submit)
            def on_ops(batch, editor=editor, me=conn.client_id):
                acked = 0
                for msg in batch:
                    if msg.client_id == me:
                        editor.ref_seq = msg.sequence_number
                        acked += 1
                    else:
                        editor.observe(msg)
                if acked:
                    # submit → own-broadcast latency for this boxcar (the
                    # in-proc ack time; ONE sample per boxcar — samples
                    # per op would be identical copies)
                    stats.ack_latencies_ms.append(
                        (time.perf_counter() - submit_t[0]) * 1e3)
                stats.ops_acked += acked
            conn.on_ops = on_ops
            if array_lane:
                # message LISTS (joins etc.) still route to on_ops above;
                # only SequencedArrayBatch objects land here
                def on_abatch(batch, editor=editor, me=conn.client_id):
                    if batch.boxcar.client_id == me:
                        editor.ref_seq = batch.last_seq
                        stats.ack_latencies_ms.append(
                            (time.perf_counter() - submit_t[0]) * 1e3)
                        stats.ops_acked += batch.n
                    else:
                        editor.observe_abatch(batch)
                conn.on_abatch = on_abatch
            sessions.append((conn, editor))

    rounds = ops_per_client // batch_size
    since_flush = 0
    t0 = time.perf_counter()
    for _ in range(rounds):
        for conn, editor in sessions:
            submit_t[0] = time.perf_counter()
            if array_lane:
                conn.submit_array(editor.next_boxcar(
                    batch_size, tenant, conn.document_id, conn.client_id))
            else:
                conn.submit(editor.next_ops(batch_size))
            stats.ops_submitted += batch_size
            since_flush += batch_size
            if applier is not None and since_flush >= flush_every:
                applier.flush()
                since_flush = 0
    if applier is not None:
        applier.flush()
        applier.finalize()
    stats.seconds = time.perf_counter() - t0

    if applier is not None:
        stats.applier_ops = applier.ops_applied
        stats.applier_escalations = applier.host_escalations
    return stats


def run_network(
    port: int,
    n_docs: int = 2,
    clients_per_doc: int = 2,
    ops_per_client: int = 100,
    seed: int = 0,
    tenant: str = "bench",
    host: str = "127.0.0.1",
    timeout: float = 60.0,
    rate_hz: Optional[float] = None,
    doc_prefix: str = "netdoc",
) -> LoadStats:
    """Drive socket clients against a live front end; measure op-ack
    latency (submit → own op broadcast back) and throughput.

    ``rate_hz`` paces each SUBMISSION ROUND (one op per client) — without
    pacing the unbounded submit loop measures queueing depth, not service
    latency (the north-star p99 < 50 ms is an at-load number, not a
    saturation number)."""
    from ..driver.network import NetworkDocumentServiceFactory
    from ..protocol.messages import TraceHop
    from ..utils import TraceAggregator

    import threading

    rng = random.Random(seed)
    factory = NetworkDocumentServiceFactory(host, port)
    stats = LoadStats()
    traces = TraceAggregator()
    # acks arrive on per-connection reader threads; unsynchronized
    # read-modify-writes on the shared counters would drop increments
    stats_lock = threading.Lock()
    sessions = []

    for d in range(n_docs):
        doc = f"{doc_prefix}{d}"
        for _ in range(clients_per_doc):
            svc = factory.create_document_service(tenant, doc)
            conn = svc.connect_to_delta_stream()
            editor = SyntheticEditor(rng)
            pending: dict[int, float] = {}  # clientSeq → send time

            def on_op(msg, editor=editor, me=conn.client_id, pending=pending):
                if msg.client_id == me:
                    editor.ref_seq = msg.sequence_number
                    sent = pending.pop(msg.client_sequence_number, None)
                    now = time.time()
                    with stats_lock:
                        if sent is not None:
                            stats.ack_latencies_ms.append(
                                (time.perf_counter() - sent) * 1e3)
                        traces.record(msg, ack_time=now)
                        stats.ops_acked += 1
                else:
                    editor.observe(msg)
            conn.on_op = on_op
            sessions.append((conn, editor, pending))

    expected = len(sessions) * ops_per_client
    t0 = time.perf_counter()
    for i in range(ops_per_client):
        if rate_hz is not None:
            # absolute schedule so pacing error doesn't accumulate
            target = t0 + i / rate_hz
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        for conn, editor, pending in sessions:
            with conn.lock:
                op = editor.next_op()
                # client-side trace stamp: deli appends its hop, and the
                # ack observer turns the pair into per-hop latency
                op.traces.append(
                    TraceHop(service="client", action="submit",
                             timestamp=time.time()))
                pending[op.client_sequence_number] = time.perf_counter()
                conn.submit([op])
            stats.ops_submitted += 1
    # wait for all acks
    deadline = time.time() + timeout
    while stats.ops_acked < expected and time.time() < deadline:
        time.sleep(0.002)
    stats.seconds = time.perf_counter() - t0
    stats.hops = traces.raw
    for conn, _, _ in sessions:
        conn.close()
    return stats


def _worker_main() -> None:
    """Subprocess load runner (ref: service-load-test nodeStressTest.ts —
    the orchestrator spawns N runner PROCESSES so client-side work never
    shares a GIL with the measurement). Prints one JSON result line."""
    import argparse
    import gc
    import json
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--docs", type=int, default=4)
    p.add_argument("--clients-per-doc", type=int, default=2)
    p.add_argument("--ops", type=int, default=200)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--doc-prefix", default="netdoc")
    args = p.parse_args()

    gc.set_threshold(200000, 50, 50)
    gc.collect()
    gc.freeze()
    stats = run_network(
        args.port, n_docs=args.docs, clients_per_doc=args.clients_per_doc,
        ops_per_client=args.ops, seed=args.seed, host=args.host,
        rate_hz=args.rate, doc_prefix=args.doc_prefix)
    json.dump({
        "ops": stats.ops_submitted,
        "acked": stats.ops_acked,
        "seconds": stats.seconds,
        "lat_ms": stats.ack_latencies_ms,
        "hops": stats.hops,
    }, sys.stdout)
    print()


if __name__ == "__main__":
    _worker_main()
