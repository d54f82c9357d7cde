"""Shared by the port's parity tests: the two packages' client stacks
side by side, a canonical form of what a ``LocalServer`` stores, so that
the JAX package's and the port's servers can be compared value by value,
and the thread cap of the port's tests.

Importing this module caps torch's intra-op threads at one: the port's
tests run small tensors, and under ``pytest -n`` a pool of one thread a
core in every worker crowds the subprocesses other test files spawn."""

from __future__ import annotations

import dataclasses
import enum
import json
import re
from importlib import import_module
from types import SimpleNamespace

import torch

torch.set_num_threads(1)


def stack(pkg: str) -> SimpleNamespace:
    """The client stack and summarizer of one package (``jax`` or
    ``torch``), with a factory for its replica farm on the CPU."""
    if pkg == "jax":
        from fluidframework_tpu.driver import LocalDocumentServiceFactory
        from fluidframework_tpu.loader import Loader
        from fluidframework_tpu.replay import state_fingerprint
        from fluidframework_tpu.runtime.summarizer import SummaryManager
        from fluidframework_tpu.service import LocalServer
        from fluidframework_tpu.service.core import (
            summary_versions_collection,
        )
        from fluidframework_tpu.service.service_summarizer import (
            ServiceSummarizer,
        )
        from fluidframework_tpu.service.tpu_applier import (
            TpuDocumentApplier,
            channel_stream,
        )

        def applier(**geo):
            return TpuDocumentApplier(**geo)
    else:
        from fluidframework_tpu_torch.driver import (
            LocalDocumentServiceFactory,
        )
        from fluidframework_tpu_torch.loader import Loader
        from fluidframework_tpu_torch.replay import state_fingerprint
        from fluidframework_tpu_torch.runtime.summarizer import SummaryManager
        from fluidframework_tpu_torch.service.core import (
            summary_versions_collection,
        )
        from fluidframework_tpu_torch.service.gpu_applier import (
            GpuDocumentApplier,
            channel_stream,
        )
        from fluidframework_tpu_torch.service.local_server import LocalServer
        from fluidframework_tpu_torch.service.service_summarizer import (
            ServiceSummarizer,
        )

        def applier(**geo):
            return GpuDocumentApplier(device="cpu", **geo)

    def server(**kw):
        """A server whose client ids and timestamps do not depend on the
        run: a fixed client-id epoch and a clock stuck at 0."""
        s = LocalServer(clock=lambda: 0.0, **kw)
        s._client_epoch = "e0"
        return s

    return SimpleNamespace(
        server=server, Loader=Loader,
        LocalDocumentServiceFactory=LocalDocumentServiceFactory,
        state_fingerprint=state_fingerprint, SummaryManager=SummaryManager,
        ServiceSummarizer=ServiceSummarizer, applier=applier,
        channel_stream=channel_stream,
        summary_versions_collection=summary_versions_collection)


def canonical(obj):
    """A package-independent form of a stored value: dataclasses become
    (class name, fields), enums their values, containers recurse. A
    message's trace hops are left out: deli stamps them from the wall
    clock, not from the server's clock."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, canonical(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)
                      if f.name != "traces"))
    if isinstance(obj, enum.Enum):
        return canonical(obj.value)
    if isinstance(obj, dict):
        return {k: canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [canonical(v) for v in obj]
    return obj


HISTORY_RECORDS = "history-records/"


def _records_without_ts(col: dict) -> list:
    """A ``history-records/*`` collection decoded (each entry is framed
    refgraph records in hex), without the wall-clock ``ts`` of commits
    and refs."""
    from fluidframework_tpu_torch.protocol.refgraph import scan_records

    out = []
    for i in range(len(col)):
        records, _ = scan_records(bytes.fromhex(col[str(i)]["hex"]))
        out += [{k: v for k, v in r.items() if k != "ts"} for r in records]
    return out


def history_records(server) -> dict:
    """Every doc's history-plane records, decoded, without ``ts``."""
    return {name[len(HISTORY_RECORDS):]: _records_without_ts(col)
            for name, col in server.db.collections.items()
            if name.startswith(HISTORY_RECORDS)}


def stored(server) -> dict:
    """Every db collection and log topic of a server (the log's records
    through its public ``length``/``read``), canonical; the history
    plane's records decoded and without their wall-clock ``ts``."""
    out = {}
    for name, col in server.db.collections.items():
        out["db:" + name] = (_records_without_ts(col)
                             if name.startswith(HISTORY_RECORDS)
                             else canonical(col))
    for topic in sorted(server.log._topics):
        out["log:" + topic] = [canonical(server.log.read(topic, i))
                               for i in range(server.log.length(topic))]
    return out


def token_campaign(root: str, name: str, seed: int, monkeypatch) -> dict:
    """One quick ``chaos.coldstart``/``chaos.multihost`` campaign of the
    package ``root`` and what its seed fixes: the docs, the token count,
    and each doc's final text as its verifier read it, split into
    tokens (every writer's token exactly once, nothing else); plus the
    campaign's boot counters and injections."""
    from importlib import import_module

    campaign = import_module(f"{root}.chaos.{name}")
    token_client = import_module(f"{root}.chaos.coldstart").TokenClient
    counters = import_module(f"{root}.utils.telemetry").Counters
    clients = []
    connect = token_client.connect

    def recording_connect(self):
        connect(self)
        clients.append(self)

    monkeypatch.setattr(token_client, "connect", recording_connect)
    out = campaign.run_campaign(seed, counters(), quick=True)
    monkeypatch.undo()
    writers = {c.doc: sorted(c.tokens) for c in clients if c.tokens}
    final = {}
    for c in clients:
        if not c.tokens:  # a verifier: booted after recovery, sent nothing
            final[c.doc] = sorted(c.container.runtime.get_data_store(
                "default").get_channel("text").get_text().split())
    assert final == writers, (final, writers)
    return {"docs": out["docs"], "tokens": out["tokens"], "final": final,
            "boot": out["boot"], "counters": out["counters"],
            "crashed": out.get("boot_crashed_cores")}


ROOTS = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}


def module(pkg: str, name: str):
    """The module ``name`` (dotted, under the package root) of one
    package (``jax`` or ``torch``)."""
    return import_module(f"{ROOTS[pkg]}.{name}")


_CLIENT_ID = re.compile(r"client-[0-9A-Za-z]+-\d+")


def map_client_ids(obj) -> str:
    """``obj`` as JSON text (keys sorted) with every client id replaced
    by its order of first appearance (``C0``, ``C1``, ...), so that two
    packages' records compare whatever ids their servers handed out."""
    text = json.dumps(obj, sort_keys=True, default=repr)
    ids: dict = {}
    return _CLIENT_ID.sub(
        lambda m: f"C{ids.setdefault(m.group(0), len(ids))}", text)


def _directory_value(sub) -> dict:
    return {"data": {k: sub.get(k) for k in sorted(sub.keys())},
            "subdirs": {n: _directory_value(d)
                        for n, d in sorted(sub.subdirectories())}}


def channel_value(ch):
    """A channel's value as a reader sees it, pending local edits
    included (``snapshot()`` holds the acked state)."""
    kind = ch.channel_type
    if kind == "shared-string":
        return ch.get_text()
    if kind in ("shared-number-sequence", "shared-object-sequence"):
        return ch.get_items()
    if kind == "shared-map":
        return {k: ch.get(k) for k in sorted(ch.keys())}
    if kind == "shared-directory":
        return _directory_value(ch.root)
    if kind == "shared-cell":
        return ["empty"] if ch.empty else ["value", ch.get()]
    if kind == "shared-counter":
        return ch.value
    if kind == "consensus-register-collection":
        return {k: ch.read_versions(k) for k in sorted(ch.keys())}
    if kind == "consensus-queue":
        holders = sorted({e["client"] for e in ch._in_flight.values()})
        return [ch.peek_values(), {c: ch.holding(c) for c in holders}]
    if kind == "ink":
        return ch.get_strokes()
    if kind == "shared-summary-block":
        return ch.snapshot()["data"]
    if kind == "shared-matrix":
        from fluidframework_tpu_torch.testing.apps import matrix_cells

        return matrix_cells(ch)
    raise KeyError(kind)


def containers_record(containers) -> list:
    """Every container's client id and data stores: each channel's type,
    value (``channel_value``) and ``snapshot()``."""
    out = []
    for c in containers:
        stores = {}
        for ds_id, ds in sorted(c.runtime.data_stores.items()):
            stores[ds_id] = {
                name: [ch.channel_type, channel_value(ch), ch.snapshot()]
                for name, ch in sorted(ds.channels.items())}
        out.append([c.client_id, stores])
    return out


class Twin:
    """One package's side of a parity test: a server with a fixed client
    id epoch and a clock at 0, a local-driver loader that remembers every
    container it resolves, and ``notes`` for values a scenario observes
    on the way. ``record()`` is what the two sides must agree on."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        st = stack(pkg)
        self.server = st.server()
        self.loader = st.Loader(st.LocalDocumentServiceFactory(self.server))
        self.containers = []
        self.notes = []
        resolve = self.loader.resolve

        def remembered(*args, **kw):
            c = resolve(*args, **kw)
            self.containers.append(c)
            return c

        self.loader.resolve = remembered

    def mod(self, name: str):
        return module(self.pkg, name)

    def note(self, *values) -> None:
        self.notes.append(list(values))

    def record(self) -> str:
        return map_client_ids([self.notes,
                               containers_record(self.containers)])


def twin(scenario) -> None:
    """Run ``scenario(Twin)`` on the JAX package, then on the port, and
    require equal records."""
    records = {}
    for pkg in ("jax", "torch"):
        t = Twin(pkg)
        scenario(t)
        records[pkg] = t.record()
    assert records["torch"] == records["jax"]


def jax_farm_server(clients, rng):
    """The JAX fixtures' merge-tree sequencer (``tests/mergetree_fixtures.py``:
    the same draws in the same order) keeping every sequenced message in
    ``log``, as the port's ``testing.farm.FarmServer`` does."""
    from tests.mergetree_fixtures import FarmServer

    from fluidframework_tpu.protocol import (
        MessageType,
        SequencedDocumentMessage,
    )

    class LoggingFarmServer(FarmServer):
        def __init__(self):
            super().__init__(clients, rng)
            self.log = []

        def sequence_one(self) -> bool:
            ready = [c for c in self.clients if c.outbound]
            if not ready:
                return False
            sender = self.rng.choice(ready)
            raw = sender.outbound.popleft()
            self.seq += 1
            self.client_ref[sender.name] = max(
                self.client_ref[sender.name], raw["refSeq"])
            msn = min(self.client_ref.values())
            msg = SequencedDocumentMessage(
                client_id=sender.name, sequence_number=self.seq,
                minimum_sequence_number=msn,
                client_sequence_number=raw["clientSeq"],
                reference_sequence_number=raw["refSeq"],
                type=MessageType.OPERATION, contents=raw["contents"])
            self.log.append(msg)
            for c in self.clients:
                c.client.apply_msg(msg)
            return True

    return LoggingFarmServer()


def farm_msg(m) -> tuple:
    """A sequenced farm message as plain values: sender, seq, clientSeq,
    refSeq, msn, type, wire contents."""
    return (m.client_id, m.sequence_number, m.client_sequence_number,
            m.reference_sequence_number, m.minimum_sequence_number,
            m.type.value, m.contents)


def segments(client) -> list:
    """Every segment of a merge-tree client, every stamp included."""
    return [(s.text, s.marker, dict(s.props), s.ins_seq, s.ins_client,
             s.ins_local_seq, s.rem_seq, s.rem_client,
             sorted(s.rem_clients), s.rem_local_seq, dict(s.pending_props))
            for s in client.tree.segments]


def side(pkg: str) -> SimpleNamespace:
    """One package's side of a service-level parity scenario: its stack
    (``stack``), a fixed-epoch server at clock 0, a local-driver loader
    on it, ``mod(name)`` for its modules and ``notes`` for what the
    scenario shows."""
    st = stack(pkg)
    server = st.server()
    notes: list = []
    return SimpleNamespace(
        pkg=pkg, st=st, server=server,
        loader=st.Loader(st.LocalDocumentServiceFactory(server)),
        mod=lambda name: module(pkg, name), notes=notes, note=notes.append)


def both(scenario, *args) -> None:
    """Run ``scenario(side(pkg), *args)`` on the JAX package, then on the
    port, and require equal notes."""
    notes = {}
    for pkg in ("jax", "torch"):
        s = side(pkg)
        scenario(s, *args)
        notes[pkg] = s.notes
    assert notes["torch"] == notes["jax"]
