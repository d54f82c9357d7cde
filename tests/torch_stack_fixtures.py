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
