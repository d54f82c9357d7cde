"""Shared by the client-stack and summarizer parity tests: the two
packages' client stacks side by side, and a canonical form of what a
``LocalServer`` stores, so that the JAX package's and the port's servers
can be compared value by value."""

from __future__ import annotations

import dataclasses
import enum
from types import SimpleNamespace


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


def stored(server, skip=("history-records/",)) -> dict:
    """Every db collection and log topic of a server (the log's records
    through its public ``length``/``read``), canonical, without the
    collections whose names start with one of ``skip``."""
    out = {}
    for name, col in server.db.collections.items():
        if not name.startswith(skip):
            out["db:" + name] = canonical(col)
    for topic in sorted(server.log._topics):
        out["log:" + topic] = [canonical(server.log.read(topic, i))
                               for i in range(server.log.length(topic))]
    return out
