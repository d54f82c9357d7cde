"""URL resolution: document URLs → driver endpoints.

JAX counterpart: ``fluidframework_tpu/loader/url_resolver.py``; the port's copy,
imports rebased to this package.

Ref: packages/drivers/*-urlResolver (routerlicious-urlResolver parses
https://host/tenant/doc into an IFluidResolvedUrl the driver factory
consumes). The scheme here:

    fluid://host:port/tenant/document

``open_url`` is the whole client bootstrap in one call: parse → network
driver factory → loader → container.
"""

from __future__ import annotations

from dataclasses import dataclass
from urllib.parse import urlparse


@dataclass(frozen=True)
class ResolvedUrl:
    host: str
    port: int
    tenant_id: str
    document_id: str


def resolve_url(url: str) -> ResolvedUrl:
    parsed = urlparse(url)
    if parsed.scheme != "fluid":
        raise ValueError(f"not a fluid:// url: {url!r}")
    parts = [p for p in parsed.path.split("/") if p]
    if parsed.hostname is None or parsed.port is None or len(parts) != 2:
        raise ValueError(
            f"expected fluid://host:port/tenant/document, got {url!r}")
    return ResolvedUrl(parsed.hostname, parsed.port, parts[0], parts[1])


def open_url(url: str, token_provider=None, connect: bool = True,
             runtime_factory=None, code_loader=None):
    """Parse, wire the network driver, and load the container."""
    from ..driver.network import NetworkDocumentServiceFactory
    from .container import Loader

    r = resolve_url(url)
    loader = Loader(
        NetworkDocumentServiceFactory(r.host, r.port,
                                      token_provider=token_provider),
        runtime_factory=runtime_factory,
        code_loader=code_loader,
    )
    return loader.resolve(r.tenant_id, r.document_id, connect=connect)
