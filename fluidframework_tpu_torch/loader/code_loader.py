"""Code loader: the quorum-agreed container code → runtime factory.

JAX counterpart: ``fluidframework_tpu/loader/code_loader.py``; the port's copy,
imports rebased to this package.

Ref: the reference's containers carry their own code: clients propose
``IFluidCodeDetails`` through the quorum under the "code" key
(container.ts loadRuntimeFactory :1241 reads the accepted proposal), and
a code loader (web-code-loader: npm/cdn bundle fetch) turns the details
into the runtime factory that instantiates the container runtime. Every
client therefore runs the SAME code version, agreed through the same
total order as the data.

Python analog: packages are registered factories (the module registry is
the bundle store); the accepted quorum value picks which one boots the
runtime. Proposing an unregistered package fails boot on clients that
lack it — the same failure mode as a bundle fetch miss.
"""

from __future__ import annotations

from typing import Callable, Optional

CODE_KEY = "code"  # quorum key (ref: container.ts "code"/"code2" proposals)


class CodeLoader:
    """package name → ContainerRuntime factory registry."""

    def __init__(self):
        self._registry: dict[str, Callable] = {}

    def register(self, package: str, factory: Callable) -> "CodeLoader":
        self._registry[package] = factory
        return self

    def resolve(self, details) -> Callable:
        """Resolve code details ({"package": ..., "config": ...} or a
        bare package string) to a runtime factory."""
        package = details.get("package") if isinstance(details, dict) \
            else details
        factory = self._registry.get(package)
        if factory is None:
            raise KeyError(
                f"no code registered for package {package!r} "
                f"(have: {sorted(self._registry)})")
        return factory

    def factory_for(self, container) -> Optional[Callable]:
        """The factory for a container's ACCEPTED code proposal, or None
        when no proposal has committed (caller falls back to its default
        runtime factory)."""
        details = container.quorum.get(CODE_KEY)
        if details is None:
            return None
        return self.resolve(details)
