"""Dependency synthesis: typed provider registry for data objects.

JAX counterpart: ``fluidframework_tpu/framework/synthesize.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/synthesize — a DI container mapping provider
symbols to instances/factories, with optional vs required synthesis
(dependencyContainer.ts). Data objects declare what they consume
(logger, config, services) and hosts register providers once; parent
scopes chain, so a host-level container can back many containers.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class DependencyContainer:
    def __init__(self, parent: Optional["DependencyContainer"] = None):
        self._parent = parent
        self._providers: dict[str, Any] = {}
        self._factories: dict[str, Callable[[], Any]] = {}

    def register(self, symbol: str, provider: Any) -> "DependencyContainer":
        self._providers[symbol] = provider
        return self

    def register_factory(self, symbol: str,
                         factory: Callable[[], Any]) -> "DependencyContainer":
        """Lazily constructed, then cached (singleton per container)."""
        self._factories[symbol] = factory
        return self

    def has(self, symbol: str) -> bool:
        return (symbol in self._providers or symbol in self._factories
                or (self._parent is not None and self._parent.has(symbol)))

    def resolve(self, symbol: str) -> Any:
        if symbol in self._providers:
            return self._providers[symbol]
        if symbol in self._factories:
            value = self._factories.pop(symbol)()
            self._providers[symbol] = value
            return value
        if self._parent is not None:
            return self._parent.resolve(symbol)
        raise KeyError(f"no provider for {symbol!r}")

    def synthesize(self, required: tuple = (), optional: tuple = ()) -> dict:
        """Build the dependency dict a data object consumes: required
        symbols must resolve (KeyError otherwise), optional ones fill
        with None (ref: synthesize required/optional split)."""
        out = {symbol: self.resolve(symbol) for symbol in required}
        for symbol in optional:
            out[symbol] = self.resolve(symbol) if self.has(symbol) else None
        return out
