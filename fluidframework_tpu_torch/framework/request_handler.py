"""Request routing: URL-path access into a container's object graph.

JAX counterpart: ``fluidframework_tpu/framework/request_handler.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/request-handler + RequestParser
(runtime-utils) — containers expose their data stores/channels through
composable path handlers ("/default/text" → that channel), the same
surface hosts use to wire views. Handlers compose first-match-wins.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

Handler = Callable[[list[str], Any], Optional[Any]]


def parse_request(url: str) -> list[str]:
    return [p for p in url.split("/") if p]


class RequestRouter:
    """First-match-wins handler chain (ref: buildRuntimeRequestHandler)."""

    def __init__(self, container):
        self.container = container
        self._handlers: list[Handler] = [self._data_store_handler]

    def add_handler(self, handler: Handler) -> "RequestRouter":
        # custom handlers run BEFORE the default object-graph walk
        self._handlers.insert(0, handler)
        return self

    def request(self, url: str) -> Any:
        parts = parse_request(url)
        for handler in self._handlers:
            result = handler(parts, self.container)
            if result is not None:
                return result
        raise KeyError(f"no handler resolved {url!r}")

    @staticmethod
    def _data_store_handler(parts: list[str], container) -> Optional[Any]:
        """/<dataStore>[/<channel>] → runtime objects."""
        if not parts:
            return container.runtime
        ds = container.runtime.data_stores.get(parts[0])
        if ds is None:
            return None
        if len(parts) == 1:
            return ds
        if len(parts) == 2 and parts[1] in ds.channels:
            return ds.get_channel(parts[1])
        return None
