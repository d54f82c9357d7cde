"""DDS interceptions: wrap a DDS so every local op passes a callback.

JAX counterpart: ``fluidframework_tpu/framework/interceptions.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/dds-interceptions — factory wrappers that
intercept DDS write APIs (e.g. to stamp attribution properties on every
string edit or map set) before the op is submitted
(createSharedStringWithInterception etc.).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..dds.map import SharedMap
from ..dds.string import SharedString


class intercepted_string:
    """Proxy over a SharedString whose writes pass through an interceptor
    that may amend properties (attribution stamping)."""

    def __init__(
        self,
        string: SharedString,
        props_interceptor: Callable[[Optional[dict]], dict],
    ):
        self._s = string
        self._intercept = props_interceptor

    def insert_text(self, pos: int, text: str, props: Optional[dict] = None) -> None:
        self._s.insert_text(pos, text, self._intercept(props))

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        self._s.annotate_range(start, end, self._intercept(props))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._s, name)


class intercepted_map:
    """Proxy over a SharedMap whose set() passes through a value
    interceptor."""

    def __init__(
        self,
        m: SharedMap,
        set_interceptor: Callable[[str, Any], Any],
    ):
        self._m = m
        self._intercept = set_interceptor

    def set(self, key: str, value: Any) -> None:
        self._m.set(key, self._intercept(key, value))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._m, name)
