"""MapKernel: the LWW key-store state machine shared by map + directory.

JAX counterpart: ``fluidframework_tpu/dds/map_kernel.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/map/src/mapKernel.ts:141 — one implementation of
optimistic local apply with pending-local masking, used by both SharedMap
and every SharedDirectory node (the reference shares mapKernel.ts between
them for the same reason).

Rules: local set/delete/clear apply immediately and mask the key (or the
whole store for clear) against remote ops until acked — the local op is
later in the total order, so it wins everywhere once sequenced.
"""

from __future__ import annotations

from typing import Any, Iterator


class MapKernel:
    def __init__(self):
        self.data: dict[str, Any] = {}
        self.pending_keys: dict[str, int] = {}
        self.pending_clear_count = 0

    # ---------------------------------------------------------- local ops

    def local_set(self, key: str, value: Any) -> None:
        self.data[key] = value
        self.pending_keys[key] = self.pending_keys.get(key, 0) + 1

    def local_delete(self, key: str) -> bool:
        existed = key in self.data
        self.data.pop(key, None)
        self.pending_keys[key] = self.pending_keys.get(key, 0) + 1
        return existed

    def local_clear(self) -> None:
        self.data.clear()
        self.pending_clear_count += 1

    # --------------------------------------------------------- ack / remote

    def ack(self, op: dict) -> None:
        """Our own op came back sequenced: drop its pending mask and
        RE-APPLY the op at its sequenced position (unless one of our later
        ops on the same key is still in flight and masks it).

        The re-apply is what keeps acked state a pure function of the
        sequenced stream even when the optimistic application was lost —
        e.g. a directory node remotely deleted and recreated while our op
        was in flight took our optimistic value with it, but every OTHER
        replica applies our sequenced op to the replacement node.
        Normally it just idempotently rewrites the value already there.
        """
        if op["op"] == "clear":
            if self.pending_clear_count > 0:
                self.pending_clear_count -= 1
            if self.pending_clear_count == 0:
                # keep optimistic values of still-pending keys (they
                # resequence after this clear), as in apply_remote
                self.data = {k: v for k, v in self.data.items()
                             if k in self.pending_keys}
            return
        key = op["key"]
        if key in self.pending_keys:
            self.pending_keys[key] -= 1
            if self.pending_keys[key] == 0:
                del self.pending_keys[key]
        if key not in self.pending_keys and self.pending_clear_count == 0:
            if op["op"] == "set":
                self.data[key] = op["value"]
            else:
                self.data.pop(key, None)

    def apply_remote(self, op: dict) -> bool:
        """Apply a remote op under the masking rules; True if state changed."""
        if op["op"] == "clear":
            if self.pending_keys:
                # keep optimistic values of in-flight keys: they resequence
                # after this clear
                self.data = {k: v for k, v in self.data.items()
                             if k in self.pending_keys}
            else:
                self.data.clear()
            return True
        key = op["key"]
        if self.pending_clear_count > 0 or key in self.pending_keys:
            return False  # our in-flight op is later in the order: it wins
        if op["op"] == "set":
            self.data[key] = op["value"]
        else:
            self.data.pop(key, None)
        return True

    # ------------------------------------------------------------- readers

    def get(self, key: str, default: Any = None) -> Any:
        return self.data.get(key, default)

    def has(self, key: str) -> bool:
        return key in self.data

    def keys(self) -> Iterator[str]:
        return iter(self.data.keys())
