"""SharedDirectory: hierarchical SharedMaps with subdirectory ops.

JAX counterpart: ``fluidframework_tpu/dds/directory.py``; the port's copy,
imports rebased to this package.

Ref: packages/dds/map/src/directory.ts:371 — a tree of named
subdirectories, each holding its own LWW key store. The kernel logic is
shared with SharedMap (map_kernel.MapKernel, as the reference shares
mapKernel.ts). Subdirectory create/delete follow the SAME pending-masking
rule as keys — an in-flight local create/delete of a name masks remote
ops on that name — and ops addressed to a path that does not exist are
DROPPED, never resurrected: a sequenced deleteSubdir deterministically
kills the whole subtree (and any interior ops) on every replica.

Wire ops carry an absolute ``path`` (["a","b"] = /a/b):
{"op": "set"/"delete"/"clear", "path", ...} |
{"op": "createSubdir"/"deleteSubdir", "path", "name"}.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from ..protocol.messages import SequencedDocumentMessage
from .map_kernel import MapKernel
from .registry import register_channel_type
from .shared_object import SharedObject


class SubDirectory:
    def __init__(self, root: "SharedDirectory", path: tuple[str, ...]):
        self._root = root
        self._path = path
        self._kernel = MapKernel()
        self._subdirs: dict[str, "SubDirectory"] = {}
        self._pending_subdirs: dict[str, int] = {}  # name → in-flight ops

    # ------------------------------------------------------------- values

    def set(self, key: str, value: Any) -> None:
        self._kernel.local_set(key, value)
        self._root._submit_dir_op(
            {"op": "set", "path": list(self._path), "key": key, "value": value})

    def delete(self, key: str) -> bool:
        existed = self._kernel.local_delete(key)
        self._root._submit_dir_op(
            {"op": "delete", "path": list(self._path), "key": key})
        return existed

    def clear(self) -> None:
        self._kernel.local_clear()
        self._root._submit_dir_op({"op": "clear", "path": list(self._path)})

    def get(self, key: str, default: Any = None) -> Any:
        return self._kernel.get(key, default)

    def has(self, key: str) -> bool:
        return self._kernel.has(key)

    def keys(self) -> Iterator[str]:
        return self._kernel.keys()

    # -------------------------------------------------------- subdirectories

    def create_subdirectory(self, name: str) -> "SubDirectory":
        if name not in self._subdirs:
            self._subdirs[name] = SubDirectory(self._root, self._path + (name,))
            self._pending_subdirs[name] = self._pending_subdirs.get(name, 0) + 1
            self._root._submit_dir_op(
                {"op": "createSubdir", "path": list(self._path), "name": name})
        return self._subdirs[name]

    def delete_subdirectory(self, name: str) -> bool:
        existed = name in self._subdirs
        self._subdirs.pop(name, None)
        self._pending_subdirs[name] = self._pending_subdirs.get(name, 0) + 1
        self._root._submit_dir_op(
            {"op": "deleteSubdir", "path": list(self._path), "name": name})
        return existed

    def get_subdirectory(self, name: str) -> Optional["SubDirectory"]:
        return self._subdirs.get(name)

    def subdirectories(self):
        return self._subdirs.items()

    # ------------------------------------------------------------ internal

    def _snapshot(self) -> dict:
        return {
            "data": dict(self._kernel.data),
            "subdirs": {n: d._snapshot() for n, d in self._subdirs.items()},
        }

    def _load(self, snap: dict) -> None:
        self._kernel.data = dict(snap.get("data", {}))
        for name, sub in snap.get("subdirs", {}).items():
            d = SubDirectory(self._root, self._path + (name,))
            d._load(sub)
            self._subdirs[name] = d


@register_channel_type
class SharedDirectory(SharedObject):
    channel_type = "shared-directory"

    def __init__(self, channel_id: str):
        super().__init__(channel_id)
        self.root = SubDirectory(self, ())
        self._pending_ops: list[dict] = []

    # root-level conveniences (the directory IS a map at its root)
    def set(self, key: str, value: Any) -> None:
        self.root.set(key, value)

    def get(self, key: str, default: Any = None) -> Any:
        return self.root.get(key, default)

    def delete(self, key: str) -> bool:
        return self.root.delete(key)

    def has(self, key: str) -> bool:
        return self.root.has(key)

    def create_subdirectory(self, name: str) -> SubDirectory:
        return self.root.create_subdirectory(name)

    def delete_subdirectory(self, name: str) -> bool:
        return self.root.delete_subdirectory(name)

    def get_subdirectory(self, name: str) -> Optional[SubDirectory]:
        return self.root.get_subdirectory(name)

    def get_working_directory(self, path: str) -> Optional[SubDirectory]:
        """Resolve an absolute path like "/a/b" (ref: directory.ts)."""
        node: Optional[SubDirectory] = self.root
        for part in [p for p in path.split("/") if p]:
            if node is None:
                return None
            node = node.get_subdirectory(part)
        return node

    # ------------------------------------------------------------ internal

    def _submit_dir_op(self, op: dict) -> None:
        self._pending_ops.append(op)
        self.submit_local_message(op)

    def _resolve(self, path: list[str]) -> Optional[SubDirectory]:
        node = self.root
        for part in path:
            node = node._subdirs.get(part)
            if node is None:
                return None  # never resurrect a deleted subtree
        return node

    def _resolve_remote(self, path: list[str]) -> Optional[SubDirectory]:
        """Resolution for REMOTE ops: a pending local create/delete on any
        path component masks the whole subtree — our sequenced-later op
        will decide that subtree's fate on every replica, so interior
        remote ops must not land only here."""
        node = self.root
        for part in path:
            if part in node._pending_subdirs:
                return None
            node = node._subdirs.get(part)
            if node is None:
                return None
        return node

    def process_core(self, msg: SequencedDocumentMessage, local: bool) -> None:
        op = msg.contents
        if local:
            # release the mask and RE-APPLY at the sequenced position
            # (map_kernel.ack semantics): if a remote delete+recreate of
            # the node swallowed our optimistic application, the sequenced
            # op still lands on the replacement, as on every other replica
            head = self._pending_ops.pop(0)
            d = self._resolve(head["path"])
            if d is not None:
                if head["op"] in ("set", "delete", "clear"):
                    d._kernel.ack(head)
                else:
                    name = head["name"]
                    if name in d._pending_subdirs:
                        d._pending_subdirs[name] -= 1
                        if d._pending_subdirs[name] == 0:
                            del d._pending_subdirs[name]
                    if name not in d._pending_subdirs:
                        if head["op"] == "createSubdir":
                            if name not in d._subdirs:
                                d._subdirs[name] = SubDirectory(
                                    self, d._path + (name,))
                        else:
                            d._subdirs.pop(name, None)
            return

        d = self._resolve_remote(op["path"])
        if d is None:
            return  # path deleted, never created here, or locally masked
        kind = op["op"]
        if kind in ("createSubdir", "deleteSubdir"):
            name = op["name"]
            if name in d._pending_subdirs:
                return  # our in-flight create/delete is later: it wins
            if kind == "createSubdir":
                if name not in d._subdirs:
                    d._subdirs[name] = SubDirectory(self, d._path + (name,))
                self._emit("subDirectoryCreated",
                           {"path": op["path"], "name": name})
            else:
                d._subdirs.pop(name, None)
                self._emit("subDirectoryDeleted",
                           {"path": op["path"], "name": name})
            return
        if d._kernel.apply_remote(op):
            if kind == "clear":
                self._emit("clear", {"path": op["path"], "local": False})
            else:
                self._emit("valueChanged",
                           {"path": op["path"], "key": op["key"], "local": False})

    def resubmit_pending(self) -> None:
        for op in self._pending_ops:
            self.submit_local_message(op)

    def snapshot(self) -> dict:
        return self.root._snapshot()

    def load_core(self, snap: dict) -> None:
        self.root._load(snap)
