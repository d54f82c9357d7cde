"""Summary-tree ⇄ content-addressed store codec, shared by every
storage backend.

JAX counterpart: ``fluidframework_tpu/service/summary_trees.py``; the port's copy,
imports rebased to this package.

Ref: server/routerlicious/packages/services-client/src/gitManager.ts:13 —
the reference stores summaries as git objects (blobs + tree nodes) and
both the in-proc test storage and the historian-backed production
storage share that shape. Here the same upload/materialize walk is one
module used by the in-proc LocalStorage (driver/local.py) and the
standalone storage process (service/storage_server.py).

Stored tree-node format: ``{"t": "tree", "e": {name: {"k", "id"}}}``;
refs are ``{"k": "tree"|"blob", "id": <content id>}``. A
``SummaryHandle`` resolves against the PARENT version's tree and
re-uploads nothing (protocol-definitions summary.ts incremental
contract).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Optional

from ..protocol.summary import (
    SummaryAttachment,
    SummaryBlob,
    SummaryHandle,
    SummaryTree,
)


def upload_summary_obj(blobs, obj, parent_root: Optional[dict],
                       stats: Optional[dict] = None) -> dict:
    """Recursively store a summary object; returns its ``{"k","id"}``
    ref. ``blobs`` needs ``put(bytes) -> id`` and ``get(id) -> bytes``;
    ``stats`` (optional) accumulates blobs_written / trees_written /
    handles_reused."""
    if stats is None:
        stats = {}
    if isinstance(obj, SummaryBlob):
        stats["blobs_written"] = stats.get("blobs_written", 0) + 1
        return {"k": "blob", "id": blobs.put(obj.content)}
    if isinstance(obj, SummaryAttachment):
        return {"k": "blob", "id": obj.id}
    if isinstance(obj, SummaryHandle):
        if parent_root is None:
            raise ValueError(
                f"summary handle {obj.handle!r} with no parent version")
        ref = resolve_handle_path(blobs.get, parent_root, obj.handle)
        stats["handles_reused"] = stats.get("handles_reused", 0) + 1
        return ref
    if isinstance(obj, SummaryTree):
        entries = {
            name: upload_summary_obj(blobs, child, parent_root, stats)
            for name, child in obj.tree.items()
        }
        node = json.dumps({"t": "tree", "e": entries},
                          sort_keys=True).encode()
        stats["trees_written"] = stats.get("trees_written", 0) + 1
        return {"k": "tree", "id": blobs.put(node)}
    raise TypeError(f"not a summary object: {obj!r}")


def resolve_handle_path(get: Callable[[str], bytes], root_ref: dict,
                        path: str) -> dict:
    """Walk stored tree nodes to the subtree ref a handle names. Parent
    trees were themselves uploaded with handles resolved, so the walk
    always lands on a concrete content id."""
    ref = root_ref
    for segment in path.strip("/").split("/"):
        if ref["k"] != "tree":
            raise KeyError(f"handle path {path!r}: {segment!r} is a blob")
        node = json.loads(get(ref["id"]).decode())
        if segment not in node["e"]:
            raise KeyError(f"handle path {path!r}: no entry {segment!r}")
        ref = node["e"][segment]
    return ref


def materialize_tree(get: Callable[[str], bytes], ref: dict) -> Any:
    """Expand a stored ref into the plain nested summary dict containers
    boot from."""
    if ref["k"] == "blob":
        return json.loads(get(ref["id"]).decode())
    node = json.loads(get(ref["id"]).decode())
    return {name: materialize_tree(get, child)
            for name, child in node["e"].items()}


def materialize_snapcols(get: Callable[[str], bytes], root: dict) -> dict:
    """Expand a columnar ``{"t": "snapcols"}`` version root into the
    classic nested boot dict: pull the content-addressed chunks, decode
    the columns, and rebuild the single-data-store container shape the
    loader already understands. This is the LEGACY-COMPAT read path —
    fast boots splice the framed chunk bytes straight off the wire and
    never come through here."""
    from ..protocol import snapcols

    chunks = [get(h) for h in root["chunks"]]
    mergetree = snapcols.decode_snapshot_chunks(
        chunks, root["min_seq"], root["tree_seq"])
    return {
        "protocol": root["protocol"],
        "runtime": {
            "dataStores": {
                root["ds"]: {
                    "pkg": root["pkg"],
                    "snapshot": {
                        "channels": {
                            root["channel"]: {
                                "type": "shared-string",
                                "snapshot": {
                                    "mergetree": mergetree,
                                    "intervals": {},
                                },
                            }
                        }
                    },
                }
            }
        },
        "sequence_number": root["sequence_number"],
    }
