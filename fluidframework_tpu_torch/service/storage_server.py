"""Standalone storage process: blob/tree/commit/ref RPCs + read cache.

JAX counterpart: ``fluidframework_tpu/service/storage_server.py``; the
port's copy, imports rebased to this package, with the placement table
door (``--table-dir``, ``--shards``, ``--lease-ttl`` and
``StorageServer(table_door=...)``) that the sharded core's
``table_client.RemoteTableClient`` reaches.

Ref: the reference's storage micro-services — gitrest (the object
store, server/gitrest/src/routes/git) behind historian (the caching
proxy, server/historian, services-client/src/historian.ts:29) — run as
their own deployments; the ordering service and every client reach
summaries only through them. This process is both roles in one: the
native C++ chunk store holds blobs/trees/commits (content-addressed,
crash-safe), GitStore holds the commit DAG + durable refs, and an LRU
over blob reads is the historian cache (hit stats served over RPC).

Wire protocol: the framed JSON request/response used by the rest of the
service (front_end.py framing; every request carries a ``rid`` echoed
in the reply).

Deployment:

    python -m fluidframework_tpu_torch.service.storage_server --dir DATA \
        [--port N]

The ordering core connects with ``front_end --storage-server PORT``;
clients then boot from the doc's named ref via this process.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import os
from typing import Optional

from ..native import NativeOpLog
from ..protocol.summary import (
    SummaryAttachment,
    SummaryBlob,
    SummaryHandle,
    SummaryTree,
    is_summary_wire,
    summary_from_wire,
)
from .blob_store import NativeBlobStore
from .front_end import _encode_frame, _read_body
from .git_store import GitStore, head_ref
from .summary_trees import (
    materialize_snapcols,
    materialize_tree,
    upload_summary_obj,
)

CACHE_SIZE = 4096


class StorageService:
    """The RPC surface, transport-independent (tests drive it directly)."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.blobs = NativeBlobStore(directory)
        self._refs_log = NativeOpLog(directory + "/refs")
        self.git = GitStore(self.blobs, refs_log=self._refs_log)
        self.stats = {"blobs_written": 0, "trees_written": 0,
                      "handles_reused": 0}
        # historian-role read cache: blobs are content-addressed and
        # immutable, so an LRU needs no invalidation ever
        self._cached_get = functools.lru_cache(maxsize=CACHE_SIZE)(
            self.blobs.get)

    def read_blob(self, blob_id: str) -> bytes:
        return self._cached_get(blob_id)

    def write_blob(self, content: bytes) -> str:
        return self.blobs.put(content)

    def upload_summary(self, tenant: str, doc: str, summary,
                       parent: Optional[str]) -> dict:
        """Store a summary as tree objects + an (unacked) commit whose
        parent is the prior version's commit; returns the version
        record. The commit joins the ref chain only when the scribe
        acks it (commit_ref)."""
        if is_summary_wire(summary):
            summary = summary_from_wire(summary)
        parent_meta = {}
        parent_root = None
        if parent is not None:
            pc = self.git.read_commit(parent)
            parent_meta = pc.get("meta", {})
            parent_root = {"k": "tree", "id": pc["tree"]}
        if isinstance(summary, (SummaryTree, SummaryBlob, SummaryHandle,
                                SummaryAttachment)):
            class _CountingBlobs:
                put = staticmethod(self.blobs.put)
                get = staticmethod(self.read_blob)
            root = upload_summary_obj(_CountingBlobs, summary, parent_root,
                                      self.stats)
            tree_id = root["id"]
        else:
            # legacy monolithic dict summary
            tree_id = self.blobs.put(json.dumps(summary).encode())
        n = parent_meta.get("n", -1) + 1
        commit_id = self.git.write_commit(
            tree_id, [parent] if parent else [],
            meta={"n": n, "tenant": tenant, "doc": doc})
        return {"id": commit_id,
                "record": {"n": n, "tree_id": tree_id, "parent": parent}}

    def commit_ref(self, tenant: str, doc: str, commit_id: str) -> None:
        """Advance the doc's named head — the scribe-ack ref update."""
        self.git.read_commit(commit_id)  # refuse dangling refs
        self.git.set_ref(head_ref(tenant, doc), commit_id)

    def get_ref(self, tenant: str, doc: str) -> Optional[str]:
        return self.git.get_ref(head_ref(tenant, doc))

    def get_versions(self, tenant: str, doc: str, count: int = 1) -> list:
        head = self.get_ref(tenant, doc)
        if head is None:
            return []
        return [{"id": c["id"], "tree_id": c["tree"]}
                for c in self.git.history(head, limit=count)]

    def history(self, tenant: str, doc: str, count: int = 50) -> list:
        head = self.get_ref(tenant, doc)
        return [] if head is None else self.git.history(head, limit=count)

    def get_tree(self, tenant: str, doc: str,
                 version: Optional[dict] = None):
        if version is None:
            versions = self.get_versions(tenant, doc, 1)
            if not versions:
                return None
            version = versions[0]
        raw = json.loads(self.read_blob(version["tree_id"]).decode())
        if raw.get("t") == "snapcols":
            return materialize_snapcols(self.read_blob, raw)
        if raw.get("t") != "tree":
            return raw  # legacy single-blob summary
        return materialize_tree(self.read_blob,
                                {"k": "tree", "id": version["tree_id"]})

    def cache_stats(self) -> dict:
        info = self._cached_get.cache_info()
        return {"hits": info.hits, "misses": info.misses,
                "cached": info.currsize, **self.stats,
                **self.blobs.stats.as_dict()}

    def close(self) -> None:
        """Release the chunk store and the reflog handles."""
        self.blobs.close()
        self._refs_log.close()

    # ------------------------------------------------------------ dispatch

    def handle(self, frame: dict) -> dict:
        t = frame.get("t")
        tenant, doc = frame.get("tenant"), frame.get("doc")
        if t == "read_blob":
            return {"t": "blob", "hex": self.read_blob(frame["id"]).hex()}
        if t == "write_blob":
            return {"t": "blob_id",
                    "id": self.write_blob(bytes.fromhex(frame["hex"]))}
        if t == "upload_summary":
            out = self.upload_summary(tenant, doc, frame["summary"],
                                      frame.get("parent"))
            return {"t": "version_id", **out}
        if t == "commit_ref":
            self.commit_ref(tenant, doc, frame["id"])
            return {"t": "ok"}
        if t == "get_ref":
            return {"t": "ref", "id": self.get_ref(tenant, doc)}
        if t == "get_versions":
            return {"t": "versions",
                    "versions": self.get_versions(tenant, doc,
                                                  frame.get("count", 1))}
        if t == "history":
            return {"t": "history",
                    "commits": self.history(tenant, doc,
                                            frame.get("count", 50))}
        if t == "get_tree":
            return {"t": "tree",
                    "tree": self.get_tree(tenant, doc,
                                          frame.get("version"))}
        if t == "stats":
            return {"t": "stats", "stats": self.cache_stats()}
        raise ValueError(f"unknown storage rpc {t!r}")


class StorageServer:
    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0, table_door=None):
        self.service = StorageService(directory)
        self.host, self.port = host, port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # placement table door (service/table_client.TableDoorService):
        # when set, ``admin_table_*`` frames are served on THIS socket —
        # the placement host's flock keeps serializing every table
        # write, remote host groups just reach it over the wire
        self.table_door = table_door

    async def _handle_conn(self, reader, writer) -> None:
        try:
            while True:
                body = await _read_body(reader)
                if body is None:
                    break
                frame = json.loads(body.decode())
                rid = frame.get("rid")
                try:
                    if self.table_door is not None and str(
                            frame.get("t", "")).startswith("admin_table_"):
                        reply = self.table_door.handle(frame)
                    else:
                        reply = self.service.handle(frame)
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    reply = {"t": "error", "message": str(e)}
                reply["rid"] = rid
                writer.write(_encode_frame(reply))
                await writer.drain()
        except (ValueError, json.JSONDecodeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def serve_forever(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def start():
            server = await asyncio.start_server(
                self._handle_conn, self.host, self.port, backlog=256)
            self.port = server.sockets[0].getsockname()[1]
            return server

        server = loop.run_until_complete(start())
        self._loop = loop
        print(f"LISTENING {self.host}:{self.port}", flush=True)
        try:
            loop.run_forever()
        finally:
            server.close()
            # open connections end with their handlers
            tasks = asyncio.all_tasks(loop)
            for task in tasks:
                task.cancel()
            loop.run_until_complete(
                asyncio.gather(*tasks, return_exceptions=True))
            loop.close()
            self.service.close()

    def stop(self) -> None:
        """End :meth:`serve_forever` from another thread; it closes the
        listener and the stores before it returns."""
        self._loop.call_soon_threadsafe(self._loop.stop)


def main() -> None:
    p = argparse.ArgumentParser(
        description="Fluid storage process (PyTorch port)")
    p.add_argument("--dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--table-dir", default=None,
                   help="serve the placement table door (admin_table_*) "
                        "over this shard dir's flocked lease/epoch files")
    p.add_argument("--shards", type=int, default=0,
                   help="partition count for the table door")
    p.add_argument("--lease-ttl", type=float, default=None,
                   help="lease TTL for the table door's PlacementDir")
    args = p.parse_args()
    door = None
    if args.table_dir:
        from .placement import DEFAULT_TTL_S
        from .table_client import TableDoorService

        door = TableDoorService(
            args.table_dir, args.shards,
            ttl_s=(args.lease_ttl if args.lease_ttl is not None
                   else DEFAULT_TTL_S))
    StorageServer(args.dir, host=args.host, port=args.port,
                  table_door=door).serve_forever()


if __name__ == "__main__":
    main()
