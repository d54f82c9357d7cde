"""BlobManager: attachment blobs (binary payloads outside the op stream).

JAX counterpart: ``fluidframework_tpu/loader/blob_manager.py``; the port's copy,
imports rebased to this package.

Ref: loader/container-loader/src/blobManager.ts — large binary content
(images, files) never rides ops: the client uploads it to the
content-addressed store, gets back a handle, and stores the HANDLE in a
DDS; readers fetch the payload through storage on demand. Payload
delivery cost is off the sequencer entirely, and identical content
dedupes by address.

The 16 KB op cap (config.max_message_size) is the forcing function: a
payload over the cap nacks at the front door, an attachment handle never
does.
"""

from __future__ import annotations

from typing import Optional


class BlobHandle:
    """A stored blob's address + mime tag, as kept inside DDS values."""

    KIND = "fluid-blob"

    def __init__(self, blob_id: str, mime: str = "application/octet-stream"):
        self.blob_id = blob_id
        self.mime = mime

    def to_value(self) -> dict:
        return {"kind": self.KIND, "id": self.blob_id, "mime": self.mime}

    @classmethod
    def from_value(cls, value: dict) -> Optional["BlobHandle"]:
        if isinstance(value, dict) and value.get("kind") == cls.KIND:
            return cls(value["id"], value.get("mime", ""))
        return None


class BlobManager:
    def __init__(self, storage):
        self._storage = storage
        self._cache: dict[str, bytes] = {}

    def create_blob(self, content: bytes,
                    mime: str = "application/octet-stream") -> BlobHandle:
        """Upload to the content-addressed store; identical content maps
        to the identical handle (dedupe is the store's sha addressing)."""
        blob_id = self._storage.write_blob(content)
        self._cache[blob_id] = content
        return BlobHandle(blob_id, mime)

    def get_blob(self, handle) -> bytes:
        blob_id = handle.blob_id if isinstance(handle, BlobHandle) \
            else (handle["id"] if isinstance(handle, dict) else handle)
        cached = self._cache.get(blob_id)
        if cached is None:
            cached = self._cache[blob_id] = self._storage.read_blob(blob_id)
        return cached
