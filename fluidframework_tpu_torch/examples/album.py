"""album: a collaborative image collection over blobs + a shared map.

JAX counterpart: ``examples/album.py``; the port's copy, imports
rebased to this package, its command lines naming the port's
modules (the dev host ``fluidframework_tpu_torch.host`` loads it by
name).

Ref: examples/data-objects/image-collection — the reference's image
collection data object keeps an ordered set of image components whose
payloads ride STORAGE (attachment blobs), not the op stream. Here the
same split: each photographer process uploads image bytes as
content-addressed attachment blobs (loader/blob_manager.py,
blobManager.ts role) and publishes only the handle + caption into a
``shared-map``; viewers resolve handles back to the exact bytes. The
convergence check proves every replica sees every entry AND that the
payloads round-trip bit-exact through the blob path — op-stream
convergence alone would not catch a storage-side corruption.

    python -m fluidframework_tpu_torch.examples.album  # demo: 3 photographers
    python -m fluidframework_tpu_torch.examples.album \
        --connect PORT [--create] --name N
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

from ..driver.network import NetworkDocumentServiceFactory
from ..loader import Loader
from ..loader.blob_manager import BlobHandle

DOC_ID = "album-demo"
PHOTOS_PER_CLIENT = 3


def wait_until(cond, timeout=90.0):  # acks stretch under load
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(0.02)
    return False


def fake_image(name: str, i: int) -> bytes:
    """Deterministic pseudo-image payload (a few KB, binary)."""
    seed = f"{name}-{i}".encode()
    out = bytearray(b"\x89PNG\r\n\x1a\n")
    block = seed
    while len(out) < 4096:
        block = hashlib.sha256(block).digest()
        out.extend(block)
    return bytes(out)


def open_album(port: int, creator: bool):
    loader = Loader(NetworkDocumentServiceFactory("127.0.0.1", port))
    container = loader.resolve("demo", DOC_ID)
    if creator:
        ds = container.runtime.create_data_store("default")
        album = ds.create_channel("album", "shared-map")
    else:
        if not wait_until(
                lambda: "default" in container.runtime.data_stores
                and "album" in container.runtime
                .get_data_store("default").channels):
            raise SystemExit("album never replicated")
        album = container.runtime.get_data_store(
            "default").get_channel("album")
    return container, album


def run_photographer(port: int, name: str, creator: bool) -> None:
    container, album = open_album(port, creator)
    if creator:
        print("READY", flush=True)
    wait_until(lambda: container.connected)
    for i in range(PHOTOS_PER_CLIENT):
        payload = fake_image(name, i)
        handle = container.blob_manager.create_blob(payload,
                                                    mime="image/png")
        album.set(f"{name}-{i}", {
            "caption": f"{name}'s photo {i}",
            "blob": handle.to_value(),
            "sha": hashlib.sha256(payload).hexdigest(),
        })
    if not wait_until(lambda: container.runtime.pending.count == 0):
        raise SystemExit("album entries never acked")
    print(json.dumps({"name": name, "uploaded": PHOTOS_PER_CLIENT}))


def run_clients(port: int, n_procs: int = 3) -> int:
    """Drive the photographers against an ALREADY-RUNNING service on
    ``port`` (any topology — the dev host owns the deployment shape)."""
    def spawn(name, creator):
        args = [sys.executable, "-m",
                "fluidframework_tpu_torch.examples.album",
                "--connect", str(port), "--name", name]
        if creator:
            args.append("--create")
        return subprocess.Popen(args, stdout=subprocess.PIPE,
                                stderr=sys.stderr, text=True)

    names = ["ana", "bo", "chi", "dee"][:n_procs]
    first = spawn(names[0], True)
    assert first.stdout.readline().strip() == "READY"
    procs = [first] + [spawn(n, False) for n in names[1:]]
    try:
        for p in procs:
            p.communicate(timeout=220)
            if p.returncode != 0:
                print(f"photographer failed rc={p.returncode}")
                return 1
    finally:
        for p in procs:  # a hung photographer must not outlive the run
            if p.poll() is None:
                p.kill()

    # a fresh viewer: every entry present, every payload bit-exact
    container, album = open_album(port, creator=False)
    want = n_procs * PHOTOS_PER_CLIENT
    if not wait_until(lambda: len(list(album.keys())) >= want):
        print(f"DIVERGED: {len(list(album.keys()))} of {want} entries")
        return 1
    for key in sorted(album.keys()):
        entry = album.get(key)
        handle = BlobHandle.from_value(entry["blob"])
        payload = container.blob_manager.get_blob(handle)
        if hashlib.sha256(payload).hexdigest() != entry["sha"]:
            print(f"DIVERGED: blob {key} corrupt")
            return 1
        name, i = key.rsplit("-", 1)
        if payload != fake_image(name, int(i)):
            print(f"DIVERGED: blob {key} wrong content")
            return 1
    print(f"CONVERGED: {want} photos, all payloads bit-exact "
          f"through the blob path")
    return 0


def run_demo(n_procs: int = 3) -> int:
    server = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = server.stdout.readline().strip()
        port = int(line.rsplit(":", 1)[1])
        return run_clients(port, n_procs)
    finally:
        server.terminate()
        server.wait(timeout=10)


def main() -> None:
    p = argparse.ArgumentParser(description="album demo")
    p.add_argument("--connect", type=int)
    p.add_argument("--name", default="solo")
    p.add_argument("--create", action="store_true")
    args = p.parse_args()
    if args.connect:
        run_photographer(args.connect, args.name, args.create)
    else:
        raise SystemExit(run_demo())


if __name__ == "__main__":
    main()
