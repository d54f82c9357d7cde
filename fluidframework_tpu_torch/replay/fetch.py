"""Fetch a LIVE document over the network into the file-driver layout.

JAX counterpart: ``fluidframework_tpu/replay/fetch.py``; the port's copy,
imports rebased to this package.

Ref: packages/tools/fetch-tool — downloads a service document's ops and
snapshots for offline analysis; the output here is exactly the replay
tool's input (driver/file.py layout), so a production doc fetched from
any deployment replays through the real client stack offline:

    python -m fluidframework_tpu_torch.replay.fetch --port P t doc --out DIR
    python -m fluidframework_tpu_torch.replay.tool DIR/t/doc   # then inspect

Works against any front door: the core directly, or a gateway (storage
RPCs relay through).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def fetch_document(host: str, port: int, tenant: str, doc: str,
                   out_dir: str, token_provider=None) -> str:
    from ..driver.file import write_doc_dir
    from ..driver.network import NetworkDocumentServiceFactory

    factory = NetworkDocumentServiceFactory(host, port,
                                            token_provider=token_provider,
                                            snapshot_cache=False)
    svc = factory.create_document_service(tenant, doc)
    try:
        # snapshot FIRST: a long-lived doc's log prefix is truncated by
        # summary-driven retention (scriptorium.truncate_below), and a
        # from-zero delta request would be refused with
        # LogTruncatedError. The acked summary always covers the
        # truncated prefix, so fetching the snapshot + the tail above
        # its sequence_number reconstructs the doc completely.
        snap = svc.connect_to_storage().get_snapshot_tree()
        base = snap["sequence_number"] if snap else 0
        msgs = svc.connect_to_delta_storage().get_deltas(base, 10 ** 9)
        return write_doc_dir(os.path.join(out_dir, tenant, doc),
                             msgs, snap)
    finally:
        # library callers fetch many docs per process: the RPC
        # transport (socket + reader thread) must not leak per doc
        if svc._rpc is not None:
            svc._rpc.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="fetch a live doc into the replay corpus layout")
    p.add_argument("tenant")
    p.add_argument("doc")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    doc_dir = fetch_document(args.host, args.port, args.tenant, args.doc,
                             args.out)
    n = len(json.load(open(os.path.join(doc_dir, "messages.json"))))
    print(f"fetched {args.tenant}/{args.doc}: {n} ops -> {doc_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
