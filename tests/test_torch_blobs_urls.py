"""The port's attachment blobs and URL resolver against the JAX
package's: binary payloads ride storage while handles ride ops, equal
content dedupes, and ``fluid://`` URLs bootstrap the whole client stack.

Each test is the twin of the test of the same name in
``tests/test_blobs_urls.py``: its scenario runs with the JAX test's
assertions on each package, and what it observes agrees between the
packages exactly (client ids mapped by first appearance). The URL boot
starts one process, the port's front end, and opens a document in it
through each package's ``open_url`` (the two speak the same wire).
"""

import subprocess
import sys
import time
from pathlib import Path

import pytest
from tests.torch_stack_fixtures import (
    containers_record,
    map_client_ids,
    module,
    twin,
)

ROOT = Path(__file__).resolve().parent.parent


def _blob_payloads_ride_storage_not_ops(t):
    blob_handle = t.mod("loader.blob_manager").BlobHandle
    c1 = t.loader.resolve("t", "doc")
    c2 = t.loader.resolve("t", "doc")
    kv1 = c1.runtime.create_data_store("default").create_channel(
        "kv", "shared-map")
    payload = b"\x89PNG" + bytes(range(256)) * 200  # > the 16KB op cap
    handle = c1.blob_manager.create_blob(payload, mime="image/png")
    kv1.set("logo", handle.to_value())

    kv2 = c2.runtime.get_data_store("default").get_channel("kv")
    got = blob_handle.from_value(kv2.get("logo"))
    assert got is not None and got.mime == "image/png"
    assert c2.blob_manager.get_blob(got) == payload
    # the op stream never carried the payload
    deltas = t.server.get_deltas("t", "doc", 0, 10**9)
    for m in deltas:
        assert b"PNG" not in str(m.contents).encode()
    t.note(handle.to_value(), len(deltas))


def test_blob_payloads_ride_storage_not_ops():
    twin(_blob_payloads_ride_storage_not_ops)


def _identical_content_dedupes(t):
    c = t.loader.resolve("t", "doc")
    h1 = c.blob_manager.create_blob(b"same bytes")
    h2 = c.blob_manager.create_blob(b"same bytes")
    assert h1.blob_id == h2.blob_id  # content addressing
    t.note(h1.blob_id, h2.to_value())


def test_identical_content_dedupes():
    twin(_identical_content_dedupes)


def _resolve_url(pkg: str) -> list:
    resolve_url = module(pkg, "loader.url_resolver").resolve_url
    r = resolve_url("fluid://127.0.0.1:7070/acme/design-doc")
    assert (r.host, r.port, r.tenant_id, r.document_id) == \
        ("127.0.0.1", 7070, "acme", "design-doc")
    out = [[r.host, r.port, r.tenant_id, r.document_id]]
    for bad in ("http://x:1/t/d", "fluid://x:1/only-tenant",
                "fluid://noport/t/d"):
        with pytest.raises(ValueError) as err:
            resolve_url(bad)
        out.append(str(err.value))
    return out


def test_resolve_url_parses_and_rejects():
    assert _resolve_url("torch") == _resolve_url("jax")


def _open_url(pkg: str, port: int) -> str:
    """Write through one package's ``open_url`` into its own doc of the
    port's front end, open it again, and return both containers'
    record once the second reads the text."""
    open_url = module(pkg, "loader.url_resolver").open_url
    doc = f"urldoc-{pkg}"
    c1 = open_url(f"fluid://127.0.0.1:{port}/t/{doc}")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "via url")
    c2 = open_url(f"fluid://127.0.0.1:{port}/t/{doc}")

    t0 = time.time()
    while time.time() - t0 < 10:
        ds = c2.runtime.data_stores.get("default")
        if ds and "text" in ds.channels and \
                ds.get_channel("text").get_text() == "via url":
            break
        time.sleep(0.02)
    assert c2.runtime.get_data_store("default") \
        .get_channel("text").get_text() == "via url"
    record = map_client_ids(containers_record([c1, c2]))
    c1.close()
    c2.close()
    return record


def test_open_url_boots_a_live_container():
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.front_end",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=str(ROOT))
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING"), line
        port = int(line.rsplit(":", 1)[1])
        assert _open_url("torch", port) == _open_url("jax", port)
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _summary_block_dirty_write_disqualifies_handle_reuse(t):
    summary_manager = t.mod("runtime.summarizer").SummaryManager
    c1 = t.loader.resolve("t", "doc")
    ds = c1.runtime.create_data_store("default")
    ds.create_channel("text", "shared-string").insert_text(0, "x")
    block = ds.create_channel("meta", "shared-summary-block")
    block.set("build", 41)
    sm = summary_manager(c1, max_ops=10**9)
    sm.summarize_now()
    sm.summarize_now()  # nothing changed: block rides as a handle
    reused = t.server.storage_stats["handles_reused"]
    assert reused >= 1

    block.set("build", 42)  # local-only write, no op
    sm.summarize_now()
    c2 = t.loader.resolve("t", "doc")
    # the new value traveled via the summary alone
    assert c2.runtime.get_data_store("default") \
        .get_channel("meta").get("build") == 42
    t.note(reused, dict(t.server.storage_stats))


def test_summary_block_dirty_write_disqualifies_handle_reuse():
    twin(_summary_block_dirty_write_disqualifies_handle_reuse)
