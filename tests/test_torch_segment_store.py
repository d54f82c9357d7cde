"""The port's backfill doors over the segment lane, twin of the two cases
of ``tests/test_segment_store.py`` no other port test holds (its native
segment, sanitizer, record-lane and block cases are held by
``test_torch_durable_log.py`` under the JAX test names).

``test_local_server_backfill_retention_boundary`` runs on each package
with the JAX test's assertions; the delta blocks' head and the refusal's
base are equal between them. ``test_network_backfill_door_columnar_
equals_scalar`` needs a socket: it runs the JAX test's assertions on the
port alone (its front end in process, as in the JAX test). Tolerance:
exact.
"""

import time

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both

from fluidframework_tpu_torch.driver import NetworkDocumentServiceFactory
from fluidframework_tpu_torch.driver.network import LogTruncatedError
from fluidframework_tpu_torch.loader import Loader
from fluidframework_tpu_torch.service import LocalServer, NetworkFrontEnd
from fluidframework_tpu_torch.service.durable_log import DurableLog


def _storage_snap(log):
    return {k: v for k, v in log.counters.snapshot().items()
            if k.startswith("storage.")}


def _delta(before, after, key):
    return after.get(key, 0) - before.get(key, 0)


def _retention_boundary(s, tmp_path):
    msgs = s.mod("protocol.messages")
    truncated = s.mod("service.scriptorium").LogTruncatedError
    log_dir = tmp_path / s.pkg
    log_dir.mkdir()
    server = s.st.server(log=s.mod("service.durable_log").DurableLog(
        str(log_dir)))
    conn = server.connect("t", "doc")
    for i in range(10):
        conn.submit([msgs.DocumentMessage(
            client_sequence_number=i + 1, reference_sequence_number=0,
            type=msgs.MessageType.OPERATION, contents={"i": i})])
    server.drain()
    orderer = server._get_orderer("t", "doc")
    orderer.scriptorium.truncate_below("t", "doc", 5)
    res = server.get_delta_blocks("t", "doc", 5, 100)
    assert res is not None
    _payloads, _legacy, head = res
    assert head == orderer.scriptorium.head_seq("t", "doc")
    with pytest.raises(truncated) as ei:
        server.get_delta_blocks("t", "doc", 4, 100)
    assert ei.value.base == 5
    s.note([head, ei.value.base, str(ei.value)])
    server.log.close()


def test_local_server_backfill_retention_boundary(tmp_path):
    both(_retention_boundary, tmp_path)


def test_network_backfill_door_columnar_equals_scalar(tmp_path):
    log = DurableLog(str(tmp_path))
    server = LocalServer(log=log)
    fe = NetworkFrontEnd(server).start_background()
    try:
        factory = NetworkDocumentServiceFactory("127.0.0.1", fe.port)
        loader = Loader(factory)
        c1 = loader.resolve("t", "doc1")
        s1 = c1.runtime.create_data_store("default") \
            .create_channel("text", "shared-string")
        for i in range(50):
            s1.insert_text(len(s1.get_text()), f"{i % 10}")
        deadline = time.time() + 10
        while time.time() < deadline and len(s1.get_text()) < 50:
            time.sleep(0.05)
        assert len(s1.get_text()) == 50
        svc = factory.create_document_service("t", "doc1")
        conn = svc.connect_to_delta_stream()
        assert conn.cols_backfill is True
        storage = svc.connect_to_delta_storage()
        before = _storage_snap(log)
        msgs = storage.get_deltas(0, 1000)
        seqs = [m.sequence_number for m in msgs]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        assert seqs == [m.sequence_number
                        for m in server.get_deltas("t", "doc1", 0, 1000)]
        sub = storage.get_deltas(10, 20)
        assert [m.sequence_number for m in sub] == \
            [m.sequence_number
             for m in server.get_deltas("t", "doc1", 10, 20)]
        after = _storage_snap(log)
        assert _delta(before, after, "storage.backfill.byterange") > 0
        assert _delta(before, after, "storage.segment.decodes") == 0
        orderer = server._get_orderer("t", "doc1")
        orderer.scriptorium.truncate_below("t", "doc1", 10)
        assert storage.get_deltas(10, 20)
        with pytest.raises(LogTruncatedError) as ei:
            storage.get_deltas(9, 20)
        assert ei.value.base == 10
        conn.close()
        c1.close()
    finally:
        fe.stop()
        log.close()
