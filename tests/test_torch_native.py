"""The port's durable service restart, twin of
``tests/test_native.py::test_durable_service_survives_process_restart``.

The op log's own cases (append and read, reopen, torn records and index
entries, the fd cap, escaped payloads, the message codec) are held by
``test_torch_durable_log.py`` under the JAX test names, the chunk store's
by ``test_torch_storage.py``, and the truncated-retention restart by
``test_torch_service_summarizer.py``. Here each package's ``LocalServer``
over a ``DurableLog`` is written, closed and reopened as a new process
would reopen it, with the JAX test's assertions on both; the texts, the
seqs, the deltas topic's length and everything the reopened server
stored (``torch_stack_fixtures.stored``) are equal between the packages.
Tolerance: exact.
"""

import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import both, canonical


def _survives_restart(s, tmp_path):
    durable_log = s.mod("service.durable_log").DurableLog
    path = str(tmp_path / f"service-log-{s.pkg}")
    server = s.st.server(log=durable_log(path))
    loader = s.st.Loader(s.st.LocalDocumentServiceFactory(server))
    c1 = loader.resolve("t", "doc")
    s1 = c1.runtime.create_data_store("default").create_channel(
        "text", "shared-string")
    s1.insert_text(0, "durable")
    server.checkpoint_all()
    server.log.sync()
    seq_before = server._orderers["t/doc"].deli.sequence_number
    deltas_before = server.log.length("deltas/t/doc")
    server.log.close()
    del server

    server2 = s.st.server(log=durable_log(path))
    # a new process hands out ids of its own epoch
    server2._client_epoch = "e1"
    loader2 = s.st.Loader(s.st.LocalDocumentServiceFactory(server2))
    c2 = loader2.resolve("t", "doc")
    s2 = c2.runtime.get_data_store("default").get_channel("text")
    assert s2.get_text() == "durable"
    orderer = server2._orderers["t/doc"]
    assert orderer.deli.sequence_number > seq_before
    joins_etc_after = server2.log.length("deltas/t/doc") - deltas_before
    assert joins_etc_after == 1
    s2.insert_text(0, "still ")
    assert s2.get_text() == "still durable"
    s.note([seq_before, deltas_before, orderer.deli.sequence_number,
            s2.get_text(),
            canonical(server2.get_deltas("t", "doc", 0, 10**9))])
    server2.log.close()


def test_durable_service_survives_process_restart(tmp_path):
    both(_survives_restart, tmp_path)
