"""The port's corpus recorder against the JAX package's and against the
committed corpus.

``record_all`` of each package records the three seeded scenarios
(``SCENARIOS``) and replays each through its replica farm on the CPU. The
two write the same files: ``messages.json`` equal once client ids are
mapped by first appearance and the wall-clock timestamps and trace hops
are left out, ``snapshot.json`` and ``expect.json`` byte for byte when
both servers hand out client ids under the same epoch (the fingerprints
in ``expect.json`` hash the quorum's client ids, so under random epochs
only their text and last seq can agree). Under the committed corpus's
epochs the port reproduces its ``expect.json`` and ``snapshot.json``
byte for byte. The port's recorder has no default directory (the
committed corpus is the JAX package's recording) and, given no device,
refuses to run without a card.
"""

import json
import os
from pathlib import Path

import pytest
import torch
from tests.torch_stack_fixtures import map_client_ids

import fluidframework_tpu.replay.record as jax_record
import fluidframework_tpu_torch.replay.record as port_record

ROOT = Path(__file__).resolve().parent.parent
CORPUS = ROOT / "tests" / "corpus" / "corpus"
WALL_CLOCK = ("timestamp", "traces")


def _messages(doc_dir) -> str:
    with open(os.path.join(doc_dir, "messages.json")) as f:
        msgs = json.load(f)
    return map_client_ids([{k: v for k, v in m.items()
                            if k not in WALL_CLOCK} for m in msgs])


def _read(doc_dir, name: str):
    path = os.path.join(doc_dir, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def _committed_epochs() -> dict:
    """Each committed scenario's client-id epoch, from its first join."""
    out = {}
    for name in port_record.SCENARIOS:
        with open(CORPUS / name / "messages.json") as f:
            first = json.load(f)[0]
        out[name] = first["contents"]["clientId"].split("-")[1]
    return out


def _record_jax(out_dir, monkeypatch, epochs=None) -> None:
    """JAX ``record_all``; with ``epochs``, each scenario's server hands
    out client ids under its epoch (its ``LocalServer`` is wrapped)."""
    if epochs is not None:
        order = iter(jax_record.SCENARIOS)
        server_cls = jax_record.LocalServer

        def pinned():
            server = server_cls()
            server._client_epoch = epochs[next(order)]
            return server

        monkeypatch.setattr(jax_record, "LocalServer", pinned)
    jax_record.record_all(str(out_dir))
    monkeypatch.undo()


def test_record_all_writes_what_jax_writes(tmp_path, monkeypatch):
    epochs = {name: "e0" for name in port_record.SCENARIOS}
    port_record.record_all(str(tmp_path / "port"), device="cpu",
                           epochs=epochs)
    _record_jax(tmp_path / "jax", monkeypatch, epochs)
    for name in port_record.SCENARIOS:
        port = tmp_path / "port" / "corpus" / name
        jax = tmp_path / "jax" / "corpus" / name
        assert _messages(port) == _messages(jax), name
        for f in ("snapshot.json", "expect.json"):
            assert _read(port, f) == _read(jax, f), (name, f)
        assert _read(port, "expect.json") is not None


def test_record_all_under_random_epochs(tmp_path, monkeypatch):
    """With each server's own epoch (the default) the streams still
    agree with ids mapped, and so do each replay's text and last seq."""
    port_record.record_all(str(tmp_path / "port"), device="cpu")
    _record_jax(tmp_path / "jax", monkeypatch)
    for name in port_record.SCENARIOS:
        port = tmp_path / "port" / "corpus" / name
        jax = tmp_path / "jax" / "corpus" / name
        assert _messages(port) == _messages(jax), name
        want, got = (json.loads(_read(d, "expect.json")) for d in (jax, port))
        assert (got["final_text"], got["last_seq"], sorted(got["snapshots"])) \
            == (want["final_text"], want["last_seq"],
                sorted(want["snapshots"]))


def test_record_all_reproduces_the_committed_corpus(tmp_path):
    port_record.record_all(str(tmp_path), device="cpu",
                           epochs=_committed_epochs())
    for name in port_record.SCENARIOS:
        got = tmp_path / "corpus" / name
        want = CORPUS / name
        assert _read(got, "expect.json") == _read(want, "expect.json"), name
        assert _read(got, "snapshot.json") == _read(want, "snapshot.json")
        assert _messages(got) == _messages(want), name


def test_recorder_has_no_default_out(tmp_path, monkeypatch, capsys):
    """``--out`` is required, and nothing reaches ``tests/corpus``."""
    with pytest.raises(SystemExit):
        port_record.main([])
    assert "--out" in capsys.readouterr().err
    before = sorted(p.stat().st_mtime_ns for p in CORPUS.rglob("*"))
    monkeypatch.chdir(tmp_path)
    port_record.main(["--out", "rec", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "rec" / "corpus")) == \
        sorted(port_record.SCENARIOS)
    assert sorted(p.stat().st_mtime_ns for p in CORPUS.rglob("*")) == before


def test_record_all_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_record.record_all(str(tmp_path / "rec"))
    assert not (tmp_path / "rec").exists()
