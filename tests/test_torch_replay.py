"""The port's replay tool on the committed corpus, against the JAX
package's recordings.

The three recorded documents of ``tests/corpus/corpus`` replay through
the port's real client stack (file driver, ``Loader`` / ``Container``,
runtime, SharedString and SharedMap) to the fingerprints and final texts
the JAX package recorded in each ``expect.json``, and to the JAX replay's
fingerprints on a finer grid; through the port's replica farm on the CPU
(``replay_through_applier(device="cpu")``) to the recorded text; and a
deliberately skewed apply fails the comparison (the tripwire, as
``tests/test_replay.py`` skews the JAX kernel). Without a card and with
no device named, the applier path raises.
"""

import json
import os

import pytest
import torch

from fluidframework_tpu.driver.file import (
    FileDocumentService as JaxFileDocumentService,
)
from fluidframework_tpu.replay import ReplayController as JaxReplayController
from fluidframework_tpu_torch.driver.file import (
    FileDocumentService,
    ReadOnlyDocumentError,
)
from fluidframework_tpu_torch.ops import cuda_apply
from fluidframework_tpu_torch.ops.apply import F_POS, F_TYPE, OP_INSERT
from fluidframework_tpu_torch.replay import (
    ReplayController,
    replay_and_compare,
    replay_through_applier,
)
from fluidframework_tpu_torch.replay.tool import main
from fluidframework_tpu_torch.service.gpu_applier import GpuDocumentApplier

CORPUS = os.path.join(os.path.dirname(__file__), "corpus", "corpus")
SCENARIOS = sorted(os.listdir(CORPUS))


def load_expect(name):
    with open(os.path.join(CORPUS, name, "expect.json")) as f:
        return json.load(f)


def test_corpus_is_the_three_recorded_docs():
    assert SCENARIOS == ["text-basic", "text-conflict", "text-map-mixed"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_corpus_replays_byte_identical(name):
    problems = replay_and_compare(
        os.path.join(CORPUS, name), load_expect(name))
    assert problems == []


@pytest.mark.parametrize("name", SCENARIOS)
def test_replay_fingerprints_equal_jax_every_seven_ops(name):
    doc_dir = os.path.join(CORPUS, name)
    got = ReplayController(FileDocumentService.from_dir(doc_dir)).run(7)
    want = JaxReplayController(
        JaxFileDocumentService.from_dir(doc_dir)).run(7)
    assert got == want
    assert len(got["snapshots"]) >= 3  # text-basic boots at seq 30


@pytest.mark.parametrize("name", SCENARIOS)
def test_corpus_device_replay_matches(name):
    """The farm (scribe-replay role, plain version on the CPU) produces
    the text the live replicas converged on when the corpus was
    recorded."""
    text = replay_through_applier(os.path.join(CORPUS, name), device="cpu")
    assert text == load_expect(name)["final_text"]


def test_corpus_catches_kernel_change(monkeypatch):
    """A deliberately broken apply must FAIL the corpus comparison: the
    regression tripwire works on the port's apply path too."""
    real = cuda_apply.apply_ops_batch
    calls = []

    def skewed(state, wave):
        # shift every insert one position left: a subtle semantic change
        calls.append(1)
        wave = wave.clone()
        pos = wave[..., F_POS]
        is_ins = wave[..., F_TYPE] == OP_INSERT
        wave[..., F_POS] = torch.where(is_ins & (pos > 0), pos - 1, pos)
        return real(state, wave)

    monkeypatch.setattr(cuda_apply, "apply_ops_batch", skewed)
    applier = GpuDocumentApplier(max_docs=3, max_slots=640,
                                 ops_per_dispatch=13, device="cpu")
    name = "text-conflict"
    text = replay_through_applier(os.path.join(CORPUS, name), applier)
    assert calls and text != load_expect(name)["final_text"]


def test_applier_path_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_through_applier(os.path.join(CORPUS, "text-basic"))


def test_file_driver_boots_from_snapshot_plus_tail():
    """text-basic carries a mid-stream acked summary: the file driver
    boots the container from it and the tail replays on top, on the
    legacy whole-log path (no driver of the port has a history
    surface)."""
    doc_dir = os.path.join(CORPUS, "text-basic")
    assert os.path.exists(os.path.join(doc_dir, "snapshot.json"))
    svc = FileDocumentService.from_dir(doc_dir)
    ctl = ReplayController(svc)
    assert ctl.history is None
    assert ctl.counters.snapshot()["history.replay.legacy"] == 1
    assert ctl.container.existing  # booted from the snapshot
    assert ctl.container.delta_manager.last_processed_seq > 0
    result = ctl.run()
    assert result["final_text"] == load_expect("text-basic")["final_text"]


def test_file_driver_documents_are_read_only():
    svc = FileDocumentService.from_dir(os.path.join(CORPUS, "text-basic"))
    with pytest.raises(ReadOnlyDocumentError):
        svc.connect_to_delta_stream()
    with pytest.raises(ReadOnlyDocumentError):
        svc.connect_to_storage().upload_summary({}, None)
    with pytest.raises(ReadOnlyDocumentError):
        svc.connect_to_storage().write_blob(b"x")
    with pytest.raises(NotImplementedError, match="history surface"):
        svc.history()


def test_main_replays_a_doc_dir(capsys):
    assert main([os.path.join(CORPUS, "text-conflict")]) == 0
    out = capsys.readouterr().out
    assert "legacy whole-log replay to seq 67: 2 fingerprint(s)" in out
    assert repr(load_expect("text-conflict")["final_text"]) in out
