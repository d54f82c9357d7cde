"""The port against the frozen formats of ``tests/test_compat.py``.

The two format cases no other port test holds: the framed JSON wire
protocol (``service/front_end.py::_encode_frame``) and the message codec
(``protocol/serialization.py``) of each package reproduce the committed
golden bytes of ``tests/golden/`` exactly, both ways. The golden
durable-log session and the two golden applier checkpoints are held by
``test_torch_storage.py::test_durable_log_and_blobs_boot_round3_session``
and ``test_torch_checkpoint.py::test_golden_checkpoint_loads`` /
``test_golden_checkpoint_loads_legacy_meta``. Tolerance: exact.
"""

import json
import os

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_wire_frame_bytes_are_stable(pkg):
    encode_frame = module(pkg, "service.front_end")._encode_frame
    with open(os.path.join(GOLDEN, "wire_frames.json")) as fh:
        entries = json.load(fh)
    assert len(entries) >= 8
    for e in entries:
        golden = bytes.fromhex(e["hex"])
        assert encode_frame(e["frame"]) == golden, e["frame"]["t"]
        n = int.from_bytes(golden[:4], "big")
        assert n == len(golden) - 4
        assert json.loads(golden[4:].decode()) == e["frame"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_message_serialization_is_stable(pkg):
    ser = module(pkg, "protocol.serialization")
    with open(os.path.join(GOLDEN, "messages.json")) as fh:
        shapes = json.load(fh)
    assert set(shapes) == {"sequenced_op", "join", "raw", "nack"}
    for name, text in shapes.items():
        msg = ser.decode_message(text.encode())
        assert ser.encode_message(msg) == text.encode(), name
    op = ser.decode_message(shapes["sequenced_op"].encode())
    assert op.sequence_number == 42 and op.client_id == "client-a"
    nack = ser.decode_message(shapes["nack"].encode())
    assert nack.code == 429
