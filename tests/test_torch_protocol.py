"""The port's protocol core (``protocol/``: quorum, proposals,
``ProtocolOpHandler``) against ``tests/test_protocol.py``.

Each test is the twin of the JAX test of the same name: its message
script runs on each package with the JAX test's assertions, and what
each handler shows after the script is equal between the packages
exactly: its ``snapshot()`` encoded as JSON bytes (sorted keys), its
seq and msn, the quorum's members and values, the approval events, the
error's class name and text. Tolerance: exact.
"""

import json

import pytest
import tests.torch_stack_fixtures  # noqa: F401  (one torch thread)
from tests.torch_stack_fixtures import module

PKGS = ("jax", "torch")


def _p(pkg):
    return module(pkg, "protocol")


def seqmsg(p, seq, msn, mtype, contents=None, client_id="A", ref_seq=0,
           client_seq=0):
    return p.SequencedDocumentMessage(
        client_id=client_id, sequence_number=seq,
        minimum_sequence_number=msn, client_sequence_number=client_seq,
        reference_sequence_number=ref_seq, type=mtype, contents=contents)


def _state(h) -> bytes:
    return json.dumps([h.snapshot(), h.sequence_number,
                       h.minimum_sequence_number, sorted(h.quorum.members)],
                      sort_keys=True, default=repr).encode()


def _both(script) -> None:
    shown = {pkg: script(_p(pkg)) for pkg in PKGS}
    assert shown["torch"] == shown["jax"]


def _join_leave(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN,
                             {"clientId": "A", "userId": "u1"}))
    h.process_message(seqmsg(p, 2, 0, M.CLIENT_JOIN,
                             {"clientId": "B", "userId": "u2"}))
    assert set(h.quorum.members) == {"A", "B"}
    assert h.quorum.members["A"].sequence_number == 1
    joined = _state(h)
    h.process_message(seqmsg(p, 3, 1, M.CLIENT_LEAVE, "A"))
    assert set(h.quorum.members) == {"B"}
    assert h.sequence_number == 3
    assert h.minimum_sequence_number == 1
    return [joined, _state(h)]


def test_join_leave_membership():
    _both(_join_leave)


def _accepts(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN, {"clientId": "A"}))
    h.process_message(seqmsg(p, 2, 0, M.PROPOSE,
                             {"key": "code", "value": "v2"}))
    assert not h.quorum.has("code")
    pending = _state(h)
    h.process_message(seqmsg(p, 3, 2, M.NOOP))
    assert h.quorum.get("code") == "v2"
    return [pending, _state(h)]


def test_proposal_accepts_when_msn_passes():
    _both(_accepts)


def _rejected(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN, {"clientId": "A"}))
    h.process_message(seqmsg(p, 2, 0, M.CLIENT_JOIN, {"clientId": "B"}))
    h.process_message(seqmsg(p, 3, 0, M.PROPOSE, {"key": "k", "value": 1},
                             client_id="A"))
    h.process_message(seqmsg(p, 4, 0, M.REJECT, 3, client_id="B"))
    h.process_message(seqmsg(p, 5, 4, M.NOOP))
    assert not h.quorum.has("k")
    assert 3 not in h.quorum.proposals
    return [_state(h)]


def test_proposal_rejected_blocks_commit():
    _both(_rejected)


def _duplicates(p):
    h = p.ProtocolOpHandler()
    m = seqmsg(p, 1, 0, p.MessageType.CLIENT_JOIN, {"clientId": "A"})
    h.process_message(m)
    h.process_message(m)
    assert len(h.quorum.members) == 1
    return [_state(h)]


def test_duplicate_messages_ignored():
    _both(_duplicates)


def _roundtrip(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN,
                             {"clientId": "A", "userId": "u"}))
    h.process_message(seqmsg(p, 2, 0, M.PROPOSE,
                             {"key": "code", "value": "v1"}))
    h.process_message(seqmsg(p, 3, 2, M.NOOP))
    h.process_message(seqmsg(p, 4, 2, M.PROPOSE,
                             {"key": "pending", "value": 9}))
    snap = h.snapshot()
    h2 = p.ProtocolOpHandler.load(snap)
    assert h2.sequence_number == 4
    assert h2.minimum_sequence_number == 2
    assert h2.quorum.get("code") == "v1"
    assert 4 in h2.quorum.proposals
    loaded = _state(h2)
    h2.process_message(seqmsg(p, 5, 4, M.NOOP))
    assert h2.quorum.get("pending") == 9
    return [_state(h), loaded, _state(h2)]


def test_snapshot_roundtrip():
    _both(_roundtrip)


def _preserves_rejections(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN, {"clientId": "A"}))
    h.process_message(seqmsg(p, 2, 0, M.CLIENT_JOIN, {"clientId": "B"}))
    h.process_message(seqmsg(p, 3, 0, M.PROPOSE, {"key": "k", "value": 1},
                             client_id="A"))
    h.process_message(seqmsg(p, 4, 0, M.REJECT, 3, client_id="B"))
    h2 = p.ProtocolOpHandler.load(h.snapshot())
    loaded = _state(h2)
    h2.process_message(seqmsg(p, 5, 4, M.NOOP))
    assert not h2.quorum.has("k")
    return [loaded, _state(h2)]


def test_snapshot_preserves_rejections():
    _both(_preserves_rejections)


def _gap(p):
    quorum = module("jax" if p.__name__.startswith("fluidframework_tpu.")
                    else "torch", "protocol.quorum")
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, p.MessageType.CLIENT_JOIN,
                             {"clientId": "A"}))
    with pytest.raises(quorum.ProtocolError) as err:
        h.process_message(seqmsg(p, 5, 0, p.MessageType.NOOP))
    return [type(err.value).__name__, str(err.value), _state(h)]


def test_sequence_gap_raises():
    _both(_gap)


def _malformed_reject(p):
    M = p.MessageType
    h = p.ProtocolOpHandler()
    h.process_message(seqmsg(p, 1, 0, M.CLIENT_JOIN, {"clientId": "A"}))
    h.process_message(seqmsg(p, 2, 0, M.REJECT, None))
    h.process_message(seqmsg(p, 3, 0, M.REJECT, {"bogus": True}))
    assert h.sequence_number == 3
    return [_state(h)]


def test_malformed_reject_ignored():
    _both(_malformed_reject)


def _events(p):
    q = p.Quorum()
    approved = []
    q.on("approveProposal", lambda prop: approved.append(
        (prop.key, prop.value)))
    q.add_proposal("k", "v", seq=5, local=True)
    q.update_minimum_sequence_number(5, 6)
    assert approved == [("k", "v")]
    return [approved, q.get("k")]


def test_proposal_events_fire():
    _both(_events)
