"""chaos: deterministic fault injection + protocol invariant monitoring.

JAX counterpart: ``fluidframework_tpu/chaos``. The port carries the fault
plane, the invariant monitor, the seam installers, the two-phase soak
(phase A with its ``DeviceStage`` on the card, phase B over sockets) and
the campaigns ``migrate``, ``rebalance``, ``noisy``, ``coldstart`` and
``multihost``.

The durability claims the service makes (ARCHITECTURE.md "Durability &
recovery") are exercised mechanically here, the way fluidlint exercises
the architecture claims: a seeded :class:`FaultPlane` schedules faults at
named injection points the service seams consult when armed (a single
predictable branch when disarmed), and an :class:`InvariantMonitor`
rides the sequenced stream asserting the protocol invariants — seq
strictly increasing, msn monotone and ≤ seq, clientSeq gap/dup rules,
every submitted op acked-or-nacked exactly once after dedupe, and all
replicas fingerprint-identical at quiescence.

``python -m fluidframework_tpu_torch.chaos.soak --seed N`` runs a recorded multi-client session under a fault schedule; the same
seed reproduces the same injections exactly.

Layering: chaos sits ABOVE service/driver (it may import them; nothing
outside tests may import chaos) — the seams it arms are duck-typed
``fault_plane`` attributes, so the service never imports this package.
"""

from .monitor import InvariantMonitor, InvariantViolation, doc_fingerprint
from .plane import FaultPlane, FaultRule, SimulatedCrash

__all__ = [
    "FaultPlane",
    "FaultRule",
    "SimulatedCrash",
    "InvariantMonitor",
    "InvariantViolation",
    "doc_fingerprint",
]
