"""DDS layer of the port: the distributed data structures a summarised
document holds (JAX counterpart: ``fluidframework_tpu/dds``).

The port carries the JAX package's whole catalog: SharedString (with its
interval collections), SharedMap, SharedCell and SharedCounter,
SharedDirectory, the consensus register collection and queue, Ink and
SharedSummaryBlock, SharedMatrix, and the number and object sequences.
Importing this package registers every channel type, so
``create_channel`` and ``load_channel`` know each of them.

Ref: packages/dds (SURVEY §2.2) — every DDS is a deterministic state
machine over (snapshot, sequenced op stream) implementing the SharedObject
contract (shared-object-base/src/sharedObject.ts): optimistic local apply,
remote apply, own-op ack, reconnect resubmit, snapshot/load.
"""

from .shared_object import SharedObject
from .registry import create_channel, load_channel, register_channel_type
from .string import SharedString
from .map import SharedMap
from .cell import SharedCell, SharedCounter
from .directory import SharedDirectory
from .consensus import ConsensusQueue, ConsensusRegisterCollection
from .ink import Ink, SharedSummaryBlock
from .matrix import SharedMatrix
from .sequence import SharedNumberSequence, SharedObjectSequence
from .intervals import IntervalCollection, SequenceInterval

__all__ = [
    "SharedObject",
    "SharedString",
    "SharedMap",
    "SharedCell",
    "SharedCounter",
    "SharedDirectory",
    "ConsensusQueue",
    "ConsensusRegisterCollection",
    "Ink",
    "SharedSummaryBlock",
    "SharedMatrix",
    "SharedNumberSequence",
    "SharedObjectSequence",
    "IntervalCollection",
    "SequenceInterval",
    "create_channel",
    "load_channel",
    "register_channel_type",
]
