"""DDS layer of the port: the distributed data structures a summarised
document holds (JAX counterpart: ``fluidframework_tpu/dds``).

The port carries SharedString (with its interval collections) and
SharedMap, the channels of the documents the replica farm summarises and
the replay corpus records. Importing this package registers both channel
types. The other DDSes of the JAX package (cell, counter, directory,
consensus collections, ink, matrix, sequences) are not ported yet
(ROADMAP A9).

Ref: packages/dds (SURVEY §2.2) — every DDS is a deterministic state
machine over (snapshot, sequenced op stream) implementing the SharedObject
contract (shared-object-base/src/sharedObject.ts): optimistic local apply,
remote apply, own-op ack, reconnect resubmit, snapshot/load.
"""

from .shared_object import SharedObject
from .registry import create_channel, load_channel, register_channel_type
from .string import SharedString
from .map import SharedMap
from .intervals import IntervalCollection, SequenceInterval

__all__ = [
    "SharedObject",
    "SharedString",
    "SharedMap",
    "IntervalCollection",
    "SequenceInterval",
    "create_channel",
    "load_channel",
    "register_channel_type",
]
