"""Channel type registry (ref: IChannelFactory registrations passed to
data-store factories, datastore-definitions).

JAX counterpart: ``fluidframework_tpu/dds/registry.py``; the port's copy,
imports rebased to this package.
"""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_channel_type(cls: type) -> type:
    _REGISTRY[cls.channel_type] = cls
    return cls


def create_channel(channel_type: str, channel_id: str):
    try:
        cls = _REGISTRY[channel_type]
    except KeyError:
        raise KeyError(
            f"unknown channel type {channel_type!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return cls(channel_id)


def load_channel(channel_type: str, channel_id: str, snapshot: dict):
    channel = create_channel(channel_type, channel_id)
    channel.load_core(snapshot)
    return channel
