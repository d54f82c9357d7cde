"""Device mesh construction.

JAX counterpart: ``fluidframework_tpu/parallel/mesh.py``. Two named axes:

- ``docs`` — document shards (the Kafka-partition analog; independent docs,
  so this axis only ever carries stats reductions — never data
  dependencies between docs).
- ``seg``  — segment shards within one giant document (the
  sequence-parallel analog).

The port's ``Mesh`` is a ``[docs, seg]`` grid of ``torch.device``s, not a
``jax.sharding.Mesh``: no ``shard_map`` and no ``NamedSharding`` (TPU/XLA
artifacts). The doc-sharded lane keeps each docs shard's state on the
first device of its row (``shard_device``). A device list may name one
device more than once: that is the port's counterpart of the JAX
package's forced virtual host devices (``force_host_devices``), made
explicit with ``virtual_devices`` and touching no global state. Asked for
more cards than the machine has, with no device list, ``make_mesh``
raises; it never shrinks the mesh or falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


def _normalize(device: DeviceLike) -> torch.device:
    """``cuda`` without an index names the current card, explicitly."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A ``[docs, seg]`` grid of devices."""

    def __init__(self, grid: Sequence[Sequence[DeviceLike]]):
        self.devices = tuple(tuple(_normalize(d) for d in row)
                             for row in grid)
        if not self.devices or len({len(r) for r in self.devices}) != 1 \
                or not self.devices[0]:
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.shape = {"docs": len(self.devices),
                      "seg": len(self.devices[0])}

    def shard_devices(self, shard: int) -> tuple:
        """The devices of docs shard ``shard`` (its ``seg`` row)."""
        return self.devices[shard]

    def shard_device(self, shard: int) -> torch.device:
        """Where the doc-sharded lane keeps docs shard ``shard``."""
        return self.devices[shard][0]


def make_mesh(n_devices: Optional[int] = None, seg_shards: int = 1,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Build a ('docs', 'seg') mesh over ``devices``, or over the first
    ``n_devices`` cards (default: all) when no list is given.

    Raises when the machine has fewer cards than asked for, or none; a
    list may repeat a device (see ``virtual_devices``)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else n_devices
        if want < 1 or have < want:
            raise RuntimeError(
                f"a mesh of {n_devices or 'all'} cards needs {max(want, 1)} "
                f"CUDA devices, this machine has {have}; pass devices= (a "
                "device may repeat) to place several shards on one device")
        devices = [torch.device("cuda", i) for i in range(want)]
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices "
                         "were given")
    n = len(devices)
    if n % seg_shards != 0:
        raise ValueError(f"{n} devices not divisible by seg_shards={seg_shards}")
    devices = list(devices)
    return Mesh([devices[i:i + seg_shards] for i in range(0, n, seg_shards)])


def virtual_devices(n_devices: int, device: DeviceLike = "cpu") -> list:
    """``[device] * n_devices``: a device list that puts several mesh
    shards on one device (JAX counterpart: ``force_host_devices``, which
    forces XLA host devices through a process-wide flag)."""
    return [torch.device(device)] * n_devices
