"""Device choice for the port's entry points.

An entry point runs on the card unless its caller names another device.
With no device given and no card present it raises: the CPU is never
chosen silently. (The JAX package has no counterpart; JAX picks its
backend itself.)
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    must be present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
