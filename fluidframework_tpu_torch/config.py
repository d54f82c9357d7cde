"""Geometry defaults of the replica farm.

JAX counterpart: ``fluidframework_tpu/config.py::Config``. This is a copy
of the ``applier_*`` fields that the dense lane of
``service/gpu_applier.py`` reads, with the same defaults and the same
environment layer (``FLUID_TPU_<FIELD>``, so one deployment setting drives
both packages).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

ENV_PREFIX = "FLUID_TPU_"


@dataclass(frozen=True)
class ApplierConfig:
    max_docs: int = 256                # device doc slots [D]
    max_slots: int = 256               # segment slots per doc [S]
    ops_per_dispatch: int = 32         # wave depth [K]
    overflow_check_every: int = 64     # dispatches between overflow polls

    @classmethod
    def from_env(cls) -> "ApplierConfig":
        """Defaults overridden by ``FLUID_TPU_APPLIER_<FIELD>`` variables."""
        overrides = {}
        for f in fields(cls):
            raw = os.environ.get(f"{ENV_PREFIX}APPLIER_{f.name.upper()}")
            if raw is not None and raw.strip():
                overrides[f.name] = int(raw)
        return cls(**overrides)
