"""Configuration registry of the port.

JAX counterpart: ``fluidframework_tpu/config.py::Config``. This is a copy
of the fields that the port's service pipeline, replica farm and client
stack read, with the same defaults and the same environment layer
(``FLUID_TPU_<FIELD>``, so one deployment setting drives both packages).
A config resolves by layering defaults ← explicit overrides ←
environment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import Any, Optional

ENV_PREFIX = "FLUID_TPU_"


@dataclass
class Config:
    """The port's tunables, server and client, in one place."""

    # ---- service: deli sequencer (ref: deli/lambdaFactory.ts:29-37)
    client_timeout_s: float = 300.0      # idle-client eviction
    # ---- service: replica farm geometry (ops/doc_state + gpu_applier)
    applier_max_docs: int = 256          # device doc slots [D]
    applier_max_slots: int = 256         # segment slots per doc [S]
    applier_ops_per_dispatch: int = 32   # wave depth [K]
    applier_min_wave_ops: int = 0        # async worker dispatch threshold
    applier_overflow_check_every: int = 64  # dispatches between fences
    # overlap-staged dispatch: stage wave N+1 on the host (pack, scatter
    # into pinned memory, asynchronous copy) while wave N executes on the
    # card. Off = fence each wave before staging the next (the serialized
    # behavior, kept for A/B).
    applier_overlap: bool = True
    # ---- client: summarizer heuristics (ref: summarizer.ts:232)
    summary_max_ops: int = 100           # ops since last ack → attempt
    # ---- DDS: merge-tree snapshot chunking (ref: snapshotV1.ts:87)
    summary_chunk_segments: int = 256    # segments per summary chunk blob
    # ---- service: log retention margin kept BELOW an acked summary's
    # capture seq (ops older than that truncate from scriptorium; a
    # client disconnected past the window reloads from the summary).
    # Negative disables truncation entirely.
    log_retention_ops: int = 1000

    def with_overrides(self, **overrides: Any) -> "Config":
        known = {f.name for f in fields(self)}
        bad = set(overrides) - known
        if bad:
            raise KeyError(f"unknown config keys: {sorted(bad)}")
        merged = {f.name: getattr(self, f.name) for f in fields(self)}
        merged.update(overrides)
        return Config(**merged)

    @classmethod
    def from_env(cls, base: Optional["Config"] = None) -> "Config":
        """Environment layer: FLUID_TPU_APPLIER_MAX_DOCS=1024 etc."""
        base = base or cls()
        overrides: dict[str, Any] = {}
        for f in fields(cls):
            raw = os.environ.get(ENV_PREFIX + f.name.upper())
            if raw is None or raw.strip() == "":
                # set-but-empty means "unset" in shell convention
                continue
            typ = type(getattr(base, f.name))
            if typ is bool:
                # bool("0") is True — parse the usual spellings instead
                low = raw.strip().lower()
                if low in ("1", "true", "yes", "on"):
                    overrides[f.name] = True
                elif low in ("0", "false", "no", "off"):
                    overrides[f.name] = False
                else:
                    raise ValueError(
                        f"{ENV_PREFIX}{f.name.upper()}={raw!r}: expected a "
                        "boolean (1/0/true/false/yes/no/on/off)")
            else:
                overrides[f.name] = typ(raw)
        return base.with_overrides(**overrides)


# process-wide default instance (explicit Config args always win)
DEFAULT = Config.from_env()
