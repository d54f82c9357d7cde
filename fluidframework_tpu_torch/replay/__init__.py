"""Replay tool + snapshot-regression harness (SURVEY §5.7 aux ring).

JAX counterpart: ``fluidframework_tpu/replay/__init__.py``; the port's copy,
imports rebased to this package.

Ref: packages/tools/replay-tool (replayMessages.ts) and
packages/test/snapshots (replayMultipleFiles.ts:33 Mode.Write/Compare).
"""

from .tool import (  # noqa: F401
    ReplayController,
    replay_and_compare,
    replay_through_applier,
    state_fingerprint,
)
