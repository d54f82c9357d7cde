"""Loader layer: connects the driver to the runtime.

JAX counterpart: ``fluidframework_tpu/loader/__init__.py``; the port's copy,
imports rebased to this package.

Ref: packages/loader/container-loader (SURVEY §2.4) — the Loader resolves
a document to a Container; the Container boots protocol state + runtime
from the latest summary and op tail; the DeltaManager pumps the op stream
both ways with gap repair and reconnect.
"""

from .delta_manager import DeltaManager
from .container import Container, Loader

__all__ = ["DeltaManager", "Container", "Loader"]
