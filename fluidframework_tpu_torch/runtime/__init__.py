"""Runtime layer: routes the op stream into data stores and channels.

JAX counterpart: ``fluidframework_tpu/runtime/__init__.py``; the port's copy,
imports rebased to this package.

Ref: packages/runtime (SURVEY §2.3) — ContainerRuntime multiplexes ops to
data stores and owns pending-op replay on reconnect; each data store hosts
named channels (the DDS instances); channels talk back through a delta
connection adapter.
"""

from .container_runtime import ContainerRuntime, PendingStateManager
from .datastore import DataStoreRuntime

__all__ = ["ContainerRuntime", "PendingStateManager", "DataStoreRuntime"]
