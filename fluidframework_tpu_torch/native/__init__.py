"""Native (C++) components of the port and their ctypes bindings.

JAX counterpart: ``fluidframework_tpu/native``. The port carries the
durable op log (``oplog``: ``csrc/oplog.cpp``, the librdkafka-role
component), built with g++ at first use by ``build``. The chunk store
waits for the storage tier (ROADMAP A4).
"""

from .build import load_library
from .oplog import NativeOpLog

__all__ = ["load_library", "NativeOpLog"]
