"""Native (C++) components of the port and their ctypes bindings.

JAX counterpart: ``fluidframework_tpu/native``. The port carries the
durable op log (``oplog``: ``csrc/oplog.cpp``, the librdkafka-role
component) and the gateway relay (``gateway``: ``csrc/gateway.cpp``),
each built with g++ at first use by ``build``. The chunk store waits for
the storage tier (ROADMAP A9).
"""

from .build import load_library
from .gateway import NativeGateway
from .oplog import NativeOpLog

__all__ = ["load_library", "NativeGateway", "NativeOpLog"]
