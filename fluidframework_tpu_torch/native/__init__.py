"""Native (C++) components of the port and their ctypes bindings.

JAX counterpart: ``fluidframework_tpu/native``. The port carries the
durable op log (``oplog``: ``csrc/oplog.cpp``, the librdkafka-role
component), the content-addressed chunk store (``chunkstore``:
``csrc/chunkstore.cpp``, the libgit2-role component) and the gateway
relay (``gateway``: ``csrc/gateway.cpp``), each built with g++ at first
use by ``build``.
"""

from .build import load_library
from .chunkstore import NativeChunkStore
from .gateway import NativeGateway
from .oplog import NativeOpLog

__all__ = ["load_library", "NativeChunkStore", "NativeGateway",
           "NativeOpLog"]
