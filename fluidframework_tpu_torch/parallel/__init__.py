"""Hardware parallelism of the port (JAX counterpart:
``fluidframework_tpu/parallel``).

The reference scales by document-sharded data parallelism (Kafka
partitions keyed by (tenant,doc) — lambdas-driver
kafka-service/partitionManager.ts:22). Here:

- ``mesh``          a ``[docs, seg]`` grid of ``torch.device``s; a device
                    may repeat, so several shards can share one card
- ``sharded_apply`` the farm's one wave step (``apply_wave``: unpack, the
                    CUDA kernel, zamboni) and the doc-sharded steps that
                    run it once per shard per wave
- ``placement``     doc → shard routing table (the partition-key analog)
- ``long_doc``      segment-sharded prefix sums and apply for one giant
                    doc, its seg shards the rows of one state
"""

from .long_doc import sharded_resolve_position, sharded_visible_prefix
from .mesh import make_mesh
from .placement import DocPlacement
from .sharded_apply import make_sharded_packed_step, make_sharded_step

__all__ = [
    "make_mesh",
    "DocPlacement",
    "make_sharded_packed_step",
    "make_sharded_step",
    "sharded_visible_prefix",
    "sharded_resolve_position",
]
