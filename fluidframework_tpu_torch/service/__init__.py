"""Service layer of the port (JAX counterpart: ``fluidframework_tpu/service``).

So far only the replica farm's dense lane: ``gpu_applier`` and the array
boxcars it ingests (``array_batch``).
"""
