"""Doc placement of the port (JAX counterpart: ``fluidframework_tpu/parallel``).

One shard only: the mesh lane waits for a later slice.
"""
