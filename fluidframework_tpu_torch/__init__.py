"""PyTorch and CUDA port of ``fluidframework_tpu``, for NVIDIA Hopper cards.

The JAX package beside this one is the reference; every module here names
its counterpart there. The port imports ``torch`` and ``numpy`` and never
``jax`` or any module of ``fluidframework_tpu``.

What is ported so far is the server-side merge-tree replica farm (its one
device path): ``service.gpu_applier.GpuDocumentApplier`` stages sequenced
ops on the host, and each wave runs ``ops.apply.unpack_wave16`` →
``ops.cuda_apply.apply_ops_batch`` (the hand-written CUDA kernel in
``csrc/apply.cu``) → ``ops.apply.compact_batch`` on the card. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
