"""Tensor code of the replica farm (JAX counterpart: ``fluidframework_tpu/ops``).

``doc_state`` holds the [D, S] structure-of-arrays state, ``apply`` the
plain PyTorch apply / zamboni / wave codec, ``cuda_apply`` the wrapper of
the hand-written CUDA apply kernel, and ``opgen`` seeded op streams.
"""
