"""PyTorch and CUDA port of ``fluidframework_tpu``, for NVIDIA Hopper cards.

The JAX package beside this one is the reference; every module here names
its counterpart there. The port imports ``torch`` and ``numpy`` and never
``jax`` or any module of ``fluidframework_tpu``.

What is ported so far is the in-process service path and the
server-side merge-tree replica farm that rides it (its one device path):
``service.load_gen.run_inproc`` drives clients through
``service.local_server.LocalServer`` (deli, scriptorium, scribe,
broadcaster), and ``service.gpu_applier.GpuDocumentApplier`` stages the
broadcast ops on the host (on a worker thread with ``async_dispatch``);
each wave runs ``ops.apply.unpack_wave16`` →
``ops.cuda_apply.apply_ops_batch`` (the hand-written CUDA kernel in
``csrc/apply.cu``) → ``ops.apply.compact_batch`` on the applier's own
CUDA stream. The farm checkpoints in the JAX package's format
(``service.gpu_applier.save_applier_checkpoint``), the log can be durable
(``service.durable_log.DurableLog`` over the C++ op log in
``csrc/oplog.cpp``), and ``service.stage_runner.ApplierStage`` runs the
farm in a process of its own that tails such a log. The farm's read side
is ported too: ``service.service_summarizer.ServiceSummarizer`` writes
summaries from the farm into the server's storage, the client stack
(``loader``, ``runtime``, ``dds``, ``driver``) boots from them, and
``replay`` replays recorded documents through the client stack and the
farm. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
