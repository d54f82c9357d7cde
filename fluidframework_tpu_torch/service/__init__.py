"""Service layer of the port (JAX counterpart: ``fluidframework_tpu/service``).

The in-process ordering pipeline (``local_server.LocalServer`` → deli →
scriptorium, scribe, broadcaster over ``local_log.LocalLog``), the load
generator that drives it (``load_gen.run_inproc``), and the replica farm
that rides its broadcast (``gpu_applier.GpuDocumentApplier``) with the
array boxcars it ingests (``array_batch``). ``durable_log.DurableLog``
persists the log on disk, and ``stage_runner`` runs the farm (and scribe)
as processes of their own that tail it, checkpointing as they go.
``service_summarizer.ServiceSummarizer`` writes each doc's summary from
the farm (``summary_trees`` and ``LocalServer.storage`` store it).
"""
