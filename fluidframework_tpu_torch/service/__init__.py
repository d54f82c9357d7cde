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
``front_end.NetworkFrontEnd`` serves the pipeline over TCP, directly or
through relay ``gateway.Gateway`` processes (native by default), and
``load_async`` drives it with socket clients. The sharded ordering core
splits docs into partitions across several front ends: ``placement``
leases and the ``placement_plane`` epoch table route each partition to
one ``front_end.ShardHost``, which migrates it live or takes it over
when its owner dies; ``rebalancer`` moves hot partitions, and
``topology`` starts a whole fleet from one spec.
"""

__all__ = ["Gateway", "NetworkFrontEnd"]


def __getattr__(name: str):
    # resolved on first use, so that ``python -m`` of the front end or
    # the gateway does not find its own module already imported
    if name == "NetworkFrontEnd":
        from .front_end import NetworkFrontEnd
        return NetworkFrontEnd
    if name == "Gateway":
        from .gateway import Gateway
        return Gateway
    raise AttributeError(name)
