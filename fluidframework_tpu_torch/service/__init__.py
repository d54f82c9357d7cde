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
``topology`` starts a whole fleet from one spec. ``admission`` gates
tenants by rate and SLO burn, ``foreman`` brokers tasks to external
workers, and ``copier`` archives the raw ops topic.
"""

# the JAX package's names, each resolved from its module on first use, so
# that ``python -m`` of the front end or the gateway does not find its own
# module already imported and a socket worker loads no more than it uses
_LAZY = {
    "CheckpointManager": "core", "InMemoryDb": "core", "Lambda": "core",
    "LambdaContext": "core", "DeliCheckpoint": "deli",
    "DeliLambda": "deli", "RawMessage": "deli", "LocalLog": "local_log",
    "LocalOrderer": "local_orderer", "LocalServer": "local_server",
    "ServerConnection": "local_server", "NetworkFrontEnd": "front_end",
    "Gateway": "gateway",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(name)
    from importlib import import_module

    return getattr(import_module(f".{_LAZY[name]}", __name__), name)
