"""DataObject: the aqueduct-style developer entry point.

JAX counterpart: ``fluidframework_tpu/framework/data_object.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework/aqueduct — PureDataObject/DataObject own a root
SharedDirectory and an initialization lifecycle
(data-objects/dataObject.ts:32: initializingFirstTime /
initializingFromExisting / hasInitialized), created through a
DataObjectFactory and a container-runtime factory with a default store
(containerRuntimeFactoryWithDefaultDataStore.ts:24).
"""

from __future__ import annotations

from typing import Optional, Type

from ..runtime.datastore import DataStoreRuntime

ROOT_CHANNEL_ID = "root"


class DataObject:
    """Subclass and override the lifecycle hooks; access state via
    ``self.root`` (a SharedDirectory) or ``create_channel`` helpers."""

    def __init__(self, runtime: DataStoreRuntime):
        self.runtime = runtime

    # ------------------------------------------------------------ lifecycle

    def initializing_first_time(self) -> None:
        """Called exactly once, on the replica that creates the object."""

    def initializing_from_existing(self) -> None:
        """Called when loading an already-created object."""

    def has_initialized(self) -> None:
        """Called on every replica after either initialization path."""

    # -------------------------------------------------------------- state

    @property
    def root(self):
        return self.runtime.get_channel(ROOT_CHANNEL_ID)

    def create_channel(self, channel_id: str, channel_type: str):
        return self.runtime.create_channel(channel_id, channel_type)

    def get_channel(self, channel_id: str):
        return self.runtime.get_channel(channel_id)


class DataObjectFactory:
    """Creates/loads a DataObject type against a container runtime
    (ref: aqueduct DataObjectFactory)."""

    def __init__(self, pkg: str, cls: Type[DataObject]):
        self.pkg = pkg
        self.cls = cls

    def create(self, container_runtime, ds_id: str) -> DataObject:
        ds = container_runtime.create_data_store(ds_id, pkg=self.pkg)
        ds.create_channel(ROOT_CHANNEL_ID, "shared-directory")
        obj = self.cls(ds)
        obj.initializing_first_time()
        obj.has_initialized()
        return obj

    def load(self, container_runtime, ds_id: str) -> DataObject:
        obj = self.cls(container_runtime.get_data_store(ds_id))
        obj.initializing_from_existing()
        obj.has_initialized()
        return obj

    def create_or_load(self, container, ds_id: str = "default") -> DataObject:
        """The ContainerRuntimeFactoryWithDefaultDataStore pattern: the
        container's creator makes the default object, everyone else loads
        it (ref: containerRuntimeFactoryWithDefaultDataStore.ts:24)."""
        runtime = container.runtime
        if ds_id in runtime.data_stores:
            return self.load(runtime, ds_id)
        if container.existing:
            raise KeyError(
                f"document exists but has no data store {ds_id!r}")
        return self.create(runtime, ds_id)


def default_data_object(container, factory: Optional[DataObjectFactory] = None):
    """Resolve a container's default data object with the stock DataObject
    class unless a factory is supplied."""
    factory = factory or DataObjectFactory("default", DataObject)
    return factory.create_or_load(container)
