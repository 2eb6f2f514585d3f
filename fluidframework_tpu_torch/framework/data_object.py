"""DataObject — the aqueduct capability: a datastore with typed channels.

The reference's ``DataObject``/``DataObjectFactory`` (aqueduct) wrap a
datastore in a class with named DDS members created at initialization and
re-bound at load.  Here a DataObject declares ``CHANNELS`` (name → channel
type string); the factory materializes them on create and binds them as
attributes on load."""

from __future__ import annotations

from typing import Dict, Optional

from ..runtime.container import ContainerRuntime
from ..runtime.datastore import FluidDataStoreRuntime


class DataObject:
    """Subclass with ``CHANNELS = {"text": "sequence-tpu", ...}``; channels
    appear as same-named attributes."""

    CHANNELS: Dict[str, str] = {}

    def __init__(self, datastore: FluidDataStoreRuntime) -> None:
        self.datastore = datastore
        self.id = datastore.id
        for name in type(self).CHANNELS:
            setattr(self, name, datastore.get_channel(name))

    def initialize_first_time(self) -> None:
        """Override: one-time setup when the object is first created
        (before attach) — the reference's initializingFirstTime."""

    def initialize_from_existing(self) -> None:
        """Override: re-initialization when loaded from a summary —
        the reference's initializingFromExisting."""


class DataObjectFactory:
    """Creates/loads a DataObject subclass over a datastore."""

    def __init__(self, cls) -> None:
        self.cls = cls

    def create(self, runtime: ContainerRuntime, datastore_id: str,
               rooted: bool = True) -> DataObject:
        ds = runtime.create_datastore(datastore_id, rooted=rooted)
        for name, type_name in self.cls.CHANNELS.items():
            ds.create_channel(type_name, name)
        obj = self.cls(ds)
        obj.initialize_first_time()
        return obj

    def load(self, runtime: ContainerRuntime,
             datastore_id: str) -> DataObject:
        obj = self.cls(runtime.get_datastore(datastore_id))
        obj.initialize_from_existing()
        return obj
