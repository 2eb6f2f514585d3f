"""FluidClient / FluidContainer — the fluid-static + service-client
capability: schema-declared containers with ``initial_objects``.

The reference's ``TinyliciousClient``/``AzureClient`` expose
``createContainer(schema)`` / ``getContainer(id, schema)`` returning a
``FluidContainer`` whose ``initialObjects`` are DDS instances declared in
the schema.  Same shape here, over any driver factory (local, file, …)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

from ..loader.loader import Container, Loader
from ..runtime.registry import ChannelRegistry

_INITIAL_DS = "initial-objects"
_client_counter = itertools.count(1)


@dataclasses.dataclass
class ContainerSchema:
    """``initial_objects``: name → channel type string (e.g.
    {"notes": "sequence-tpu", "votes": "map-tpu"})."""

    initial_objects: Dict[str, str]


class FluidContainer:
    """App-facing facade over a loaded Container."""

    def __init__(self, container: Container,
                 schema: ContainerSchema) -> None:
        self._container = container
        self.schema = schema
        ds = container.runtime.get_datastore(_INITIAL_DS)
        self.initial_objects = {
            name: ds.get_channel(name) for name in schema.initial_objects
        }

    @property
    def audience(self):
        return self._container.audience

    @property
    def connected(self) -> bool:
        return self._container.connected

    @property
    def client_id(self):
        return self._container.client_id

    def create_channel(self, type_name: str, channel_id: str):
        """Dynamic object creation (the reference's container.create)."""
        ds = self._container.runtime.get_datastore(_INITIAL_DS)
        return ds.create_channel(type_name, channel_id)

    def sync(self) -> int:
        """Pump inbound delivery (hosts drive this from their loop)."""
        return self._container.drain()

    def submit_signal(self, content, target_client_id=None) -> None:
        self._container.delta_manager.submit_signal(content,
                                                    target_client_id)

    def on_signal(self, fn) -> None:
        self._container.delta_manager.subscribe_signals(fn)

    def disconnect(self) -> None:
        self._container.disconnect()

    def reconnect(self) -> None:
        self._container.reconnect()

    def close(self) -> None:
        self._container.close()

    def close_and_get_pending_state(self) -> dict:
        return self._container.close_and_get_pending_state()


class FluidClient:
    """create_container / get_container over a driver factory."""

    def __init__(self, driver_factory,
                 registry: Optional[ChannelRegistry] = None,
                 client_id_prefix: str = "client",
                 runtime_options=None) -> None:
        """``runtime_options`` (ContainerRuntimeOptions) reaches every
        runtime this client creates — e.g. ``attribution=True`` stamps
        created documents as attribution-enabled."""
        self.loader = Loader(driver_factory, registry,
                             runtime_options=runtime_options)
        self._prefix = client_id_prefix

    def _next_client_id(self) -> str:
        return f"{self._prefix}-{next(_client_counter)}"

    def create_container(self, doc_id: str,
                         schema: ContainerSchema) -> FluidContainer:
        def build(runtime):
            ds = runtime.create_datastore(_INITIAL_DS)
            for name, type_name in schema.initial_objects.items():
                ds.create_channel(type_name, name)

        container = self.loader.create(doc_id, self._next_client_id(), build)
        return FluidContainer(container, schema)

    def get_container(self, doc_id: str,
                      schema: ContainerSchema,
                      pending_state: Optional[dict] = None) -> FluidContainer:
        container = self.loader.resolve(
            doc_id, self._next_client_id(), pending_state=pending_state
        )
        return FluidContainer(container, schema)
