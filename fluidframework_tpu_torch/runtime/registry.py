"""The channel-factory registry — the framework's plugin boundary.

Capability-equivalent of the reference's ``IChannelFactory`` (SURVEY.md §2.1
datastore: "the north-star plugin boundary"; upstream paths UNVERIFIED —
empty reference mount).  A factory knows how to ``create`` an empty channel
of its type and ``load`` one from a summary subtree; the registry maps the
wire-level type string (stored in each channel's attributes blob) to its
factory.  The ``*-tpu`` variants registered by default are the DDSes whose
catch-up replay routes through the device kernels."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..dds.shared_object import SharedObject
from ..protocol.summary import SummaryTree


class ChannelFactory:
    """Creates/loads channels of one type."""

    def __init__(self, type_name: str,
                 ctor: Callable[[str], SharedObject]) -> None:
        self.type = type_name
        self._ctor = ctor

    def create(self, channel_id: str) -> SharedObject:
        return self._ctor(channel_id)

    def load(self, channel_id: str, summary: SummaryTree) -> SharedObject:
        channel = self._ctor(channel_id)
        channel.load(summary)
        return channel


class ChannelRegistry:
    """type string → factory."""

    def __init__(self) -> None:
        self._factories: Dict[str, ChannelFactory] = {}

    def register(self, factory: ChannelFactory) -> "ChannelRegistry":
        self._factories[factory.type] = factory
        return self

    def register_type(self, cls) -> "ChannelRegistry":
        """Register a SharedObject subclass by its TYPE attribute."""
        return self.register(ChannelFactory(cls.TYPE, cls))

    def get(self, type_name: str) -> ChannelFactory:
        factory = self._factories.get(type_name)
        if factory is None:
            raise KeyError(f"no channel factory for type {type_name!r}")
        return factory

    def types(self):
        return sorted(self._factories)


def default_registry() -> ChannelRegistry:
    """All built-in ``*-tpu`` channel types."""
    from ..dds.cell_counter import SharedCell, SharedCounter
    from ..dds.consensus import (
        ConsensusQueue,
        ConsensusRegisterCollection,
        TaskManager,
    )
    from ..dds.map import SharedDirectory, SharedMap
    from ..dds.matrix import SharedMatrix
    from ..dds.sequence import SharedString
    from ..dds.tree import SharedTree

    registry = ChannelRegistry()
    for cls in (SharedMap, SharedDirectory, SharedString, SharedMatrix,
                SharedTree, SharedCell, SharedCounter, ConsensusQueue,
                ConsensusRegisterCollection, TaskManager):
        registry.register_type(cls)
    return registry
