"""Datastore runtime: hosts channels (DDS instances) and routes their ops.

Capability-equivalent of the reference's ``FluidDataStoreRuntime`` /
``ChannelDeltaConnection`` (SURVEY.md §2.1 datastore; upstream paths
UNVERIFIED — empty reference mount): channel creation through the factory
registry, attach lifecycle, per-channel op routing, and the per-datastore
summary subtree (channel subtrees + an attributes blob recording each
channel's type for load)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..dds.shared_object import SharedObject
from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .registry import ChannelRegistry


class ChannelDeltaConnection:
    """The per-channel submit handle: wraps ops in the channel envelope and
    forwards them to the datastore's outbound path."""

    def __init__(self, datastore: "FluidDataStoreRuntime",
                 channel_id: str) -> None:
        self._datastore = datastore
        self._channel_id = channel_id

    def submit(self, contents, ref_seq=None) -> int:
        return self._datastore._submit_channel_op(self._channel_id, contents,
                                                  ref_seq)

    @property
    def ref_seq(self):
        return self._datastore._container.ref_seq

    @property
    def min_seq(self):
        return self._datastore._container.min_seq


class FluidDataStoreRuntime:
    """One datastore: a bag of named channels behind one address."""

    def __init__(self, datastore_id: str, registry: ChannelRegistry,
                 rooted: bool = True) -> None:
        self.id = datastore_id
        self.registry = registry
        self.rooted = rooted  # GC root-set membership
        self.channels: Dict[str, SharedObject] = {}
        self._container = None  # set by the container runtime on attach

    # -- channel lifecycle -----------------------------------------------------

    def create_channel(self, type_name: str, channel_id: str) -> SharedObject:
        if channel_id in self.channels:
            raise ValueError(f"channel {channel_id!r} already exists")
        channel = self.registry.get(type_name).create(channel_id)
        self.channels[channel_id] = channel
        # Dynamically created channels (container already live) announce
        # themselves with a sequenced attach op so every remote replica
        # materializes the channel before its first op arrives; channels
        # created while detached ride the attach summary instead.
        if self._container is not None and self._container.is_attached:
            self._container._submit_channel_attach(
                self.id, channel_id, type_name
            )
        self._connect_channel(channel)
        return channel

    def _materialize_remote_channel(self, type_name: str,
                                    channel_id: str) -> None:
        """A peer's channelAttach op: create the (empty) channel."""
        existing = self.channels.get(channel_id)
        if existing is not None:
            if existing.TYPE != type_name:
                # Two clients concurrently created the same channel id with
                # different types — an app-level id collision that cannot
                # merge.  Fail loudly (the reference asserts) instead of
                # silently routing one type's ops into the other.
                raise RuntimeError(
                    f"conflicting channelAttach for "
                    f"{self.id!r}/{channel_id!r}: {existing.TYPE} vs "
                    f"{type_name}"
                )
            return  # our own attach echo (or identical concurrent create)
        channel = self.registry.get(type_name).create(channel_id)
        self.channels[channel_id] = channel
        self._connect_channel(channel)

    def get_channel(self, channel_id: str) -> SharedObject:
        return self.channels[channel_id]

    def _connect_channel(self, channel: SharedObject) -> None:
        if self._container is not None and \
                getattr(self._container, "attribution_enabled", False):
            # Attribution resolver: DDS reads translate their seq stamps
            # (segment insert seqs, tree node seqs) to (user, timestamp)
            # through the container-level attributor.  Only wired on
            # attribution-enabled documents — the wiring also gates the
            # channels' attribution summary blobs.
            channel._attributor = self._container.attributor
        if self._container is not None and self._container.client_id:
            channel.connect(
                ChannelDeltaConnection(self, channel.id),
                self._container.client_id,
            )

    def _attach(self, container) -> None:
        self._container = container
        for channel in self.channels.values():
            self._connect_channel(channel)

    # -- op routing ------------------------------------------------------------

    def _submit_channel_op(self, channel_id: str, contents,
                           ref_seq=None) -> int:
        return self._container._submit_op(
            {"ds": self.id, "channel": channel_id, "contents": contents},
            ref_seq=ref_seq,
        )

    def process(self, msg: SequencedMessage, envelope: dict,
                local: bool) -> None:
        channel = self.channels.get(envelope["channel"])
        if channel is None:
            raise KeyError(
                f"datastore {self.id!r}: op for unknown channel "
                f"{envelope['channel']!r}"
            )
        channel.process(
            dataclasses.replace(msg, contents=envelope["contents"]), local
        )

    def advance(self, seq: int, min_seq: int,
                skip_channel: Optional[str] = None) -> None:
        for channel_id, channel in self.channels.items():
            if channel_id == skip_channel:
                continue
            advance = getattr(channel, "advance", None)
            if advance:
                advance(seq, min_seq)

    def resubmit_pending(self, force_rebase: bool = False) -> None:
        for channel in self.channels.values():
            channel.resubmit_pending(force_rebase=force_rebase)

    # -- summaries -------------------------------------------------------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        channel_types = {}
        for channel_id in sorted(self.channels):
            channel = self.channels[channel_id]
            tree.children[channel_id] = channel.summarize(min_seq)
            channel_types[channel_id] = channel.TYPE
        tree.add_blob(".attributes", canonical_json(
            {"channels": channel_types, "rooted": self.rooted}
        ))
        return tree

    def load(self, summary: SummaryTree) -> None:
        import json

        attributes = json.loads(summary.blob_bytes(".attributes"))
        self.rooted = attributes.get("rooted", True)
        self.channels = {}
        for channel_id, type_name in attributes["channels"].items():
            subtree = summary.children[channel_id]
            channel = self.registry.get(type_name).load(channel_id, subtree)
            self.channels[channel_id] = channel
            self._connect_channel(channel)
