"""Copies of the JAX package's runtime modules the port needs: the channel
registry, datastores and the container runtime (the catch-up service's
CPU fold and summary reassembly), the op attributor, and their helpers
(handles, blobs, gc, id compressor, op pipeline), and the summarizer
(election, heuristics, upload, ack tracking)."""

from .registry import ChannelFactory, ChannelRegistry, default_registry
from .datastore import ChannelDeltaConnection, FluidDataStoreRuntime
from .container import ContainerRuntime, OrderedClientElection
from .summarizer import SummarizerOptions, SummaryManager

__all__ = [
    "ChannelFactory",
    "ChannelRegistry",
    "default_registry",
    "ChannelDeltaConnection",
    "FluidDataStoreRuntime",
    "ContainerRuntime",
    "OrderedClientElection",
    "SummarizerOptions",
    "SummaryManager",
]
