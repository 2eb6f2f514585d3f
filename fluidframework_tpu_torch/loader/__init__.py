"""Loader layer: container lifecycle, delta manager, audience, pending
state (SURVEY.md §1 layer 4 — the reference's container-loader package),
copied from the JAX package's ``loader/``: the clients that tests and
``chip_smoke.py`` point at the port's server."""

from .delta_manager import ConnectionState, DeltaManager
from .loader import Audience, Container, Loader

__all__ = [
    "Audience",
    "Container",
    "ConnectionState",
    "DeltaManager",
    "Loader",
]
