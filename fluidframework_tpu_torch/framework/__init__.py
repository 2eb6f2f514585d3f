"""Framework / app-facing API layer.

Capability-equivalent of the reference's ``aqueduct`` + ``fluid-static`` +
service-clients + ``presence`` + ``undo-redo`` packages (SURVEY.md §1 layer
8, §2.4)."""

from .data_object import DataObject, DataObjectFactory
from .fluid_static import ContainerSchema, FluidClient, FluidContainer
from .presence import Presence
from .undo_redo import UndoRedoStackManager

__all__ = [
    "ContainerSchema",
    "DataObject",
    "DataObjectFactory",
    "FluidClient",
    "FluidContainer",
    "Presence",
    "UndoRedoStackManager",
]
