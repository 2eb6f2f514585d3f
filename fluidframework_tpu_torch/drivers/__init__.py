"""Driver layer — the client↔service boundary.

Capability-equivalent of the reference's driver contract
(``IDocumentServiceFactory → IDocumentService → {delta connection, delta
storage, storage}``; SURVEY.md §1 layer 3, §2.4), copied from the JAX
package's ``drivers/``.  Drivers are duck-typed (see :mod:`definitions`):

- :mod:`local_driver`  — binds to an in-process :class:`LocalOrderingService`
  (the reference's local-driver + server-local-server pattern).
- :mod:`replay_driver` — read-only reconstruction of any historical sequence
  point from a static op log (replay-driver / replay-tool capability).
- :mod:`file_driver`   — durable single-host deployment: file-backed op log
  and content-addressed summary store that reopen across processes.
- :mod:`network_driver` — clients in OTHER processes over TCP, against the
  :mod:`..service.server` front door (routerlicious-driver capability).
"""

from .definitions import DocumentService, DocumentStorage
from .file_driver import FileDocumentServiceFactory, FileSummaryStorage
from .local_driver import LocalDocumentServiceFactory
from .network_driver import NetworkDocumentServiceFactory
from .replay_driver import ReplayDocumentService

__all__ = [
    "DocumentService",
    "DocumentStorage",
    "FileDocumentServiceFactory",
    "FileSummaryStorage",
    "LocalDocumentServiceFactory",
    "NetworkDocumentServiceFactory",
    "ReplayDocumentService",
]
