"""Local driver: binds the loader to an in-process ordering service.

Capability parity with the reference's local-driver +
``LocalDeltaConnectionServer`` pair (SURVEY.md §2.3/§2.4: the full
loader→driver→server loop in one process, no network)."""

from __future__ import annotations

from ..protocol.summary import SummaryTree
from ..service.orderer import LocalOrderingService
from .definitions import DeltaStorage, DocumentService, DocumentStorage


class LocalDocumentServiceFactory:
    """``IDocumentServiceFactory`` capability over a LocalOrderingService."""

    def __init__(self, service: LocalOrderingService) -> None:
        self.service = service

    def create_document(
        self, doc_id: str, initial_summary: SummaryTree, ref_seq: int = 0
    ) -> DocumentService:
        """Attach: register the document and store its initial summary (the
        reference's attach flow uploads the create-new summary)."""
        self.service.create_document(doc_id)
        self.service.storage.upload(doc_id, initial_summary, ref_seq)
        return self.resolve(doc_id)

    def resolve(self, doc_id: str) -> DocumentService:
        endpoint = self.service.endpoint(doc_id)
        return DocumentService(
            doc_id,
            connection=endpoint,
            delta_storage=DeltaStorage(self.service.oplog, doc_id),
            storage=DocumentStorage(self.service.storage, doc_id),
        )
