"""The driver contract (duck-typed).

A *document service* gives the loader three things for one document:

- ``connection()``      — the live delta connection: ``submit(RawOperation)``,
  ``subscribe(fn)`` / ``unsubscribe(fn)``, ``connect(client_id)`` /
  ``disconnect(client_id)``, and signals (``submit_signal`` /
  ``subscribe_signals``).
- ``delta_storage``     — ranged reads of the durable sequenced-op log:
  ``get(from_seq, to_seq)`` (the catch-up feed).
- ``storage``           — the summary store scoped to the document:
  ``latest() -> (tree, ref_seq)``, ``upload(tree, ref_seq) -> handle``,
  ``read(handle)``.

``DocumentService``/``DocumentStorage`` here are the shared concrete glue
drivers compose; a driver only has to supply an endpoint-like connection
object and the two stores.
"""

from __future__ import annotations

from typing import List, Optional

from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryStorage, SummaryTree
from ..service.oplog import OpLog


class DocumentStorage:
    """A summary store scoped to one document."""

    def __init__(self, storage: SummaryStorage, doc_id: str) -> None:
        self._storage = storage
        self.doc_id = doc_id

    def latest(self, at_or_below: Optional[int] = None):
        return self._storage.latest(self.doc_id, at_or_below=at_or_below)

    def upload(self, tree: SummaryTree, ref_seq: int) -> str:
        return self._storage.upload(self.doc_id, tree, ref_seq)

    def read(self, handle: str):
        return self._storage.read(handle)


class DeltaStorage:
    """Ranged reads over the durable op log, scoped to one document."""

    def __init__(self, oplog: OpLog, doc_id: str) -> None:
        self._oplog = oplog
        self.doc_id = doc_id

    def get(self, from_seq: int = 0,
            to_seq: Optional[int] = None) -> List[SequencedMessage]:
        return self._oplog.get(self.doc_id, from_seq, to_seq)

    def head(self) -> int:
        return self._oplog.head(self.doc_id)


class DocumentService:
    """One document's driver surface: connection + the two stores."""

    def __init__(self, doc_id: str, connection, delta_storage: DeltaStorage,
                 storage: DocumentStorage) -> None:
        self.doc_id = doc_id
        self._connection = connection
        self.delta_storage = delta_storage
        self.storage = storage

    def connection(self):
        return self._connection
