"""Replay driver: deterministic reconstruction of historical states.

Capability parity with the reference's replay-driver / replay-tool
(SURVEY.md §2.4: replay an op log offline against snapshots, rebuild any
historical sequence number).  The "connection" is inert: nothing can be
submitted, nothing new arrives; the log *is* the document."""

from __future__ import annotations

from typing import List, Optional

from ..protocol.messages import RawOperation, SequencedMessage
from ..protocol.summary import SummaryStorage
from ..service.oplog import OpLog
from .definitions import DeltaStorage, DocumentStorage


class _ReadOnlyConnection:
    """A delta connection that rejects writes and never delivers."""

    def __init__(self, log: List[SequencedMessage]) -> None:
        self.log = log  # backfill feed for ContainerRuntime.connect

    def connect(self, client_id: str, session=None) -> None:
        pass  # no quorum to join: replay is not a live participant

    def disconnect(self, client_id: str) -> None:
        pass

    def subscribe(self, fn) -> None:
        pass  # nothing live will ever arrive

    def unsubscribe(self, fn) -> None:
        pass

    def submit(self, op: RawOperation):
        raise PermissionError("replay driver is read-only")

    def submit_signal(self, *a, **k):
        raise PermissionError("replay driver is read-only")

    def subscribe_signals(self, fn) -> None:
        pass


class _BoundedDeltaStorage(DeltaStorage):
    """Clamps reads to the replay horizon."""

    def __init__(self, oplog: OpLog, doc_id: str,
                 to_seq: Optional[int]) -> None:
        super().__init__(oplog, doc_id)
        self._to_seq = to_seq

    def get(self, from_seq: int = 0, to_seq: Optional[int] = None):
        horizon = self._to_seq
        if horizon is not None:
            to_seq = horizon if to_seq is None else min(to_seq, horizon)
        return super().get(from_seq, to_seq)

    def head(self) -> int:
        head = super().head()
        return head if self._to_seq is None else min(head, self._to_seq)


class _BoundedDocumentStorage(DocumentStorage):
    """Never serves a summary newer than the replay horizon."""

    def __init__(self, storage: SummaryStorage, doc_id: str,
                 to_seq: Optional[int]) -> None:
        super().__init__(storage, doc_id)
        self._to_seq = to_seq

    def latest(self, at_or_below: Optional[int] = None):
        bound = self._to_seq
        if at_or_below is not None:
            bound = at_or_below if bound is None else min(bound, at_or_below)
        return self._storage.latest(self.doc_id, at_or_below=bound)

    def upload(self, tree, ref_seq: int) -> str:
        raise PermissionError("replay driver is read-only")


class ReplayDocumentService:
    """Driver surface over a static (oplog, storage) pair, optionally
    truncated at ``to_seq`` — load a container "as of" any sequence point."""

    def __init__(
        self,
        doc_id: str,
        oplog: OpLog,
        storage: SummaryStorage,
        to_seq: Optional[int] = None,
    ) -> None:
        self.doc_id = doc_id
        self.delta_storage = _BoundedDeltaStorage(oplog, doc_id, to_seq)
        self.storage = _BoundedDocumentStorage(storage, doc_id, to_seq)
        self._connection = _ReadOnlyConnection(self.delta_storage.get())

    def connection(self):
        return self._connection
