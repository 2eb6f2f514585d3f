"""fluidproc client adapter: the service surface over the front door.

What lets the fluidscale swarm (``testing/scenarios.py``) — and any other
harness written against the in-process ``LocalOrderingService`` /
``ShardedOrderingService`` duck type — drive the REAL out-of-process
tier unchanged: batched ingress ships as ONE ``submit_mixed`` RPC per
tick (boxed op dicts + the struct-packed columnar batch), durable heads
and contiguity checks read back over bulk routes, and summary uploads
ride the existing ``upload_summary`` RPC.  The front door object runs
in-process (it IS the harness's supervisor); only the shards are real
processes.

Replica HA: the adapter takes an optional list of REPLICA
doors fronting the same shard fleet.  The data path pins to the newest
replica; when its socket dies (a replica SIGKILL drops every connection
with nothing flushed) the adapter rotates to the next live door and
resends — safe for every route it carries, because submits dedup by
(client, client_seq) server-side and reads are idempotent.  Control
calls (``tick``, ``router``, ``stats``) stay direct object calls on the
PRIMARY door: the fault-plan driver is the harness's supervisor, not a
wire client.

The adapter deliberately implements the NARROW surface the swarm
consumes — ``endpoint(doc).connect_many/connect_columns``,
``submit_mixed``, ``oplog.head/batch/is_contiguous``, ``storage.upload``,
``heads``, ``tick``, ``router`` — not the full service contract; real
clients use ``NetworkDocumentServiceFactory`` against the front door.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np

from ..drivers.network_driver import (RpcTimeoutError, RpcTransportError,
                                      _RpcClient)
from ..protocol import errors as wire_errors
from ..protocol.summary import tree_to_obj
from ..protocol.wire import ColumnBatch, encode_column_batch, \
    encode_raw_operation
from .frontdoor import FrontDoor
from .orderer import SubmitOutcome


class ProcEndpoint:
    """Per-document ingress facade over the front door (JOIN cohorts;
    per-op routes ride the network driver, not this adapter)."""

    def __init__(self, client: "ProcServiceClient", doc_id: str) -> None:
        self._client = client
        self.doc_id = doc_id

    def connect_many(self, client_ids: List[str],
                     session: Optional[str] = None) -> None:
        self._client.request("connect_many", {
            "doc": self.doc_id, "clients": list(client_ids),
            "session": session, "columnar": False})

    def connect_columns(self, client_ids: List[str],
                        session: Optional[str] = None) -> None:
        self._client.request("connect_many", {
            "doc": self.doc_id, "clients": list(client_ids),
            "session": session, "columnar": True})


class _ProcLogView:
    """The swarm's ``service.oplog`` reads, over the wire.  ``batch()``
    is a no-op context: group commit happens server-side — each shard's
    ``submit_mixed`` already lands under ONE flush of ITS log."""

    def __init__(self, client: "ProcServiceClient") -> None:
        self._client = client

    def head(self, doc_id: str) -> int:
        return self._client.heads([doc_id])[doc_id]

    def is_contiguous(self, doc_id: str) -> bool:
        return bool(self._client.request("log_contiguous",
                                         {"doc": doc_id}))

    def batch(self):
        return contextlib.nullcontext(self)


class _ProcStorageView:
    """``service.storage.upload`` for the swarm's summary elections."""

    def __init__(self, client: "ProcServiceClient") -> None:
        self._client = client

    def upload(self, doc_id: str, tree, ref_seq: int) -> str:
        result = self._client.request("upload_summary", {
            "doc": doc_id, "summary": tree_to_obj(tree),
            "ref_seq": ref_seq})
        return result["handle"]


def _decode_outcome(wire: dict) -> SubmitOutcome:
    error: Optional[BaseException] = None
    if wire.get("error") is not None:
        # Typed-enough reconstruction: the swarm's recovery contract only
        # branches on "failed at all" (defer + whole-batch resubmit).
        # The code must still be a registered outcome-channel row
        # (protocol/errors.py); taxonomy drift is stamped into the text
        # instead of silently passing as a registered failure.
        code = wire.get("code")
        if not wire_errors.is_registered(code):
            code = f"unregistered:{code}"
        error = ConnectionError(f"[{code}] {wire['error']}")
    return SubmitOutcome(stamped=[], consumed=int(wire["consumed"]),
                         error=error, stamped_count=int(wire["stamped"]))


class ProcServiceClient:
    """The ordering-tier surface of a fluidproc deployment, for swarm
    harnesses.  One RPC connection to an (in-process) front door — the
    newest replica when replicas exist — with dead-door rotation; the
    fault-plan ``tick`` and the router are direct object calls on the
    primary — the supervisor is local even though every shard is a
    separate process."""

    def __init__(self, door: FrontDoor, timeout: float = 120.0,
                 replicas: Optional[List[FrontDoor]] = None) -> None:
        self.door = door
        self._timeout = float(timeout)
        #: every door fronting the fleet, primary first; the data path
        #: pins to the LAST (newest replica) so a replica-death drill
        #: kills the door the traffic actually rides.
        self.doors: List[FrontDoor] = [door] + list(replicas or [])
        self._at = len(self.doors) - 1
        self.rpc = _RpcClient("127.0.0.1", self.doors[self._at].port,
                              timeout=self._timeout)
        #: door rotations taken (the drill pins this went >= 1)
        self.door_failovers = 0
        self.oplog = _ProcLogView(self)
        self.storage = _ProcStorageView(self)

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        """One RPC with door failover: a dead socket (replica SIGKILL)
        rotates to the next live door and resends.  Typed refusals
        (nack / wrongShard / fence) pass through — they are the
        SERVICE talking, not the transport dying; only transport-shaped
        failures rotate.  Resends are safe on every adapter route:
        submits dedup by (client, client_seq), everything else is a
        read or an idempotent registration."""
        last: Optional[BaseException] = None
        for _attempt in range(len(self.doors) + 1):
            try:
                return self.rpc.request(method, params, timeout=timeout)
            except (RpcTransportError, RpcTimeoutError) as exc:
                last = exc
                if not self._rotate_door():
                    break
        raise last

    def _rotate_door(self) -> bool:
        """Reconnect to the next door not known-dead (``killed`` is the
        harness's own flag; a door killed out-of-band just fails its
        connect and the rotation continues).  Returns False when every
        candidate is exhausted."""
        try:
            self.rpc.close()
        except OSError:
            pass
        for step in range(1, len(self.doors) + 1):
            idx = (self._at - step) % len(self.doors)
            candidate = self.doors[idx]
            if candidate.killed:
                continue
            try:
                self.rpc = _RpcClient("127.0.0.1", candidate.port,
                                      timeout=self._timeout)
            except OSError:
                continue
            self._at = idx
            self.door_failovers += 1
            return True
        return False

    @property
    def router(self):
        return self.door.router

    def tick(self, now: int) -> List[str]:
        return self.door.tick(now)

    def endpoint(self, doc_id: str) -> ProcEndpoint:
        return ProcEndpoint(self, doc_id)

    def heads(self, doc_ids: List[str]) -> Dict[str, int]:
        if not doc_ids:
            return {}
        return self.request("heads", {"docs": list(doc_ids)})

    def contiguous(self, doc_ids: List[str]) -> Dict[str, bool]:
        if not doc_ids:
            return {}
        return self.request("log_contiguous", {"docs": list(doc_ids)})

    def doc_ids(self) -> List[str]:
        return self.door.doc_ids()

    def submit_mixed(self, batches: Optional[Dict[str, list]],
                     batch: Optional[ColumnBatch],
                     doc_rows: Optional[Dict[str, np.ndarray]]
                     ) -> Dict[str, SubmitOutcome]:
        """ONE RPC per tick: boxed batches as codec dicts, the columnar
        batch struct-packed (compact tables) with per-doc row RANGES —
        swarm rows are contiguous per document by construction, and the
        range form keeps the frame small."""
        payload: dict = {"batches": {
            doc: [encode_raw_operation(op) for op in ops]
            for doc, ops in (batches or {}).items()
        }}
        if batch is not None and doc_rows:
            ranges = {}
            for doc, rows in doc_rows.items():
                s, e = int(rows[0]), int(rows[-1]) + 1
                if e - s != rows.shape[0]:
                    raise ValueError(
                        f"non-contiguous row slice for {doc!r}")
                ranges[doc] = [s, e]
            payload["columns"] = encode_column_batch(batch)
            payload["doc_rows"] = ranges
        out = self.request("submit_mixed", payload)
        return {doc: _decode_outcome(w) for doc, w in out.items()}

    def submit_many(self, batches: Dict[str, list]
                    ) -> Dict[str, SubmitOutcome]:
        return self.submit_mixed(batches, None, None)

    def stats(self) -> dict:
        return self.door.stats()

    def close(self) -> None:
        self.rpc.close()
