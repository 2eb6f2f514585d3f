"""Sharded ordering tier: document-partitioned orderers with epoch-fenced
failover (SURVEY §2.3's Kafka-partitioned Deli sequencers,
re-shaped for the in-process/single-host deployment).

The fold tier already runs on a multi-slice mesh while every op flowed
through ONE ``LocalOrderingService`` — sequencing was the scaling wall
for heavy live traffic.  This module partitions documents across N
orderer shards behind the same ``DocumentEndpoint`` contract:

- :class:`ShardRouter` — deterministic rendezvous (highest-random-weight)
  hashing of ``doc_id`` → shard.  Every router instance over the same
  shard list computes the same owner (no coordination state to
  replicate), adding a shard moves only ~1/N documents, and removing a
  dead shard moves ONLY the dead shard's documents.
- :class:`ShardedOrderingService` — owns N :class:`LocalOrderingService`
  shards over ONE shared durable :class:`OpLog` + summary store (the
  scriptorium/historian tier the reference likewise shares behind its
  partitioned sequencers) and routes every document operation through
  the router.

Failover rides machinery that already exists.  ``kill_shard``:

1. marks the shard dead in the router (new requests route elsewhere),
2. **fences** every orderer the dead shard owned — the fence aborts any
   stamp before the durable append, so the log-append-before-broadcast
   invariant guarantees sequencing never forks: nothing a fenced orderer
   stamps becomes durable or visible,
3. bumps the **storage epoch** (deterministically derived from the old
   epoch + shard id), so every client/cache pinned to the pre-failover
   generation hits the existing ``epochMismatch`` reconnect path instead
   of silently mixing state across the fence,
4. notifies fence listeners (the network front door re-taps live
   broadcast subscriptions and pushes fence events to clients).

The re-owned documents are rebuilt lazily: the first ``endpoint()`` on
the new owner replays the durable log via ``DocumentOrderer.recover``
(single-flight — a reconnect herd costs one replay per document), and
the recovered sequencer continues the sequence exactly where the log
ends — seq numbers stay strictly contiguous per document.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..protocol.messages import RawOperation
from ..protocol.summary import SummaryStorage
from ..protocol.wire import ColumnBatch
from .oplog import OpLog
from .orderer import (DocumentEndpoint, DocumentOrderer,
                      LocalOrderingService, SubmitOutcome, submit_batches,
                      submit_column_batches, submit_mixed_batches)

#: fence listener: (dead shard id, affected doc ids, new storage epoch)
FenceListener = Callable[[str, List[str], str], None]


def fence_token(epoch: str, shard_id: str) -> str:
    """Deterministic next storage epoch for fencing ``shard_id`` out of a
    tier whose current epoch is ``epoch`` — ONE derivation shared by the
    in-proc tier and the fluidproc front door, because byte-identical
    fence epochs across tiers are part of the failover parity bar."""
    return hashlib.sha256(
        b"fence\x00" + epoch.encode("utf-8")
        + b"\x00" + shard_id.encode("utf-8")
    ).hexdigest()


def rendezvous_score(doc_id: str, shard_id: str) -> int:
    """Deterministic 64-bit weight of (document, shard) — sha256-based so
    every process/run agrees without shared state, and uncorrelated
    across shards so each document's preference list is an independent
    permutation (what makes reassignment move only ~1/N docs)."""
    h = hashlib.sha256(
        doc_id.encode("utf-8") + b"\x00" + shard_id.encode("utf-8")
    )
    return int.from_bytes(h.digest()[:8], "big")


class ShardRouter:
    """Rendezvous-hashing document → shard ownership with liveness.

    Thread-safe; owners are computed, never stored, so there is no
    assignment table to migrate or corrupt — liveness (the dead set) is
    the only mutable state.
    """

    def __init__(self, shard_ids: List[str]) -> None:
        if not shard_ids:
            raise ValueError("router needs at least one shard")
        if len(set(shard_ids)) != len(shard_ids):
            raise ValueError(f"duplicate shard ids: {shard_ids}")
        self._lock = threading.Lock()
        self._shard_ids: List[str] = list(shard_ids)  # guarded-by: _lock
        self._dead: set = set()  # guarded-by: _lock
        #: bumped on every liveness/topology change — the invalidation
        #: token for cached doc→shard assignments
        self._version = 0  # guarded-by: _lock

    @property
    def version(self) -> int:
        """Monotone topology version: changes exactly when ``owner``
        results may change (shard death, shard add)."""
        with self._lock:
            return self._version

    def shard_ids(self) -> List[str]:
        with self._lock:
            return list(self._shard_ids)

    def alive(self) -> List[str]:
        with self._lock:
            return [s for s in self._shard_ids if s not in self._dead]

    def dead(self) -> List[str]:
        with self._lock:
            return sorted(self._dead)

    def owner(self, doc_id: str) -> str:
        """The live shard owning ``doc_id`` — highest rendezvous weight
        over the alive set (shard id tie-break for total determinism)."""
        candidates = self.alive()
        if not candidates:
            raise RuntimeError("no live shards")
        return max(
            candidates, key=lambda sid: (rendezvous_score(doc_id, sid), sid)
        )

    def mark_dead(self, shard_id: str) -> bool:
        """Remove a shard from the live set; its documents re-route on
        the next ``owner`` call.  Returns False if already dead."""
        with self._lock:
            if shard_id not in self._shard_ids:
                raise KeyError(shard_id)
            if shard_id in self._dead:
                return False
            self._dead.add(shard_id)
            if len(self._dead) == len(self._shard_ids):
                self._dead.discard(shard_id)
                raise RuntimeError("cannot kill the last live shard")
            self._version += 1
            return True

    def add_shard(self, shard_id: str) -> None:
        with self._lock:
            if shard_id in self._shard_ids:
                raise ValueError(f"shard {shard_id!r} already exists")
            self._shard_ids.append(shard_id)
            self._version += 1


class ShardedOrderingService:
    """Document-partitioned ordering tier behind the single-service
    surface: ``create_document`` / ``has_document`` / ``endpoint`` /
    ``doc_ids`` / ``storage`` / ``oplog`` — everything the front door,
    the drivers, and the catch-up service already consume — so it drops
    into ``OrderingServer``/``LocalDocumentServiceFactory`` unchanged.

    All shards share ONE durable op log and ONE summary store (the
    durable tier); each shard owns only in-memory sequencing state, which
    is exactly what makes failover a log replay instead of a data
    migration.
    """

    def __init__(
        self,
        n_shards: int = 4,
        oplog: Optional[OpLog] = None,
        storage: Optional[SummaryStorage] = None,
        throttle=None,
        shard_ids: Optional[List[str]] = None,
        faults=None,
    ) -> None:
        ids = (list(shard_ids) if shard_ids is not None
               else [f"shard{i:02d}" for i in range(n_shards)])
        self.oplog = oplog if oplog is not None else OpLog()
        self.storage = storage if storage is not None else SummaryStorage()
        self.throttle = throttle
        self.router = ShardRouter(ids)
        self._shards: Dict[str, LocalOrderingService] = {
            sid: LocalOrderingService(
                oplog=self.oplog, storage=self.storage, throttle=throttle
            )
            for sid in ids
        }
        #: same contract as LocalOrderingService.handle_tenants: the
        #: tenant grant map is service-global (content-addressed nodes are
        #: shared across shards), mutated by executor threads.
        self.handle_tenants: Dict[str, set] = {}  # guarded-by: state_lock
        #: doc_id -> owning shard id, valid while the router topology is
        #: unchanged; refreshed wholesale on fence/epoch events (shard
        #: kill, shard add) via the router version token — the columnar
        #: ingress consults this instead of rendezvous-hashing every
        #: document on every tick.
        self._owner_cache: Dict[str, str] = {}  # guarded-by: state_lock
        #: doc_id -> resolved endpoint on the cached owner, same
        #: invalidation discipline (one endpoint construction per doc
        #: per topology epoch instead of one per tick)
        self._endpoint_cache: Dict[str, DocumentEndpoint] = {}  # guarded-by: state_lock
        self._owner_cache_version = -1  # guarded-by: state_lock
        self.state_lock = threading.RLock()
        self._fence_listeners: List[FenceListener] = []  # guarded-by: state_lock
        #: monotone count of completed failovers (introspection/benches)
        self.fences = 0  # guarded-by: state_lock
        #: faultline hook: ``tick()`` consults this injector's scheduled
        #: ``shard.kill`` points (testing/faults.py) — failovers fire at
        #: deterministic virtual ticks instead of hand-placed test calls.
        self._faults = faults
        # Serializes kill_shard end-to-end: the fence-then-flip sequence
        # must not interleave with another kill (two racing kills could
        # both pass the last-live-shard check, fence their orderers, and
        # leave one fenced-but-still-routed shard behind).  Kills are
        # rare; holding one lock across the whole failover is the simple
        # correct shape.
        self._kill_lock = threading.Lock()

    # -- routing ---------------------------------------------------------------

    def shard_of(self, doc_id: str) -> str:
        """The live shard currently owning ``doc_id``."""
        return self.router.owner(doc_id)

    def shard_service(self, shard_id: str) -> LocalOrderingService:
        return self._shards[shard_id]

    def set_commit_hook(self, fn) -> None:
        """Fan the commit watcher out to every shard (streaming
        fold): whichever shard owns a document — now or after a
        failover re-own — its sequencer feeds the same hook."""
        for sid in sorted(self._shards):
            self._shards[sid].set_commit_hook(fn)

    def _owner(self, doc_id: str) -> LocalOrderingService:
        return self._shards[self.router.owner(doc_id)]

    # -- the LocalOrderingService surface --------------------------------------

    def create_document(self, doc_id: str) -> DocumentEndpoint:
        return self._owner(doc_id).create_document(doc_id)

    def has_document(self, doc_id: str) -> bool:
        # The shared oplog makes any shard's view authoritative for logged
        # docs; the storage probe additionally covers a summary-only doc
        # whose creating shard died before its first op.
        return (self._owner(doc_id).has_document(doc_id)
                or self.storage.head(doc_id) is not None)

    def _cached_owner(self, doc_id: str) -> str:
        """Owner lookup through the fence-refreshed assignment cache: a
        topology change (kill/add — the same events that bump the storage
        epoch) invalidates the whole cache via the router version, so a
        stale entry can survive at most until the next call."""
        version = self.router.version
        with self.state_lock:
            if self._owner_cache_version != version:
                self._owner_cache = {}
                self._endpoint_cache = {}
                self._owner_cache_version = version
            owner = self._owner_cache.get(doc_id)
            if owner is None:
                owner = self.router.owner(doc_id)
                self._owner_cache[doc_id] = owner
        return owner

    def shard_assignment(self, doc_ids: Sequence[str]) -> np.ndarray:
        """Vectorized doc→shard assignment: for each document, the
        ordinal of its owning shard in ``router.shard_ids()`` order —
        int32, aligned with ``doc_ids``.  Backed by the same
        fence-refreshed cache the columnar ingress routes through."""
        order = {sid: i for i, sid in enumerate(self.router.shard_ids())}
        return np.fromiter(
            (order[self._cached_owner(d)] for d in doc_ids),
            np.int32, count=len(doc_ids))

    def _endpoint_on(self, owner: LocalOrderingService,
                     doc_id: str) -> DocumentEndpoint:
        try:
            return owner.endpoint(doc_id)
        except KeyError:
            # Unknown to the owner AND absent from the log: a summary-only
            # document (created + summarized, zero ops) re-owned after a
            # failover.  Re-create its (empty) orderer on the new owner —
            # the summary store, shared and content-addressed, still holds
            # its state.
            if self.storage.head(doc_id) is None:
                raise
            try:
                return owner.create_document(doc_id)
            except ValueError:
                return owner.endpoint(doc_id)  # lost a benign create race

    def endpoint(self, doc_id: str) -> DocumentEndpoint:
        return self._endpoint_on(self._owner(doc_id), doc_id)

    def _endpoint_probe(self, doc_id: str) -> Optional[DocumentEndpoint]:
        with self.state_lock:
            return self._endpoint_cache.get(doc_id)

    def _endpoint_install(self, doc_id: str,
                          endpoint: DocumentEndpoint) -> DocumentEndpoint:
        # Re-validate the topology under the lock before caching: an
        # endpoint resolved against a pre-kill owner must not be
        # installed into a cache already refreshed to the post-kill
        # version (it would serve ShardFencedError until the NEXT
        # topology change).  On a version mismatch the endpoint is
        # returned uncached — worst case one fenced submit, and the
        # resubmit re-resolves freshly.  setdefault additionally lets a
        # concurrent resolver's endpoint win (both are stateless
        # facades).
        version = self.router.version
        with self.state_lock:
            if self._owner_cache_version != version:
                return endpoint
            return self._endpoint_cache.setdefault(doc_id, endpoint)

    def _cached_endpoint(self, doc_id: str) -> DocumentEndpoint:
        owner = self._cached_owner(doc_id)  # refreshes both caches
        endpoint = self._endpoint_probe(doc_id)
        if endpoint is not None:
            return endpoint
        # Resolve OUTSIDE the lock (endpoint() may replay a log on
        # failover recovery; state_lock stays dict-operations-only).
        return self._endpoint_install(
            doc_id, self._endpoint_on(self._shards[owner], doc_id))

    def submit_many(self, batches: Dict[str, List[RawOperation]]
                    ) -> Dict[str, SubmitOutcome]:
        """Batched ingress across the shard tier — see
        :func:`~.orderer.submit_batches`: the
        per-document ``endpoint()`` route lands each batch on its
        rendezvous owner (one MSN recomputation per doc batch) and the
        whole call pays ONE flush of the shared durable log.  A document
        whose owner died re-routes and recovers lazily inside
        ``endpoint()``, so the NEXT submit after a failover lands on the
        recovered owner with no caller-side special case."""
        return submit_batches(self, batches)

    def submit_columns(self, batch: ColumnBatch,
                       doc_rows: Dict[str, np.ndarray]
                       ) -> Dict[str, SubmitOutcome]:
        """Columnar batched ingress across the shard tier — the boxed
        ``submit_many`` contract (sorted per-doc order, ONE shared-log
        flush, per-doc :class:`SubmitOutcome` isolation,
        whole-batch-resubmit on ``BatchAbortedError``) over
        :class:`ColumnBatch` row slices, routed through the
        fence-refreshed doc→shard assignment cache (array form:
        :meth:`shard_assignment`) instead of per-call rendezvous
        hashing.  A kill between cache refreshes surfaces as
        a fenced per-doc outcome; the resubmit re-resolves through the
        bumped router version."""
        return submit_column_batches(self, batch, doc_rows,
                                     endpoint_of=self._cached_endpoint)

    def submit_mixed(self, batches: Optional[Dict[str, List[RawOperation]]],
                     batch: Optional[ColumnBatch],
                     doc_rows: Optional[Dict[str, np.ndarray]]
                     ) -> Dict[str, SubmitOutcome]:
        """Both ingress shapes in ONE sorted per-doc pass (the parity
        requirement under occurrence-indexed fault schedules) — see
        :func:`~.orderer.submit_mixed_batches`;
        routed through the fence-refreshed assignment cache."""
        return submit_mixed_batches(self, batches, batch, doc_rows,
                                    endpoint_of=self._cached_endpoint)

    def doc_ids(self) -> List[str]:
        ids = set(self.oplog.doc_ids())
        for shard in self._shards.values():
            ids.update(shard.doc_ids())
        return sorted(ids)

    def checkpoint(self) -> dict:
        """Flat {doc_id: orderer checkpoint} over every live shard —
        ownership is derivable (rendezvous), so it is not serialized."""
        out: dict = {}
        for sid in self.router.alive():
            out.update(self._shards[sid].checkpoint())
        return out

    @staticmethod
    def restore(
        oplog: OpLog,
        storage: SummaryStorage,
        checkpoint: dict,
        shard_ids: List[str],
    ) -> "ShardedOrderingService":
        """Rebuild a sharded service: each document's checkpoint replays
        into the shard the router assigns it to (the checkpoint may have
        been taken under a different shard list — rendezvous re-routes)."""
        service = ShardedOrderingService(
            oplog=oplog, storage=storage, shard_ids=shard_ids
        )
        routed: Dict[str, Dict[str, DocumentOrderer]] = {}
        for doc_id, doc_checkpoint in checkpoint.items():
            routed.setdefault(service.router.owner(doc_id), {})[doc_id] = \
                DocumentOrderer.restore(doc_id, oplog, storage,
                                        doc_checkpoint)
        for sid, orderers in routed.items():
            shard = service._shards[sid]
            with shard.state_lock:
                shard._orderers.update(orderers)
        return service

    # -- failover --------------------------------------------------------------

    def add_fence_listener(self, fn: FenceListener) -> None:
        with self.state_lock:
            self._fence_listeners.append(fn)

    def fence_token(self, shard_id: str) -> str:
        """Deterministic next storage epoch for killing ``shard_id``:
        derived from the current epoch so replay harnesses produce the
        same fence token on every run (no wall clock, no PRNG)."""
        return fence_token(self.storage.epoch, shard_id)

    def kill_shard(self, shard_id: str) -> List[str]:
        """Fail one shard: fence its orderers, re-route its documents,
        bump the storage epoch, notify listeners.  Returns the affected
        doc ids (documents the shard held live orderers for).  Idempotent
        — a second kill of the same shard returns [].

        Ordering matters: each orderer is fenced FIRST — fence() shares a
        lock with the durable-append subscriber, so when the sweep
        finishes every in-flight stamp has either landed (part of what
        the new owner will replay) or aborted, and the log is quiescent
        for the dead shard's documents — and only THEN does the router
        flip, so a recovery on the new owner can never replay a prefix a
        not-yet-fenced orderer still extends.  (Between fence and flip a
        submit routed to the dead shard fails fenced; clients retry
        through the re-resolved owner.)  The epoch bump then invalidates
        every pre-failover pin.
        """
        with self._kill_lock:
            dead = self._shards[shard_id]  # KeyError on unknown shard
            if shard_id in self.router.dead():
                return []
            if len(self.router.alive()) <= 1:
                raise RuntimeError("cannot kill the last live shard")
            with self.state_lock:
                listeners = list(self._fence_listeners)
            # Shard-level fence: flips the shard's refuse-new-orderers
            # flag BEFORE sweeping, so a single-flight recovery in flight
            # at kill time publishes its orderer fenced instead of live —
            # no interleaving leaves a sequencing orderer on this shard.
            affected = dead.fence_all()
            self.router.mark_dead(shard_id)
            with self.state_lock:
                self.fences += 1
            new_epoch = self.storage.bump_epoch(self.fence_token(shard_id))
            for fn in listeners:
                fn(shard_id, affected, new_epoch)
            return affected

    def tick(self, now: int) -> List[str]:
        """Fault-plan driver: execute every scheduled ``shard.kill``
        whose virtual tick has arrived (the chaos harness calls this once
        per step).  The victim is the point's named shard, else the
        current owner of its named document, else the first live shard —
        all deterministic under rendezvous routing.  Returns the affected
        doc ids across all kills this tick."""
        if self._faults is None:
            return []
        affected: List[str] = []
        for point in self._faults.due("shard.kill", now):
            if point.shard is not None:
                victim = point.shard
            elif point.doc is not None:
                victim = self.router.owner(point.doc)
            else:
                victim = self.router.alive()[0]
            if (victim in self.router.dead()
                    or len(self.router.alive()) <= 1):
                # Unexecutable kill: the victim already died, or it is
                # the last live shard (unkillable by contract).  Roll the
                # point's fired mark back so the coverage oracle REPORTS
                # it unfired, instead of crashing the harness step loop
                # or silently claiming a failover that never happened.
                self._faults.mark_unfired(point)
                continue
            affected.extend(self.kill_shard(victim))
        return affected

    # -- introspection ---------------------------------------------------------

    def shard_load(self) -> Dict[str, Tuple[int, int]]:
        """{shard_id: (live documents owned, ops sequenced across them)}
        — the balance surface the shard bench reports."""
        out: Dict[str, Tuple[int, int]] = {}
        for sid in self.router.alive():
            shard = self._shards[sid]
            with shard.state_lock:
                docs = sorted(shard._orderers)
            out[sid] = (
                len(docs), sum(self.oplog.head(d) for d in docs)
            )
        return out
