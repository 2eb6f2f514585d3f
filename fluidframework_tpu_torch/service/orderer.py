"""Per-document orderer and the multi-document front door.

Capability-equivalent of the reference's ``LocalOrderer`` (memory-orderer:
deli + scribe + scriptorium lambdas wired in one process) plus the Alfred
front door (document creation, per-client delta connections, signal fan-out)
— SURVEY.md §2.3/§3.5; upstream paths UNVERIFIED, empty reference mount.

The shape differs from Routerlicious deliberately: there is no Kafka hop —
the sequencer broadcast *is* the bus, and the durable :class:`OpLog` append
happens inside the broadcast (first subscriber), so the log is always at or
ahead of any client's view and strictly ahead of the checkpoint.  Crash
resume = restore checkpoint + replay the log tail into the sequencer/scribe
state (exactly-once: ``replay`` never re-stamps).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from ..protocol.messages import (BatchAbortedError, RawOperation,
                                 SequencedMessage, ShardFencedError)
from ..protocol.sequencer import Sequencer
from ..protocol.summary import SummaryStorage
from ..protocol.wire import ColumnBatch, ColumnSegment, OpColumnSegment
from .oplog import OpLog
from .scribe import Scribe

SignalListener = Callable[[dict], None]


@dataclasses.dataclass
class SubmitOutcome:
    """Per-document result of a batched submit (``submit_many``).

    ``stamped`` holds the sequenced messages (duplicates dedup'd away);
    ``consumed`` counts ops fully handled (stamped OR dedup'd) — on
    success it equals the batch length.  ``error`` is the underlying
    failure when the batch stopped early (fence, injected append fault):
    ops ``[consumed:]`` were untouched, and the recovery contract is a
    whole-batch resubmit once the failure clears (dedup absorbs the
    stamped prefix).

    Columnar outcomes (``submit_columns``) leave ``stamped`` EMPTY and
    set ``stamped_count`` instead — the lazy-materialization contract:
    the stamped messages exist only as a column segment in the op log,
    so counting them must not box them.  Use :meth:`n_stamped` to count
    either shape."""

    stamped: List[SequencedMessage]
    consumed: int
    error: Optional[BaseException] = None
    stamped_count: Optional[int] = None

    def n_stamped(self) -> int:
        return (self.stamped_count if self.stamped_count is not None
                else len(self.stamped))


def submit_mixed_batches(service,
                         batches: Optional[Dict[str, List[RawOperation]]],
                         batch: Optional[ColumnBatch],
                         doc_rows: Optional[Dict[str, np.ndarray]],
                         endpoint_of=None) -> Dict[str, "SubmitOutcome"]:
    """THE batched-ingress loop, shared by both services and BOTH wire
    shapes: every document — boxed op lists from ``batches`` and
    :class:`ColumnBatch` row slices from ``doc_rows`` — in ONE globally
    sorted order, under ONE durable-log flush (group commit over the
    shared ``service.oplog``).  The single sorted interleaving is a
    parity requirement, not a style choice: occurrence-indexed fault
    schedules (the Nth ``oplog.append`` overall) must hit the same op
    whether a given document rode the boxed or the columnar shape this
    tick.  Failures are isolated per document — a fenced or faulted
    document reports its :class:`SubmitOutcome.error` while every other
    document's batch lands normally; the caller resubmits the failed
    documents' whole batches after recovery (dedup absorbs stamped
    prefixes).  Per-document sequencers make cross-document order
    irrelevant to the stamped bytes, so sorted-by-doc is both
    deterministic and sufficient.  ``endpoint_of`` overrides endpoint
    resolution (the sharded service passes its fence-refreshed
    assignment cache).  A document may appear in only ONE of the two
    shapes per call."""
    if endpoint_of is None:
        endpoint_of = service.endpoint
    batches = batches if batches is not None else {}
    doc_rows = doc_rows if doc_rows is not None else {}
    both = set(batches) & set(doc_rows)
    if both:
        raise ValueError(
            f"documents submitted in both shapes: {sorted(both)}")
    out: Dict[str, SubmitOutcome] = {}
    with service.oplog.batch():
        for doc_id in sorted(set(batches) | set(doc_rows)):
            try:
                endpoint = endpoint_of(doc_id)
                if doc_id in batches:
                    ops = batches[doc_id]
                    out[doc_id] = SubmitOutcome(
                        stamped=endpoint.submit_batch(ops),
                        consumed=len(ops))
                else:
                    rows = doc_rows[doc_id]
                    stamped = endpoint.submit_columns(batch, rows)
                    if isinstance(stamped, ColumnSegment):
                        out[doc_id] = SubmitOutcome(
                            stamped=[], consumed=int(rows.shape[0]),
                            stamped_count=len(stamped))
                    else:
                        out[doc_id] = SubmitOutcome(
                            stamped=stamped, consumed=int(rows.shape[0]))
            except BatchAbortedError as err:
                out[doc_id] = SubmitOutcome(
                    stamped=err.stamped, consumed=err.consumed,
                    error=err.cause)
            except (ConnectionError, OSError, KeyError) as err:
                # Fence fast-fail / unrecovered document: nothing of this
                # batch was consumed.
                out[doc_id] = SubmitOutcome(stamped=[], consumed=0,
                                            error=err)
    return out


def submit_batches(service, batches: Dict[str, List[RawOperation]]
                   ) -> Dict[str, "SubmitOutcome"]:
    """Boxed-only form of :func:`submit_mixed_batches` (``submit_many``)."""
    return submit_mixed_batches(service, batches, None, None)


def submit_column_batches(service, batch: ColumnBatch,
                          doc_rows: Dict[str, np.ndarray],
                          endpoint_of=None) -> Dict[str, "SubmitOutcome"]:
    """Columnar-only form of :func:`submit_mixed_batches`
    (``submit_columns``)."""
    return submit_mixed_batches(service, None, batch, doc_rows,
                                endpoint_of=endpoint_of)



#: bound for a recovery follower's wait on the leading replay (the same
#: crashed-leader discipline as CatchupResultCache.DEFAULT_JOIN_TIMEOUT:
#: a waiter must never hang forever on a leader that died mid-replay).
RECOVERY_JOIN_TIMEOUT = 60.0


class DocumentOrderer:
    """One document's service state: sequencer + scribe + durable log."""

    def __init__(
        self,
        doc_id: str,
        oplog: OpLog,
        storage: SummaryStorage,
        sequencer: Optional[Sequencer] = None,
        throttle=None,
    ) -> None:
        self.doc_id = doc_id
        self.oplog = oplog
        self.storage = storage
        self.sequencer = sequencer or Sequencer(throttle=throttle)
        #: fenced = this orderer's shard was marked dead and the document
        #: re-owned elsewhere.  The flag is checked by the durable-append
        #: subscriber below UNDER the fence lock, so ANY stamp attempt
        #: (submit, tick, scribe ack) aborts before the log — the
        #: log-append-before-broadcast invariant is what keeps sequencing
        #: from forking: a fenced orderer can advance its private counters
        #: but nothing it stamps becomes durable or visible.
        self._fence_lock = threading.Lock()
        self.fenced = False  # guarded-by: _fence_lock
        # Durable append rides first in the broadcast chain: by the time any
        # client sees a message it is already in the log (scriptorium-before-
        # broadcast, collapsing the reference's Kafka fan-out).
        self.sequencer.subscribe(self._durable_append)
        self.scribe = Scribe(doc_id, self.sequencer, storage)
        # Listener list is mutated by caller threads (server sessions
        # subscribe/unsubscribe) while fan-out iterates it; snapshot under
        # the lock, deliver outside it (the server's broadcaster is the
        # usual single listener — per-client fan-out happens there).
        self._signal_lock = threading.Lock()
        self._signal_listeners: List[SignalListener] = []  # guarded-by: _signal_lock
        #: the subscribers KNOWN passive for client OP columns (the
        #: durable gate handles columns in bulk; the scribe ignores OP) —
        #: precomputed once so the per-batch fast-path probe allocates
        #: no bound methods.
        self._op_passive_subscribers = (self._durable_append,
                                        self.scribe._on_message)

    def _durable_append(self, msg: SequencedMessage) -> None:
        # Check-and-append in ONE fence-lock critical section: a submit
        # that raced fence() either completes its append before the fence
        # is set (the failover replay then includes it) or observes the
        # fence and aborts — there is no window where a fenced orderer's
        # stamp lands in the log after the new owner started replaying.
        with self._fence_lock:
            if self.fenced:
                raise ShardFencedError(self.doc_id)
            self.oplog.append(self.doc_id, msg)

    def submit_batch(self, ops: List[RawOperation]
                     ) -> List[SequencedMessage]:
        """Batch stamping: the whole batch sequences through
        ``Sequencer.submit_many`` (one MSN recomputation); each message
        still rides the durable-append-first broadcast chain.  The
        one-flush-per-batch group commit lives one level up, in the
        services' ``submit_many`` (the flush is a property of the SHARED
        log, not of one document).  Raises :class:`BatchAbortedError` on
        a mid-batch failure."""
        return self.sequencer.submit_many(ops)

    def _append_columns(self, segment: ColumnSegment) -> None:
        # The columnar form of _durable_append: same one-critical-section
        # fence-check-and-append discipline, one bulk log call for the
        # whole stamped segment.
        with self._fence_lock:
            if self.fenced:
                raise ShardFencedError(self.doc_id)
            self.oplog.append_columns(self.doc_id, segment)

    def columnar_ready(self) -> bool:
        """True when client OP columns can stamp without materializing
        messages: the only subscribers are the durable gate and the
        scribe (a no-op for OP messages), and no throttle policy needs
        per-op consultation.  A live broadcast subscriber (a client
        session, the Broadcaster) makes the document materialize
        per-message — through the boxed path, which IS the
        materialization."""
        return (self.sequencer.throttle is None
                and not self.sequencer.has_subscribers_besides(
                    *self._op_passive_subscribers))

    def submit_columns(self, batch: ColumnBatch, rows: np.ndarray):
        """Columnar batch stamping for one document's row slice.

        Fast path: ``Sequencer.submit_columns`` (vectorized dedup/stamp,
        lazy segment, bulk durable append) — returns the
        :class:`OpColumnSegment`.  Documents with live broadcast
        subscribers, or slices the vectorized validator refuses, fall
        back to materialize + :meth:`submit_batch` — returning the boxed
        stamped list — so semantics (and bytes) never depend on which
        path ran."""
        if self.columnar_ready():
            segment = self.sequencer.submit_columns(
                batch, rows, self._append_columns)
            if segment is not None:
                return segment
        ops = [batch.materialize(int(i)) for i in rows.tolist()]
        return self.submit_batch(ops)

    def connect_columns(self, client_ids: List[str],
                        session: Optional[str] = None) -> None:
        """Columnar JOIN cohort (fresh clients): vectorized quorum insert
        + one lazy JOIN segment through the bulk durable gate; falls back
        to the boxed ``connect_many`` for resume/re-join semantics or
        documents with live broadcast subscribers."""
        if self.columnar_ready():
            if self.sequencer.connect_columns(client_ids, session,
                                              self._append_columns):
                return
        self.sequencer.connect_many(client_ids, session)

    def fence(self) -> None:
        """Mark this orderer dead (shard failover): every later stamp
        aborts before the durable log, so the re-owned orderer recovered
        from that log is the single continuation of the sequence.  Takes
        the fence lock — by the time this returns, any in-flight append
        has either landed (and is part of what the new owner replays) or
        will abort; the log is quiescent for this document."""
        with self._fence_lock:
            self.fenced = True

    # -- signals (unsequenced ephemeral broadcast — presence rides this) -------

    def submit_signal(self, client_id: str, content,
                      target_client_id: Optional[str] = None) -> None:
        with self._fence_lock:
            fenced = self.fenced
        if fenced:
            return  # signals are ephemeral: a dead shard's are dropped
        signal = {
            "clientId": client_id,
            "content": content,
            "targetClientId": target_client_id,
        }
        with self._signal_lock:
            listeners = list(self._signal_listeners)
        for fn in listeners:
            fn(signal)

    def subscribe_signals(self, fn: SignalListener) -> None:
        with self._signal_lock:
            self._signal_listeners.append(fn)

    def unsubscribe_signals(self, fn: SignalListener) -> None:
        with self._signal_lock:
            if fn in self._signal_listeners:
                self._signal_listeners.remove(fn)

    # -- checkpoint / crash-resume ---------------------------------------------

    def checkpoint(self) -> dict:
        return {
            "sequencer": self.sequencer.checkpoint(),
            "scribe": self.scribe.checkpoint(),
        }

    @staticmethod
    def restore(
        doc_id: str,
        oplog: OpLog,
        storage: SummaryStorage,
        checkpoint: dict,
    ) -> "DocumentOrderer":
        """Resume after a crash: the checkpoint may lag the durable log;
        the tail is replayed into sequencer + scribe state exactly-once.

        Clients that died with the process remain in the quorum (their
        dedup floors must survive for reconnect); the host is responsible
        for ``disconnect``-ing ones that never return, or the MSN stays
        pinned at their last ref_seq."""
        checkpoint_seq = checkpoint["sequencer"]["seq"]
        floor = oplog.floor(doc_id)
        if checkpoint_seq < floor:
            # The checkpoint predates a truncation cut: the log can no
            # longer back-fill it.  The truncation marker carries a
            # checkpoint taken at the cut — restore from that instead
            # (absent one, the ranged read below raises loudly rather
            # than silently resuming over a gap).
            trunc = oplog.truncation_checkpoint(doc_id)
            if trunc is not None:
                checkpoint = trunc
                checkpoint_seq = checkpoint["sequencer"]["seq"]
        from_seq = floor if floor <= checkpoint_seq else 0
        sequencer = Sequencer.restore(
            checkpoint["sequencer"],
            log=oplog.get(doc_id, from_seq=from_seq,
                          to_seq=checkpoint_seq),
        )
        orderer = DocumentOrderer(doc_id, oplog, storage, sequencer=sequencer)
        orderer.scribe.restore(checkpoint["scribe"])
        for msg in oplog.get(doc_id, from_seq=checkpoint_seq):
            sequencer.replay(msg)
            orderer.scribe.replay(msg)
        return orderer

    @staticmethod
    def recover(
        doc_id: str, oplog: OpLog, storage: SummaryStorage
    ) -> "DocumentOrderer":
        """No host checkpoint at all: rebuild everything from the durable
        log.  A TRUNCATED log cannot replay from seq 1 — its sealed
        prefix is gone — so recovery pivots to the checkpoint the
        truncation marker persisted at the cut (restore + tail replay),
        which carries the JOIN/LEAVE quorum and dedup floors the dropped
        records once established."""
        trunc = oplog.truncation_checkpoint(doc_id)
        if trunc is not None:
            return DocumentOrderer.restore(doc_id, oplog, storage, trunc)
        orderer = DocumentOrderer(doc_id, oplog, storage)
        for msg in oplog.get(doc_id):
            orderer.sequencer.replay(msg)
            orderer.scribe.replay(msg)
        return orderer


class DocumentEndpoint:
    """A per-document connection facade handed to clients/drivers.

    Satisfies the ``ContainerRuntime.connect`` contract — ``submit``,
    ``subscribe``, ``connect``, ``log`` — plus signals and ranged delta
    reads, so the same runtime code runs against the in-proc sequencer,
    this service, or a remote driver.
    """

    def __init__(self, orderer: DocumentOrderer) -> None:
        self._orderer = orderer

    @property
    def doc_id(self) -> str:
        return self._orderer.doc_id

    @property
    def log(self) -> List[SequencedMessage]:
        return self._orderer.oplog.get(self._orderer.doc_id)

    # The endpoint-level fence checks below are advisory fast-fails for
    # clean errors; they read the flag without the fence lock.  The
    # AUTHORITATIVE gate is DocumentOrderer._durable_append, which
    # re-checks under the lock — a submit that slips past an endpoint
    # check mid-kill still aborts before the durable log.

    @property
    def head_seq(self) -> int:
        if self._orderer.fenced:
            # A dead shard's counter is stale the moment the re-owned
            # orderer stamps: refuse rather than serve a head the durable
            # log has moved past.
            raise ShardFencedError(self.doc_id)
        return self._orderer.sequencer.seq

    def connect(self, client_id: str, session: Optional[str] = None) -> None:
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        self._orderer.sequencer.connect(client_id, session)

    def disconnect(self, client_id: str) -> None:
        if self._orderer.fenced:
            # Leaving a dead shard needs no LEAVE: the recovered owner's
            # quorum governs now, and a fenced orderer could not make the
            # LEAVE durable anyway.  No-op so reconnect teardown of the
            # stale connection never trips over the fence.
            return
        self._orderer.sequencer.disconnect(client_id)

    def submit(self, op: RawOperation) -> Optional[SequencedMessage]:
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        return self._orderer.sequencer.submit(op)

    def submit_batch(self, ops: List[RawOperation]
                     ) -> List[SequencedMessage]:
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        return self._orderer.submit_batch(ops)

    def connect_many(self, client_ids: List[str],
                     session: Optional[str] = None) -> None:
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        self._orderer.sequencer.connect_many(client_ids, session)

    def submit_columns(self, batch: ColumnBatch, rows: np.ndarray):
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        return self._orderer.submit_columns(batch, rows)

    def connect_columns(self, client_ids: List[str],
                        session: Optional[str] = None) -> None:
        if self._orderer.fenced:
            raise ShardFencedError(self.doc_id)
        self._orderer.connect_columns(client_ids, session)

    def subscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        self._orderer.sequencer.subscribe(fn)

    def unsubscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        self._orderer.sequencer.unsubscribe(fn)

    def update_ref_seq(self, client_id: str, ref_seq: int) -> None:
        if self._orderer.fenced:
            return  # heartbeat to a dead shard: the new owner tracks MSN
        self._orderer.sequencer.update_ref_seq(client_id, ref_seq)

    def deltas(self, from_seq: int = 0,
               to_seq: Optional[int] = None) -> List[SequencedMessage]:
        return self._orderer.oplog.get(self._orderer.doc_id, from_seq, to_seq)

    def submit_signal(self, client_id: str, content,
                      target_client_id: Optional[str] = None) -> None:
        self._orderer.submit_signal(client_id, content, target_client_id)

    def subscribe_signals(self, fn: SignalListener) -> None:
        self._orderer.subscribe_signals(fn)

    def unsubscribe_signals(self, fn: SignalListener) -> None:
        self._orderer.unsubscribe_signals(fn)


class _RecoveryFlight:
    """One in-flight log replay: the leader publishes the recovered
    orderer into ``_orderers``; waiters block on the event and re-claim
    (the single-flight begin/publish/abandon shape of catchup_cache)."""

    def __init__(self) -> None:
        self.done = threading.Event()


class LocalOrderingService:
    """Multi-document ordering service in one process — the Tinylicious
    capability point: create/load documents, connect clients, store
    summaries, serve catch-up deltas."""

    def __init__(
        self,
        oplog: Optional[OpLog] = None,
        storage: Optional[SummaryStorage] = None,
        throttle=None,
    ) -> None:
        self.oplog = oplog if oplog is not None else OpLog()
        self.storage = storage if storage is not None else SummaryStorage()
        #: optional per-submit throttle policy handed to every document's
        #: sequencer: callable(client_id) -> retry-after seconds | None.
        self.throttle = throttle
        #: summary-node digest -> {tenant ids allowed to read it}.  Lives on
        #: the SHARED service (not a front-door instance) so multi-instance
        #: deployments agree; content-addressed nodes can be owned by many
        #: tenants at once.  A production store would prune these with
        #: summary eviction; entries are per-node and tiny.
        self.handle_tenants: Dict[str, set] = {}  # guarded-by: state_lock
        self._orderers: Dict[str, DocumentOrderer] = {}  # guarded-by: state_lock
        #: doc_id -> in-flight recovery; a herd of connects to a document
        #: present only in the durable log costs ONE replay (the same
        #: single-flight discipline as the catch-up cache).
        self._recoveries: Dict[str, _RecoveryFlight] = {}  # guarded-by: state_lock
        #: shard-level fence (set by ShardedOrderingService.kill_shard via
        #: fence_all): once set, no NEW orderer can be created or
        #: published unfenced — closes the window where a single-flight
        #: recovery in flight at kill time would install a live orderer
        #: on a dead-routed shard after the per-orderer fence sweep ran.
        self._fenced = False  # guarded-by: state_lock
        #: guards handle_tenants and lazy orderer creation: the network
        #: front door offloads catchup/upload_summary to executor THREADS
        #: that mutate these maps concurrently with event-loop dispatches
        #: (ADVICE r3) — GIL atomicity alone is not a contract.
        self.state_lock = threading.RLock()
        #: optional ``fn(doc_id, head_seq)`` fired after every committed
        #: stamp/segment on any document (the streaming fold's dirty-doc
        #: feed).  Installed via :meth:`set_commit_hook`; rides the
        #: sequencer's WATCHER list, never its subscriber list, so it
        #: cannot knock documents off the columnar fast path.
        self.commit_hook = None  # guarded-by: state_lock (installation)

    def fence_all(self) -> List[str]:
        """Shard failover: refuse new orderers, then fence every live one.
        The flag flips under state_lock FIRST, so a racing recovery either
        published before this (its orderer is in the sweep snapshot) or
        publishes after (and is born fenced in _recover_publish) — there
        is no interleaving that leaves a live orderer on a dead shard.
        Returns the fenced doc ids."""
        with self.state_lock:
            self._fenced = True
            orderers = sorted(self._orderers.items())
        for _doc_id, orderer in orderers:
            orderer.fence()
        return [doc_id for doc_id, _ in orderers]

    def set_commit_hook(self, fn) -> None:
        """Install (or clear) the service-wide commit hook and wire it
        onto every LIVE orderer; later-created/recovered/adopted orderers
        are wired at install time.  One hook at a time — the streaming
        fold is the intended single consumer."""
        with self.state_lock:
            self.commit_hook = fn
            orderers = sorted(self._orderers.items())
        if fn is not None:
            for doc_id, orderer in orderers:
                self._wire_commit_hook(doc_id, orderer)

    def _wire_commit_hook(self, doc_id: str,
                          orderer: DocumentOrderer) -> None:
        # The watcher reads ``self.commit_hook`` at FIRE time (not wire
        # time) so clearing the hook actually detaches delivery, and it
        # is wired at most once per orderer so attach/detach/attach does
        # not fan a single commit out twice.
        with self.state_lock:
            armed = self.commit_hook is not None
        if not armed:
            return
        if getattr(orderer, "_commit_hook_wired", False):
            return
        orderer._commit_hook_wired = True
        orderer.sequencer.watch_commits(
            lambda head, _d=doc_id: self._fire_commit_hook(_d, head))

    def _fire_commit_hook(self, doc_id: str, head: int) -> None:
        with self.state_lock:  # snapshot only; fn runs lock-free
            fn = self.commit_hook
        if fn is not None:
            fn(doc_id, head)

    def create_document(self, doc_id: str) -> DocumentEndpoint:
        with self.state_lock:
            if self._fenced:
                raise ShardFencedError(doc_id)
            if doc_id in self._orderers:
                raise ValueError(f"document {doc_id!r} already exists")
            self._orderers[doc_id] = DocumentOrderer(
                doc_id, self.oplog, self.storage, throttle=self.throttle
            )
            self._wire_commit_hook(doc_id, self._orderers[doc_id])
            return DocumentEndpoint(self._orderers[doc_id])

    def has_document(self, doc_id: str) -> bool:
        with self.state_lock:  # executor threads mutate the map (ADVICE r4)
            known = doc_id in self._orderers
        return known or self.oplog.head(doc_id) > 0

    # -- single-flight recovery (begin/publish/abandon, catchup_cache shape) ---

    def _recover_begin(self, doc_id: str):
        """One atomic claim: ``("have", orderer)`` when live,
        ``("lead", flight)`` when this caller must replay the log, or
        ``("wait", flight)`` when another caller already is."""
        with self.state_lock:
            orderer = self._orderers.get(doc_id)
            if orderer is not None:
                return "have", orderer
            flight = self._recoveries.get(doc_id)
            if flight is not None:
                return "wait", flight
            flight = _RecoveryFlight()
            self._recoveries[doc_id] = flight
            return "lead", flight

    def _recover_publish(self, doc_id: str,
                         orderer: DocumentOrderer) -> DocumentOrderer:
        """Leader succeeded: install the orderer, wake every waiter.  The
        install re-validates via setdefault — if create_document landed in
        the replay window, its orderer wins and the replay is discarded.
        A shard fenced mid-replay installs the orderer FENCED: waiters get
        clean ShardFencedErrors and re-resolve through the router instead
        of sequencing on a dead shard."""
        with self.state_lock:
            fenced = self._fenced
            installed = self._orderers.setdefault(doc_id, orderer)
        if installed is orderer:
            self._wire_commit_hook(doc_id, installed)
        with self.state_lock:
            flight = self._recoveries.pop(doc_id, None)
        if fenced:
            installed.fence()
        if flight is not None:
            flight.done.set()
        return installed

    def _recover_abandon(self, doc_id: str) -> None:
        """Leader failed: wake waiters empty-handed (one re-claims and
        replays itself).  Safe on an already-published key."""
        with self.state_lock:
            flight = self._recoveries.pop(doc_id, None)
        if flight is not None:
            flight.done.set()

    def _recover_reap(self, doc_id: str, flight: _RecoveryFlight) -> None:
        """A waiter timed out: presume the leader crashed without reaching
        its finally-abandon and remove the flight — only if it is still
        the identical object this waiter waited on, so a fresh leader's
        flight is never popped (the identity-guard discipline of
        CatchupResultCache.join)."""
        with self.state_lock:
            if self._recoveries.get(doc_id) is flight:
                self._recoveries.pop(doc_id)
                flight.done.set()

    def endpoint(self, doc_id: str) -> DocumentEndpoint:
        """Connect-or-recover: an existing orderer is reused; a document
        present only in the durable log (service restart, shard failover)
        is recovered by replaying the log into a fresh orderer.  A herd of
        concurrent connects costs ONE replay: the first caller leads and
        replays outside the lock (seconds of work; state_lock stays a
        dict-operations-only lock), everyone else waits on the flight and
        re-claims once it resolves."""
        while True:
            state, val = self._recover_begin(doc_id)
            if state == "have":
                return DocumentEndpoint(val)
            if state == "lead":
                try:
                    if self.oplog.head(doc_id) == 0:
                        raise KeyError(f"document {doc_id!r} does not exist")
                    recovered = DocumentOrderer.recover(
                        doc_id, self.oplog, self.storage
                    )
                except BaseException:
                    self._recover_abandon(doc_id)
                    raise
                return DocumentEndpoint(
                    self._recover_publish(doc_id, recovered)
                )
            # wait: bounded — a leader that died without its
            # finally-abandon must not hang followers forever; on timeout
            # reap the dead flight (identity-guarded) and re-claim.
            if not val.done.wait(RECOVERY_JOIN_TIMEOUT):
                self._recover_reap(doc_id, val)

    def adopt_orderer(self, doc_id: str,
                      orderer: DocumentOrderer) -> DocumentOrderer:
        """Install an orderer built elsewhere (fluidproc migration: the
        target shard restores the source's frozen checkpoint so quorum
        state and dedup floors continue exactly).  Loses to an existing
        orderer (``setdefault`` — a concurrent lazy recovery's result is
        equivalent: both continue the same durable log); born fenced when
        the shard itself is."""
        with self.state_lock:
            fenced = self._fenced
            installed = self._orderers.setdefault(doc_id, orderer)
        if installed is orderer:
            self._wire_commit_hook(doc_id, installed)
        if fenced:
            installed.fence()
        return installed

    def drop_orderer(self, doc_id: str) -> None:
        """Forget a document's in-memory orderer (migration-abort thaw:
        a frozen/fenced orderer is discarded so the next ``endpoint()``
        lazily recovers a LIVE one from this shard's own durable log —
        quorum and dedup floors rebuild from the replay)."""
        with self.state_lock:
            self._orderers.pop(doc_id, None)

    def submit_many(self, batches: Dict[str, List[RawOperation]]
                    ) -> Dict[str, SubmitOutcome]:
        """Batched ingress — see :func:`submit_batches` (the swarm-scale
        submit surface: per-document batch stamping, one durable flush,
        per-document failure isolation)."""
        return submit_batches(self, batches)

    def submit_columns(self, batch: ColumnBatch,
                       doc_rows: Dict[str, np.ndarray]
                       ) -> Dict[str, SubmitOutcome]:
        """Columnar batched ingress — see :func:`submit_column_batches`."""
        return submit_column_batches(self, batch, doc_rows)

    def submit_mixed(self, batches: Optional[Dict[str, List[RawOperation]]],
                     batch: Optional[ColumnBatch],
                     doc_rows: Optional[Dict[str, np.ndarray]]
                     ) -> Dict[str, SubmitOutcome]:
        """Both ingress shapes in one sorted pass — see
        :func:`submit_mixed_batches`."""
        return submit_mixed_batches(self, batches, batch, doc_rows)

    def doc_ids(self) -> List[str]:
        with self.state_lock:
            known = set(self._orderers)
        return sorted(known | set(self.oplog.doc_ids()))

    def checkpoint(self) -> dict:
        with self.state_lock:
            snapshot = sorted(self._orderers.items())
        return {doc_id: orderer.checkpoint() for doc_id, orderer in snapshot}

    @staticmethod
    def restore(
        oplog: OpLog, storage: SummaryStorage, checkpoint: dict
    ) -> "LocalOrderingService":
        service = LocalOrderingService(oplog, storage)
        # Replay OUTSIDE the lock — state_lock is a dict-operations-only
        # lock (see endpoint()), and per-document restore is seconds of
        # work — then publish everything in one locked dict update.
        restored = {
            doc_id: DocumentOrderer.restore(
                doc_id, oplog, storage, doc_checkpoint
            )
            for doc_id, doc_checkpoint in checkpoint.items()
        }
        with service.state_lock:
            service._orderers.update(restored)
        return service
