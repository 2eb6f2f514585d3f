"""DeltaManager — the loader's op pipeline and connection state machine.

Capability-equivalent of the reference's ``DeltaManager`` +
``ConnectionManager`` + ``ConnectionStateHandler`` (SURVEY.md §2.1
container-loader):

- presents the ordering-service surface the container runtime expects
  (``submit`` / ``subscribe`` / ``connect`` / ``log``) while owning the
  *transport* concerns beneath it;
- delivers strictly **gap-free, in-order** messages: a live message that
  skips ahead parks in a buffer while the missing range is fetched from
  delta storage (the reference's fetchMissingDeltas path);
- tracks connection state (disconnected → connecting → catching_up →
  connected) and supports explicit disconnect/reconnect against the same
  or a new document service;
- read-only mode rejects local submits at the edge (the reference's
  forced-readonly capability).
"""

from __future__ import annotations

import enum
import itertools
import threading
from typing import Callable, List, Optional

import time

from ..protocol.messages import (NackError, RawOperation, SequencedMessage,
                                 ShardFencedError)

_session_counter = itertools.count(1)


class ConnectionState(enum.Enum):
    DISCONNECTED = "disconnected"
    CONNECTING = "connecting"
    CATCHING_UP = "catching_up"
    CONNECTED = "connected"
    CLOSED = "closed"


class DeltaManager:
    """Gap-free ordered delivery + connection lifecycle over a driver.

    ``clock`` is the manager's only time source (nack retryAfter holds are
    schedule decisions).  It defaults to the wall clock for live sessions;
    replay/test harnesses inject a virtual clock so a catch-up run is
    reproducible byte-for-byte regardless of when it executes.
    """

    def __init__(self, document_service,
                 clock: Optional[Callable[[], float]] = None,
                 resolver: Optional[Callable[[], object]] = None,
                 retry=None, rng=None,
                 sleep: Optional[Callable[[float], None]] = None) -> None:
        import random as _random

        from ..utils.telemetry import LockedCounterSet

        self._service = document_service
        self._clock = clock or time.time
        #: re-resolves a fresh document service through the factory — the
        #: fence recovery path: after a shard failover the router hands
        #: out the recovered owner, and THIS manager re-resolves and
        #: replays its held outbound ops itself (no host polling of
        #: fence_required required; the Loader always wires this).
        self._resolver = resolver
        #: RetryPolicy for outbound submits/connects: transient transport
        #: or durability failures resend the same op (the sequencer
        #: dedups by client_seq); nacks and fences keep their own paths.
        self._retry = retry
        self._rng = rng if rng is not None else _random.Random(0)
        # Backoff actuator: a VirtualClock injects its own sleep (virtual
        # time advances, nothing blocks), live sessions really sleep.
        self._sleep = sleep if sleep is not None \
            else getattr(clock, "sleep", None) or time.sleep
        #: retry.* counters — the chaos oracle's budget-respected surface
        self.retry_counters = LockedCounterSet()
        self.state = ConnectionState.DISCONNECTED
        self.client_id: Optional[str] = None
        self.read_only = False
        self.last_delivered_seq = 0
        self.gaps_repaired = 0
        self.nacks = 0
        # An op-level NACK with retryAfter holds outbound sends (can_send
        # False) until this wall-clock moment; optimistic local state stays
        # intact and everything rides out on the next writable flush.
        self.nacked_until = 0.0
        # A staleView nack means the queued wire bytes reference a view
        # below the collaboration window: resending identical bytes would
        # livelock.  The container's pump sees this flag and reconnects,
        # which discards the stale encodings and REBASES pending ops to a
        # fresh view (the existing reconnect machinery).
        self.rebase_required = False
        # The document's orderer shard was fenced (failover): retrying
        # the same connection can never succeed — the host must
        # re-resolve the document service (the router now hands out the
        # recovered owner) and reconnect with it.  Mirrors
        # rebase_required: a flag the pump reads, because the error
        # itself is a ConnectionError the wire-drain rightly swallows.
        self.fence_required = False
        self._subscribers: List[Callable[[SequencedMessage], None]] = []
        # Delivery is serialized: live messages arrive on the driver's
        # dispatcher thread while backfills (reconnect catch-up, the log
        # property) run on the app thread — an unserialized interleave
        # can park a message in _ahead that the other thread's watermark
        # already passed, wedging the state at CATCHING_UP forever.
        # Re-entrant: gap repair delivers from inside a locked delivery.
        self._delivery_lock = threading.RLock()
        self._ahead: dict = {}  # guarded-by: _delivery_lock
        self._live_fn = None
        # Connection epoch: reconnects from THIS manager resume the same
        # sequencer-side record (dedup floor preserved); a different
        # manager reusing the client id gets a fresh record.
        self._session = f"dm-{id(self)}-{next(_session_counter)}"

    # -- the service surface handed to ContainerRuntime ------------------------

    @property
    def log(self) -> List[SequencedMessage]:
        """Durable backfill feed — the tail this manager has not already
        delivered/accounted.  Reading it *consumes* the tail: its one
        consumer (``ContainerRuntime.connect``) enqueues everything
        returned, so delivery accounting advances here — otherwise the
        next live message would misread the backfilled span as a gap and
        re-fetch it all."""
        with self._delivery_lock:
            tail = self._service.delta_storage.get(
                from_seq=self.last_delivered_seq
            )
            if tail:
                self.last_delivered_seq = tail[-1].seq
            return tail

    def subscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        self._subscribers.append(fn)

    def connect(self, client_id: str) -> None:
        if self.state is ConnectionState.CLOSED:
            raise RuntimeError("delta manager is closed")
        self.state = ConnectionState.CONNECTING
        self.client_id = client_id

        def _attach():
            conn = self._service.connection()
            self._live_fn = self._on_live
            conn.subscribe(self._live_fn)
            try:
                conn.connect(client_id, self._session)
            except BaseException:
                # Retry hygiene: a failed attach must not leave the live
                # subscription behind, or each retry would stack another
                # delivery path onto the same manager.
                conn.unsubscribe(self._live_fn)
                self._live_fn = None
                raise
        if self._retry is not None:
            self._retry.run(
                _attach, operation="connect",
                sleep=self._sleep, rng=self._rng,
                no_retry=(NackError,),
                # A fence DURING connect is retryable exactly when we can
                # re-resolve the recovered owner through the router.
                on_fence=(self._re_resolve if self._resolver is not None
                          else None),
                counters=self.retry_counters,
            )
        else:
            _attach()
        self.state = ConnectionState.CONNECTED

    def _re_resolve(self) -> None:
        """Swap in a freshly-resolved document service (the router's
        current owner for this document) — the ShardFencedError recovery
        the retry policy invokes between attempts."""
        self._service = self._resolver()

    @property
    def can_send(self) -> bool:
        """False holds ops in the runtime outbox (optimistic local state
        stays intact, everything rides out on the next writable flush) —
        both offline and read-only work this way, because rejecting at
        submit time would fire *after* the DDS's optimistic apply and
        strand a diverged replica."""
        return (self.state is ConnectionState.CONNECTED
                and not self.read_only
                and self._clock() >= self.nacked_until)

    def submit(self, op: RawOperation):
        if self.read_only:
            raise PermissionError("container is in read-only mode")
        if self.state is not ConnectionState.CONNECTED:
            raise ConnectionError(f"not connected (state={self.state.value})")
        now = self._clock()
        if now < self.nacked_until:
            # Direct submitters honor the retryAfter hold too (the flush
            # path is already gated by can_send).
            raise NackError("held by retryAfter",
                            retry_after=self.nacked_until - now)
        try:
            if self._retry is not None:
                # Bounded inline retry for transient transport/durability
                # failures (an injected oplog-append fault, a lost RPC
                # send): the same bytes resend and the sequencer's
                # client_seq dedup absorbs any duplicate.  Exhaustion
                # surfaces RetryBudgetExhaustedError — a ConnectionError,
                # so the runtime keeps the op queued for a later flush.
                # Nacks and fences fall through to the handlers below.
                return self._retry.run(
                    lambda: self._service.connection().submit(op),
                    operation="submit",
                    sleep=self._sleep, rng=self._rng,
                    no_retry=(NackError, ShardFencedError),
                    counters=self.retry_counters,
                )
            return self._service.connection().submit(op)
        except ShardFencedError:
            # Dead shard: the op stays queued (ConnectionError contract),
            # but flag that only a reconnect against a re-resolved
            # service can drain it.
            self.fence_required = True
            raise
        except NackError as nack:
            # The service refused the op (throttle / stale view): hold
            # sends for retryAfter; the runtime keeps the encoded ops
            # queued (NackError IS a ConnectionError) and the next
            # writable flush resends them.
            self.nacks += 1
            self.nacked_until = max(
                self.nacked_until, self._clock() + nack.retry_after
            )
            if nack.code == "staleView":
                self.rebase_required = True
            raise

    # -- signals ---------------------------------------------------------------

    def submit_signal(self, content, target_client_id: Optional[str] = None):
        self._service.connection().submit_signal(
            self.client_id, content, target_client_id
        )

    def subscribe_signals(self, fn) -> None:
        self._service.connection().subscribe_signals(fn)

    # -- lifecycle -------------------------------------------------------------

    def disconnect(self) -> None:
        if self.state in (ConnectionState.DISCONNECTED, ConnectionState.CLOSED):
            return
        conn = self._service.connection()
        try:
            if self._live_fn is not None:
                conn.unsubscribe(self._live_fn)
            if self.client_id is not None:
                conn.disconnect(self.client_id)
        except (ConnectionError, OSError, TimeoutError):
            # Tearing down a DEAD transport must not block moving to a
            # live one (reconnect after an RPC disconnect / fence): the
            # server reaps the dead session's quorum membership itself
            # when the socket closes.
            pass
        finally:
            self._live_fn = None
        self.state = ConnectionState.DISCONNECTED

    def reconnect(self, client_id: Optional[str] = None,
                  document_service=None) -> None:
        """Drop the old connection (if any) and establish a fresh one,
        optionally against a new resolved service (new endpoint after a
        service restart).  After a fence, no explicit service is needed:
        the manager re-resolves through its factory resolver itself —
        the router hands out the recovered owner."""
        self.disconnect()
        if document_service is not None:
            self._service = document_service
        elif self.fence_required and self._resolver is not None:
            self._re_resolve()
        self.connect(client_id if client_id is not None else self.client_id)
        # Deterministic catch-up: pull the span missed while disconnected
        # from durable storage NOW, instead of waiting for the next live
        # message to trigger gap repair.  Over an async transport (TCP)
        # the live tail lags the connect response — and the container's
        # reconnect protocol needs acks for already-sequenced pending ops
        # to land BEFORE it resubmits the rest, or the resubmit would
        # double-apply them.  The delivery watermark dedups any overlap
        # with the (sync or async) live feed.
        with self._delivery_lock:
            for msg in self._service.delta_storage.get(
                    from_seq=self.last_delivered_seq):
                self._deliver(msg)
        # A successful (re)connect clears the fence flag: either the host
        # handed us the re-resolved service, or the old one still works.
        self.fence_required = False

    def close(self) -> None:
        self.disconnect()
        self.state = ConnectionState.CLOSED

    # -- ordered, gap-free delivery --------------------------------------------

    def note_delivered(self, seq: int) -> None:
        """The container loaded a summary / replayed storage up to ``seq``
        outside the live path; future live delivery resumes after it."""
        with self._delivery_lock:
            self.last_delivered_seq = max(self.last_delivered_seq, seq)

    def _on_live(self, msg: SequencedMessage) -> None:
        with self._delivery_lock:
            if msg.seq <= self.last_delivered_seq:
                return  # duplicate of something storage already served
            if msg.seq > self.last_delivered_seq + 1:
                # A gap: park this message, repair from durable storage.
                self._ahead[msg.seq] = msg
                self.state = ConnectionState.CATCHING_UP
                missing = self._service.delta_storage.get(
                    from_seq=self.last_delivered_seq, to_seq=msg.seq - 1
                )
                self.gaps_repaired += 1
                for m in missing:
                    self._deliver(m)
            else:
                self._deliver(msg)
            # Drain parked messages that are now contiguous — and purge
            # stale parks a backfill already covered (a park below the
            # watermark would otherwise pin the state at CATCHING_UP
            # with no later message ever draining it).
            while self._ahead:
                nxt = min(self._ahead)
                if nxt <= self.last_delivered_seq:
                    self._ahead.pop(nxt)
                elif nxt == self.last_delivered_seq + 1:
                    self._deliver(self._ahead.pop(nxt))
                else:
                    break
            if self.state is ConnectionState.CATCHING_UP \
                    and not self._ahead:
                self.state = ConnectionState.CONNECTED

    def _deliver(self, msg: SequencedMessage) -> None:
        with self._delivery_lock:
            if msg.seq <= self.last_delivered_seq:
                return
            self.last_delivered_seq = msg.seq
            subscribers = list(self._subscribers)
        # Deliver outside any state mutation but still inside the outer
        # serialization (the lock is re-entrant): subscribers only append
        # to the runtime's inbound queue by contract.
        for fn in subscribers:
            fn(msg)
