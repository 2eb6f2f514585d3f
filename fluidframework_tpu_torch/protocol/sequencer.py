"""In-process total-order sequencer.

Capability-equivalent of the reference's Deli ``ticket()`` sequencing lambda
wired in-process the way ``memory-orderer``'s ``LocalOrderer`` does
(SURVEY.md §2.3; upstream paths UNVERIFIED — empty reference mount): one class,
no Kafka.  Responsibilities:

- stamp each raw op with a monotonically increasing ``seq``;
- track each connected client's ``ref_seq`` and compute the
  ``minimumSequenceNumber`` (MSN) — min over connected clients' ref_seq;
- dedupe resubmitted ops by (client_id, client_seq);
- broadcast sequenced messages to subscribers in order and append them to the
  durable op log (the scriptorium-equivalent feed that catch-up replay and the
  TPU batch-replay path consume).

Quorum state is COLUMNAR: per-client ``ref_seq`` and dedup
floors live in slot-indexed numpy arrays behind a ``client_id → slot``
dict, so the MSN recompute is a vectorized ``min`` over one array
instead of a Python scan of N connection objects — the scan that made
10⁶-client quorums unaffordable — and the batched columnar ingress
(:meth:`Sequencer.submit_columns`) can gather/scatter floors for a whole
batch in a handful of numpy calls.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .messages import (
    INITIAL_SEQ,
    BatchAbortedError,
    ColumnAppendError,
    MessageType,
    NackError,
    RawOperation,
    SequencedMessage,
)
from .wire import ColumnBatch, JoinColumnSegment, OpColumnSegment

#: ref_seq sentinel for a freed slot: never the min of a live quorum.
_DEAD_REF = np.iinfo(np.int64).max


class ClientConnection:
    """Read view of one connected client's quorum state.

    The authoritative state is the sequencer's columnar arrays; this
    object is the stable façade ``connect()`` hands back (and the shape
    the pre-columnar dataclass exposed): ``client_id``, ``ref_seq``,
    ``last_client_seq`` (dedup floor), ``session``.
    """

    __slots__ = ("_sequencer", "client_id")

    def __init__(self, sequencer: "Sequencer", client_id: str) -> None:
        self._sequencer = sequencer
        self.client_id = client_id

    def _slot(self) -> int:
        slot = self._sequencer._slots.get(self.client_id)
        if slot is None:
            raise KeyError(f"client {self.client_id!r} is not connected")
        return slot

    @property
    def ref_seq(self) -> int:
        return int(self._sequencer._ref[self._slot()])

    @property
    def last_client_seq(self) -> int:
        return int(self._sequencer._floor[self._slot()])

    @property
    def session(self) -> Optional[str]:
        return self._sequencer._session[self._slot()]

    def __repr__(self) -> str:  # debugging aid
        return (f"ClientConnection(client_id={self.client_id!r}, "
                f"ref_seq={self.ref_seq}, "
                f"last_client_seq={self.last_client_seq}, "
                f"session={self.session!r})")


class Sequencer:
    """Single-document total-order sequencer with MSN tracking.

    Deterministic: sequencing depends only on the submission order, so tests
    and the fuzz harness can drive interleavings explicitly.
    """

    def __init__(self, start_seq: int = INITIAL_SEQ,
                 throttle=None) -> None:
        self._seq = start_seq  # durable-shadow: stamp counter
        self._min_seq = start_seq  # durable-shadow: collaboration-window floor
        #: optional policy: callable(client_id) -> retry-after seconds when
        #: this submit should be NACKed (throttling), else None.
        self.throttle = throttle
        self.nacks_issued = 0
        # -- columnar quorum state (client_id -> slot into the arrays) --
        self._slots: Dict[str, int] = {}  # durable-shadow: quorum membership
        self._ref = np.empty(0, dtype=np.int64)  # durable-shadow: ref seqs
        self._floor = np.empty(0, dtype=np.int64)  # durable-shadow: dedup floors
        self._session: List[Optional[str]] = []  # durable-shadow: session tokens
        self._free: List[int] = []
        self._subscribers: List[Callable[[SequencedMessage], None]] = []
        #: commit WATCHERS (the streaming fold's cadence feed):
        #: fired with the new head seq after a stamp (or columnar
        #: segment) has fully committed — durable gate accepted, every
        #: subscriber delivered.  Deliberately NOT subscribers: they
        #: never see messages (nothing to box) and are invisible to
        #: ``has_subscribers_besides``, so watching a document does not
        #: knock its client OP columns off the columnar fast path.
        self._watchers: List[Callable[[int], None]] = []
        self._log: List[SequencedMessage] = []  # durable-shadow: stamped log
        self._clock = 0  # durable-shadow: logical timestamp
        # Delivery queue: stamping is allowed *during* a broadcast (e.g. the
        # scribe acks a summary from inside its subscription callback), but
        # delivery must stay in total order — re-entrant stamps are queued
        # and drained by the outermost broadcast.
        self._delivery: List[SequencedMessage] = []
        self._delivering = False
        #: set by _stamp's exception path: True iff the exception unwound
        #: the CALLER's message (it never became durable or visible).
        #: Callers restore their own optimistic state (dedup floor,
        #: quorum membership) ONLY in that case — a failure in a LATER
        #: subscriber leaves the message durably sequenced, and rolling
        #: the floor back then would let a retry double-sequence it.
        self._last_stamp_unwound = False

    # -- quorum slot management ------------------------------------------------

    def _alloc(self, client_id: str, session: Optional[str],
               ref_seq: int, floor: int = 0) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            slot = len(self._session)
            if slot >= self._ref.shape[0]:
                grow = max(16, self._ref.shape[0])
                self._ref = np.concatenate(
                    [self._ref, np.full(grow, _DEAD_REF, np.int64)])
                self._floor = np.concatenate(
                    [self._floor, np.zeros(grow, np.int64)])
            self._session.append(None)
        self._slots[client_id] = slot
        self._ref[slot] = ref_seq
        self._floor[slot] = floor
        self._session[slot] = session
        return slot

    def _drop(self, client_id: str) -> None:
        slot = self._slots.pop(client_id)
        self._ref[slot] = _DEAD_REF
        self._floor[slot] = 0
        self._session[slot] = None
        self._free.append(slot)

    # -- connection management -------------------------------------------------

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def min_seq(self) -> int:
        return self._min_seq

    @property
    def log(self) -> List[SequencedMessage]:
        """The durable op log (scriptorium feed).

        Columnar stamps (:meth:`submit_columns` / :meth:`connect_columns`)
        do NOT ride this list — their feed is the service-side
        :class:`~fluidframework_tpu.service.oplog.OpLog` the durable gate
        appends to (the in-proc drivers that read this list never drive
        the columnar path)."""
        return self._log

    def connect(self, client_id: str,
                session: Optional[str] = None) -> ClientConnection:
        """Join a client to the quorum; emits a JOIN message.

        ``session`` disambiguates reuse of a client id.  A reconnect that
        presents the *same* session token resumes the existing record —
        no duplicate JOIN, dedup floor preserved (crash-resume of a
        surviving runtime whose client_seq counter continues).  A different
        (or absent) session is a *fresh* runtime whose counter restarts:
        the stale record is dropped (LEAVE+JOIN) so its dedup floor cannot
        silently swallow the new session's ops."""
        slot = self._slots.get(client_id)
        if slot is not None:
            if session is not None and self._session[slot] == session:
                return ClientConnection(self, client_id)
            self.disconnect(client_id)
        self._alloc(client_id, session, self._seq)
        try:
            self._stamp(
                client_id=None,
                client_seq=-1,
                ref_seq=self._seq,
                type_=MessageType.JOIN,
                contents={"clientId": client_id},
            )  # unwinds: _slots
        except BaseException:
            # A JOIN whose durable append failed (unwound) must not
            # leave the client in the quorum: the retry's connect would
            # resume the record and never stamp the JOIN at all.  A JOIN
            # that landed durably (a later subscriber raised) keeps the
            # membership — it matches the log.
            if self._last_stamp_unwound and client_id in self._slots:
                self._drop(client_id)
            raise
        return ClientConnection(self, client_id)

    def connect_many(self, client_ids: List[str],
                     session: Optional[str] = None) -> None:
        """Batch JOIN: admit ``client_ids`` in order with one MSN
        recomputation at the end instead of one per JOIN (the vectorized
        array ``min`` of ``_recompute_min_seq`` — connecting N clients
        one at a time used to be O(N²) in the per-stamp min-scan).  Each
        JOIN message carries the batch-start MSN (conservative, same
        argument as :meth:`submit_many`).  Semantics are otherwise
        exactly N :meth:`connect` calls: same-session reconnects resume,
        stale records are dropped via LEAVE+JOIN.  The fully-columnar
        fresh-cohort form is :meth:`connect_columns`."""
        try:
            for client_id in client_ids:
                slot = self._slots.get(client_id)
                if slot is not None:
                    if session is not None \
                            and self._session[slot] == session:
                        continue
                    self.disconnect(client_id)
                self._alloc(client_id, session, self._seq)
                try:
                    self._stamp(
                        client_id=None,
                        client_seq=-1,
                        ref_seq=self._seq,
                        type_=MessageType.JOIN,
                        contents={"clientId": client_id},
                        recompute_msn=False,
                    )  # unwinds: _slots
                except BaseException:
                    # Same unwind discipline as connect(): an un-stamped
                    # JOIN must not leave the client in the quorum.
                    if self._last_stamp_unwound \
                            and client_id in self._slots:
                        self._drop(client_id)
                    raise
        finally:
            self._recompute_min_seq()

    def connect_columns(self, client_ids: List[str],
                        session: Optional[str],
                        gate: Callable[[JoinColumnSegment], None]) -> bool:
        """Fully-columnar JOIN cohort: admit a FRESH batch of clients with
        one vectorized quorum insert, one lazy
        :class:`JoinColumnSegment` stamp, and one durable-gate call —
        no per-client :class:`SequencedMessage` objects.

        Returns False (taking no action) when any id is already known:
        resume/LEAVE+JOIN semantics stay with the boxed
        :meth:`connect_many`, which the caller then uses.  ``gate`` must
        make the segment durable; a :class:`ColumnAppendError` unwinds
        the un-landed suffix (those clients leave the quorum, the seq
        counter rolls back) and re-raises the underlying cause — the
        exact per-JOIN unwind discipline of the boxed path.
        """
        n = len(client_ids)
        if any(cid in self._slots for cid in client_ids) \
                or len(set(client_ids)) != n:
            # Known ids (resume/LEAVE+JOIN) and duplicate ids within the
            # cohort both need the boxed per-id path — the bulk insert
            # would leak a quorum slot for the shadowed duplicate and
            # that slot's frozen ref would pin the MSN forever.
            return False
        if n == 0:
            return True
        start_ref = self._seq
        if not self._free:
            # Bulk quorum insert: grow the arrays once, vectorize the
            # per-client ref init, and extend the slot map in one update.
            base = len(self._session)
            need = base + n
            if need > self._ref.shape[0]:
                grow = max(need - self._ref.shape[0], self._ref.shape[0],
                           16)
                self._ref = np.concatenate(
                    [self._ref, np.full(grow, _DEAD_REF, np.int64)])
                self._floor = np.concatenate(
                    [self._floor, np.zeros(grow, np.int64)])
            self._ref[base:need] = start_ref + np.arange(n, dtype=np.int64)
            self._floor[base:need] = 0
            self._session.extend([session] * n)
            self._slots.update(zip(client_ids, range(base, need)))
        else:
            for i, cid in enumerate(client_ids):
                self._alloc(cid, session, start_ref + i)
        start = self._seq + 1
        clock0 = self._clock
        self._seq += n
        self._clock += n
        segment = JoinColumnSegment(tuple(client_ids), start,
                                    self._min_seq, clock0)
        try:
            gate(segment)  # commit-point: columnar JOIN cohort; unwinds: _seq, _clock, _ref, _floor, _slots, _session
        except ColumnAppendError as err:
            landed = err.landed
            self._seq = start - 1 + landed
            self._clock = clock0 + landed
            for cid in client_ids[landed:]:
                self._drop(cid)
            self._recompute_min_seq()
            raise err.cause from err
        except BaseException:
            # Gate refused before any row landed (e.g. fenced): unwind
            # the whole cohort.
            self._seq = start - 1
            self._clock = clock0
            for cid in client_ids:
                self._drop(cid)
            self._recompute_min_seq()
            raise
        self._recompute_min_seq()
        if self._watchers:
            self._notify_commit()
        return True

    def disconnect(self, client_id: str) -> None:
        """Remove a client from the quorum; emits LEAVE and recomputes MSN."""
        slot = self._slots.get(client_id)
        if slot is None:
            return
        prev_ref = int(self._ref[slot])
        prev_floor = int(self._floor[slot])
        prev_session = self._session[slot]
        self._drop(client_id)
        try:
            self._stamp(
                client_id=None,
                client_seq=-1,
                ref_seq=self._seq,
                type_=MessageType.LEAVE,
                contents={"clientId": client_id},
            )  # unwinds: _slots
        except BaseException:
            # Same unwind discipline as connect: an un-stamped LEAVE must
            # leave the quorum membership (and its MSN contribution)
            # exactly as it was, so the retry re-stamps cleanly; a LEAVE
            # that landed durably keeps the member removed.
            if self._last_stamp_unwound:
                self._alloc(client_id, prev_session, prev_ref, prev_floor)
            raise

    # -- sequencing ------------------------------------------------------------

    def submit(self, op: RawOperation) -> Optional[SequencedMessage]:
        """Sequence one raw op (the Deli ``ticket()`` hot loop).

        Returns the sequenced message, or None if the op was a duplicate
        (already-sequenced client_seq, e.g. a redundant resubmit after
        reconnect).
        """
        return self._submit_one(op, recompute_msn=True)

    def submit_many(self, ops: List[RawOperation]
                    ) -> List[SequencedMessage]:
        """Batch ticket(): sequence ``ops`` in order with ONE MSN
        recomputation for the whole batch instead of one per op — the
        per-op O(connected clients) min-scan is what caps single-op
        ingress at swarm populations.

        Each message is stamped with the MSN as of the batch START (the
        monotone floor is conservative: it may lag by one batch, which
        only delays zamboni collection — it can never exceed a live
        client's view).  Validation (connection, dedup, throttle, stale
        view) is per op and identical to :meth:`submit`; duplicates are
        skipped, not returned.  A failure mid-batch recomputes the MSN
        over what landed and raises :class:`BatchAbortedError` carrying
        the stamped prefix — the caller resubmits the whole batch after
        recovery and dedup absorbs the prefix.
        """
        stamped: List[SequencedMessage] = []
        consumed = 0
        try:
            for op in ops:
                msg = self._submit_one(op, recompute_msn=False)
                if msg is not None:
                    stamped.append(msg)
                consumed += 1
        except BaseException as err:
            self._recompute_min_seq()
            if not isinstance(err, Exception):
                # KeyboardInterrupt/SystemExit must never be converted
                # into a per-document outcome a retry loop would swallow.
                raise
            raise BatchAbortedError(consumed, stamped, err) from err
        self._recompute_min_seq()
        return stamped

    def submit_columns(self, batch: ColumnBatch, rows: np.ndarray,
                       gate: Callable[[OpColumnSegment], None]
                       ) -> Optional[OpColumnSegment]:
        """Vectorized batch ticket() over a :class:`ColumnBatch` slice —
        :meth:`submit_many`'s contract without per-op Python objects.

        ``rows`` selects this document's batch rows in submission order.
        Stamping is columnar end to end: dedup floors gather/compare/
        scatter through the quorum arrays (numpy compare-and-max), seq
        numbers are an ``arange`` over the kept rows, every message
        carries the batch-start MSN, and the MSN recomputes ONCE at the
        end.  The stamped rows become one lazy
        :class:`OpColumnSegment`; ``gate`` (the durable-append-first
        subscriber's columnar form) must make it durable before this
        method returns — messages are never visible anywhere before the
        gate accepts them.

        Returns None — taking NO action — when the slice needs boxed
        semantics the caller must provide via materialize+
        :meth:`submit_many`: a throttle policy is installed, a client is
        unknown, a client appears twice in the slice, client_seqs are
        not fresh-monotone, or a ref_seq sits below the collaboration
        window (NackError shapes).  A :class:`ColumnAppendError` from
        the gate unwinds the un-landed suffix (seq/clock/floors/
        ref_seqs) and raises :class:`BatchAbortedError` with the landed
        prefix — byte-for-byte the boxed abort-and-resubmit contract.
        """
        n = int(rows.shape[0])
        if n == 0:
            return OpColumnSegment(batch, rows.astype(np.int64),
                                   self._seq + 1, self._min_seq,
                                   self._clock)
        if self.throttle is not None:
            return None
        ids = batch.client_ids
        try:
            # C-level map chain: table index -> client id -> slot; an
            # unknown client raises out to the boxed path (which owes
            # the caller its ValueError shape).
            slot_list = list(map(self._slots.__getitem__,
                                 map(ids.__getitem__,
                                     batch.client_index[rows].tolist())))
        except KeyError:
            return None  # unknown client: boxed path raises its ValueError
        if n > 1 and len(set(slot_list)) != n:
            return None  # same client twice: running-floor dedup is boxed
        slots = np.array(slot_list, np.int64)
        cs = batch.client_seq[rows].astype(np.int64, copy=False)
        rs = batch.ref_seq[rows].astype(np.int64, copy=False)
        # Conservative stale-view probe over ALL rows (a dup row with a
        # stale view forces the boxed path, which silently dedups it —
        # correct either way, never a missed nack).
        if int(rs.min()) < self._min_seq:
            return None  # stale view: boxed path owes a staleView nack
        floors = self._floor[slots]
        keep = cs > floors
        if bool(keep.all()):
            # Steady-state fast path: nothing to dedup — skip the
            # boolean gathers entirely.
            kept_rows = rows.astype(np.int64, copy=False)
            kept_slots = slots
            prev_floors = floors
        else:
            kept_rows = rows[keep].astype(np.int64, copy=False)
            kept_slots = slots[keep]
            prev_floors = floors[keep]
            cs = cs[keep]
            rs = rs[keep]
        m = int(kept_rows.shape[0])
        prev_refs = self._ref[kept_slots].copy()
        self._floor[kept_slots] = cs
        self._ref[kept_slots] = np.maximum(prev_refs, rs)
        start = self._seq + 1
        clock0 = self._clock
        self._seq += m
        self._clock += m
        segment = OpColumnSegment(batch, kept_rows, start,
                                  self._min_seq, clock0)
        try:
            gate(segment)  # commit-point: columnar OP segment; unwinds: _seq, _clock, _floor, _ref
        except ColumnAppendError as err:
            landed = err.landed
            self._seq = start - 1 + landed
            self._clock = clock0 + landed
            self._floor[kept_slots[landed:]] = prev_floors[landed:]
            self._ref[kept_slots[landed:]] = prev_refs[landed:]
            self._recompute_min_seq()
            kept_positions = np.flatnonzero(keep)
            consumed = (int(kept_positions[landed])
                        if landed < kept_positions.shape[0] else n)
            stamped = [segment.materialize(j) for j in range(landed)]
            cause = err.cause
            if not isinstance(cause, Exception):
                raise cause
            raise BatchAbortedError(consumed, stamped, cause) from cause
        except BaseException as err:
            # Gate refused before any row landed (e.g. fenced mid-kill):
            # unwind the whole stamp, report zero consumed.
            self._seq = start - 1
            self._clock = clock0
            self._floor[kept_slots] = prev_floors
            self._ref[kept_slots] = prev_refs
            self._recompute_min_seq()
            if not isinstance(err, Exception):
                raise
            raise BatchAbortedError(0, [], err) from err
        self._recompute_min_seq()
        if self._watchers:
            self._notify_commit()
        return segment

    def _submit_one(self, op: RawOperation,
                    recompute_msn: bool) -> Optional[SequencedMessage]:
        slot = self._slots.get(op.client_id)
        if slot is None:
            raise ValueError(f"client {op.client_id!r} is not connected")
        if op.client_seq <= int(self._floor[slot]):
            return None  # duplicate — dedup by clientSeq
        if self.throttle is not None:
            retry_after = self.throttle(op.client_id)
            if retry_after is not None:
                self.nacks_issued += 1
                raise NackError("throttled", retry_after=float(retry_after))
        if op.ref_seq < self.min_seq:
            # A view below the collaboration window cannot be resolved
            # (zamboni collected what it referenced): the client must
            # rebase and resubmit against a fresh view (reconnect path).
            self.nacks_issued += 1
            raise NackError(
                f"refSeq {op.ref_seq} below the collaboration window "
                f"(minSeq {self.min_seq})", retry_after=0.0,
                code="staleView",
            )
        prev_client_seq = int(self._floor[slot])
        prev_ref_seq = int(self._ref[slot])
        self._floor[slot] = op.client_seq
        self._ref[slot] = max(prev_ref_seq, op.ref_seq)
        try:
            return self._stamp(
                client_id=op.client_id,
                client_seq=op.client_seq,
                ref_seq=op.ref_seq,
                type_=op.type,
                contents=op.contents,
                recompute_msn=recompute_msn,
            )  # unwinds: _floor, _ref
        except BaseException:
            # A failed stamp that UNWOUND (durable append refused the
            # message — see _stamp's rollback) must also restore the
            # dedup floor, or the caller's RETRY of the same client_seq
            # would be treated as a duplicate and silently dropped.  A
            # failure that did NOT unwind (a later subscriber raised
            # after the append landed) keeps the floor: the op is
            # durable, and the resend must dedup, not double-sequence.
            if self._last_stamp_unwound:
                self._floor[slot] = prev_client_seq
                self._ref[slot] = prev_ref_seq
            raise

    def update_ref_seq(self, client_id: str, ref_seq: int) -> None:
        """Heartbeat path: a client reports processed-up-to without an op."""
        slot = self._slots.get(client_id)
        if slot is None:
            return
        self._ref[slot] = max(int(self._ref[slot]), ref_seq)
        self._recompute_min_seq()

    def tick(self) -> SequencedMessage:
        """Emit a NO_OP heartbeat: advances seq and propagates the current MSN
        to clients without carrying an operation."""
        return self._stamp(
            client_id=None,
            client_seq=-1,
            ref_seq=self._seq,
            type_=MessageType.NO_OP,
            contents=None,
        )

    def subscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        """Register a delivery callback; called in total order for every
        sequenced message (the Alfred broadcast capability)."""
        self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        if fn in self._subscribers:
            self._subscribers.remove(fn)

    def watch_commits(self, fn: Callable[[int], None]) -> None:
        """Register a commit watcher: ``fn(head_seq)`` after each stamp
        or columnar segment fully commits.  Watchers are not
        subscribers — they see no messages, cannot veto, and do not
        affect :meth:`has_subscribers_besides` (the columnar fast path
        stays on).  A watcher that raises propagates to the submitter
        AFTER the commit (the message is already durable and
        broadcast); keep watchers non-throwing."""
        self._watchers.append(fn)

    def unwatch_commits(self, fn: Callable[[int], None]) -> None:
        if fn in self._watchers:
            self._watchers.remove(fn)

    def _notify_commit(self) -> None:
        for fn in list(self._watchers):
            fn(self._seq)

    def is_connected(self, client_id: str) -> bool:
        """Quorum membership probe (reap/monitoring surfaces)."""
        return client_id in self._slots

    def has_subscribers_besides(self, *known) -> bool:
        """True when anything OTHER than the given callbacks subscribes —
        the columnar fast path's "does this document have live broadcast
        consumers" probe (the durable gate and the scribe are known
        passives for client OP columns)."""
        return any(fn not in known for fn in self._subscribers)

    def server_message(self, type_: MessageType, contents) -> SequencedMessage:
        """Stamp a server-originated message (scribe summaryAck/Nack — the
        reference's service-generated ops carry clientId null)."""
        return self._stamp(
            client_id=None,
            client_seq=-1,
            ref_seq=self._seq,
            type_=type_,
            contents=contents,
        )

    def replay(self, msg: SequencedMessage) -> None:
        """Advance sequencing state from an already-durable message without
        re-stamping or re-broadcasting — crash-resume when the log is ahead
        of the checkpoint (Deli resuming from its Kafka offset).  The
        message is appended to the in-memory log so late joiners backfill
        the full history."""
        if msg.seq <= self._seq:
            return  # already reflected in the checkpoint
        self._log.append(msg)
        self._seq = msg.seq
        self._min_seq = max(self._min_seq, msg.min_seq)
        self._clock = max(self._clock, int(msg.timestamp) + 1)
        if msg.type is MessageType.JOIN:
            cid = msg.contents["clientId"]
            if cid not in self._slots:
                self._alloc(cid, None, msg.ref_seq)
        elif msg.type is MessageType.LEAVE:
            cid = msg.contents["clientId"]
            if cid in self._slots:
                self._drop(cid)
        elif msg.client_id is not None:
            slot = self._slots.get(msg.client_id)
            if slot is not None:
                self._floor[slot] = max(int(self._floor[slot]),
                                        msg.client_seq)
                self._ref[slot] = max(int(self._ref[slot]), msg.ref_seq)

    # -- checkpointing (Deli CheckpointManager capability) ---------------------

    def checkpoint(self) -> dict:
        """Serializable sequencing state: enough to resume stamping
        exactly-once after a crash (the durable log holds the messages;
        this holds the counters and per-client dedup floors)."""
        return {
            "seq": self._seq,
            "minSeq": self._min_seq,
            "clock": self._clock,
            "clients": {
                cid: {"refSeq": int(self._ref[slot]),
                      "lastClientSeq": int(self._floor[slot]),
                      "session": self._session[slot]}
                for cid, slot in sorted(self._slots.items())
            },
        }

    @staticmethod
    def restore(
        state: dict, log: Optional[List[SequencedMessage]] = None
    ) -> "Sequencer":
        """Rebuild from a checkpoint; pass the durable messages at or below
        the checkpoint as ``log`` so the in-memory catch-up feed stays
        complete (``replay`` appends everything after it)."""
        seq = Sequencer(start_seq=state["seq"])
        seq._min_seq = state["minSeq"]
        seq._clock = state["clock"]
        seq._log = list(log) if log is not None else []
        for cid, c in sorted(state["clients"].items()):
            seq._alloc(cid, c.get("session"), c["refSeq"],
                       c["lastClientSeq"])
        return seq

    # -- internals -------------------------------------------------------------

    def _recompute_min_seq(self) -> None:
        if self._slots:
            # Vectorized over the slot arrays; freed slots hold a
            # max-int sentinel so they never win the min.
            msn = int(self._ref[:len(self._session)].min())
        else:
            msn = self._seq
        # MSN is monotone.
        self._min_seq = max(self._min_seq, msn)

    def _stamp(
        self,
        client_id: Optional[str],
        client_seq: int,
        ref_seq: int,
        type_: MessageType,
        contents,
        recompute_msn: bool = True,
    ) -> SequencedMessage:
        """``recompute_msn=False`` is the batch path (submit_many /
        connect_many): the message carries the current monotone MSN and
        the caller recomputes once per batch — a conservative floor, not
        a stale one."""
        self._last_stamp_unwound = False
        prev_min_seq = self._min_seq
        self._seq += 1
        if recompute_msn:
            self._recompute_min_seq()
        msg = SequencedMessage(
            seq=self._seq,
            client_id=client_id,
            client_seq=client_seq,
            ref_seq=ref_seq,
            min_seq=self._min_seq,
            type=type_,
            contents=contents,
            timestamp=float(self._clock),
        )
        self._clock += 1
        self._log.append(msg)
        self._delivery.append(msg)
        if not self._delivering:
            self._delivering = True
            try:
                while self._delivery:
                    queued = self._delivery.pop(0)
                    delivered_to = 0
                    try:
                        for fn in list(self._subscribers):
                            fn(queued)  # commit-point: durable gate rides first; unwinds: _seq, _clock, _log
                            delivered_to += 1
                    except BaseException:
                        # The FIRST subscriber is the durability gate
                        # (DocumentOrderer's log append rides there): if
                        # it refused the NEWEST stamp and nobody else saw
                        # the message, un-stamp it completely — seq,
                        # clock, MSN, and the in-memory log roll back so
                        # the caller's retry re-sequences at the SAME
                        # number instead of leaving a durable-log hole
                        # no catch-up could ever repair.  (MSN restore is
                        # only exact for the outermost stamp; a rolled-
                        # back re-entrant stamp keeps the monotone MSN it
                        # observed.)  A failure after any delivery, or of
                        # a message with later stamps behind it, cannot
                        # be unwound and propagates as-is — and then the
                        # caller's message IS durable, so the unwound
                        # flag stays False and the caller must NOT
                        # restore its dedup floor (a restored floor would
                        # re-sequence the retry as a second op).
                        rolled_back = (delivered_to == 0
                                       and not self._delivery
                                       and self._log
                                       and self._log[-1] is queued)
                        if rolled_back:
                            self._log.pop()
                            self._seq -= 1
                            self._clock -= 1
                            if queued is msg:
                                self._min_seq = prev_min_seq
                        self._last_stamp_unwound = (rolled_back
                                                    and queued is msg)
                        raise
            finally:
                self._delivering = False
            if self._watchers:
                self._notify_commit()
        return msg
