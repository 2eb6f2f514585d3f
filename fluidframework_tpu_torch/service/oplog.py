"""Durable per-document op log — the Scriptorium capability.

Capability-equivalent of the reference's ``ScriptoriumLambda`` + the Mongo
``deltas`` collection it writes (SURVEY.md §2.3; upstream paths UNVERIFIED —
empty reference mount): every sequenced message is appended durably, and
catch-up (a loading client, or the TPU bulk-replay service) reads ranged
tails ``(from_seq, to_seq]``.

Persistence is newline-delimited canonical JSON (one record per line, fsync
on ``flush()``), append-only — reopening a log replays the file.  This is
the host-side feed that gets packed into ragged device tensors; keeping it
as a flat append-only byte stream is what makes the native packer able to
mmap and scan it without touching Python objects.

Durability contract (SEMANTICS.md "Durability & retry"): ``append`` is
exception-safe — a write that fails (injected fault or real OSError)
leaves NEITHER the in-memory view NOR the file holding the record, so the
caller's retry re-appends cleanly instead of being silently deduplicated
against a half-applied state.  A crash can tear only the final line;
reopen repairs it (``repair_jsonl_tail``) before reads or appends resume.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
from typing import Dict, List, Optional

from ..protocol.messages import ColumnAppendError, SequencedMessage
from ..protocol.summary import canonical_json
from ..protocol.wire import (ColumnSegment, decode_sequenced_message,
                             encode_sequenced_message, entry_last_seq)
from ..utils.jsonl import iter_jsonl_tolerant, repair_jsonl_tail


class TruncatedRangeError(OSError):
    """A ranged read asked for seqs below the document's truncation
    floor: the log no longer holds them.  Callers that can re-anchor on
    a summary at or above ``floor`` should; anything else is a bug —
    truncation only ever cuts below the newest durable summary AND the
    sequencer's minimum sequence number, so no live client's gap repair
    can land here."""

    def __init__(self, doc_id: str, from_seq: int, floor: int) -> None:
        super().__init__(
            f"doc {doc_id!r}: range from_seq={from_seq} is below the "
            f"truncation floor {floor}")
        self.doc_id = doc_id
        self.from_seq = from_seq
        self.floor = floor


def shard_log_path(base_dir: str, shard_id: str) -> str:
    """The canonical per-shard durable log location of the out-of-process
    tier (fluidproc): every shard host writes its OWN log file under the
    shared deployment directory, and failover/migration readers derive a
    dead or source shard's log from nothing but ``(base_dir, shard_id)``.
    """
    return os.path.join(base_dir, "shards", shard_id, "oplog.ndjson")


class OpLog:
    """Append-only sequenced-op store for many documents.

    In-memory by default; pass ``path`` for a durable file-backed log that
    survives process restarts (the crash-resume tests reopen it).
    ``faults`` (a ``testing.faults.FaultInjector``) arms the
    ``oplog.append`` / ``oplog.flush`` fault sites.

    ``read_only=True`` opens a file-backed log for READS only (no append
    handle is held and every write raises): the fluidproc adoption path —
    a surviving shard importing a SIGKILLed peer's documents from that
    peer's log file — must never become a second writer of a log whose
    owner could, in principle, still be mid-death.  The torn-tail repair
    still runs (it is exactly what the dead owner's restart would do).
    """

    def __init__(self, path: Optional[str] = None,
                 autoflush: bool = False, faults=None,
                 read_only: bool = False) -> None:
        if read_only and path is None:
            raise ValueError("read_only needs a file-backed log")
        self._docs: Dict[str, List[SequencedMessage]] = {}  # durable-shadow: log view
        #: summary-anchored truncation floor per doc: seqs <= floor have
        #: been sealed and dropped; reads from below raise
        #: :class:`TruncatedRangeError`.  0 = never truncated.
        self._floors: Dict[str, int] = {}
        #: orderer checkpoint persisted with each truncation marker so
        #: recovery of a truncated doc restores from it instead of
        #: replaying from seq 1 (which the log can no longer serve).
        self._trunc_ckpts: Dict[str, dict] = {}
        #: lifetime truncation counters (for stats surfaces)
        self.truncated_msgs = 0
        self.truncations = 0
        self.bytes_reclaimed = 0
        self._path = path
        self._autoflush = autoflush
        self._faults = faults
        self._read_only = read_only
        #: >0 while inside batch(): per-append autoflush is deferred to
        #: ONE flush at outermost batch exit (group commit)
        self._batch_depth = 0
        self._batch_dirty = False
        self._file: Optional[io.TextIOWrapper] = None  # durable-handle: single-record
        if path is not None:
            # The op log is the highest-write-rate file in the store: a
            # crash mid-append is likeliest here.  Repair the torn tail
            # (losing only the unacked final record) before reading or
            # appending, or the reopen would raise / the next append
            # would merge onto the partial line.
            repair_jsonl_tail(path)
            for rec in iter_jsonl_tolerant(path):
                trunc = rec.get("truncate")
                if trunc is not None:
                    # Truncation marker: everything at or below ``below``
                    # is sealed.  In an uncompacted log (crash between
                    # seal and drop) the marker FOLLOWS the old records,
                    # so applying it here drops them exactly as the
                    # interrupted truncation would have; in a compacted
                    # log it leads and the drop is a no-op.
                    self._apply_marker(rec["doc"], int(trunc["below"]),
                                       trunc.get("checkpoint"))
                    continue
                msg = decode_sequenced_message(rec["msg"])
                if msg.seq <= self._floors.get(rec["doc"], 0):
                    continue  # pre-marker replay of a sealed record
                log = self._docs.setdefault(rec["doc"], [])
                if log and msg.seq <= log[-1].seq:
                    if msg.seq == log[-1].seq:
                        # Duplicate seq on disk: either a failed-then-
                        # retried append re-wrote the identical record,
                        # or a PHANTOM — an append whose bytes landed but
                        # whose fsync failed was rolled back, and a
                        # different op later won the same seq.  The LAST
                        # line is what the live history actually
                        # broadcast in both cases; the first would
                        # resurrect a message no client ever saw.
                        log[-1] = msg
                    continue
                log.append(msg)
            if not read_only:
                self._file = open(path, "a", encoding="utf-8")

    # -- write side (the scriptorium lambda) -----------------------------------

    def _check_writable(self) -> None:
        if self._read_only:
            raise OSError(f"op log {self._path!r} is read-only "
                          "(adoption/backfill view of a peer shard's log)")

    def append(self, doc_id: str, msg: SequencedMessage) -> None:
        self._check_writable()
        if msg.seq <= self._floors.get(doc_id, 0):
            return  # sealed below the truncation floor: a replay no-op
        log = self._docs.setdefault(doc_id, [])
        if log and msg.seq <= entry_last_seq(log[-1]):
            return  # exactly-once: replays after crash-resume are idempotent
        fault = (self._faults.fire("oplog.append", doc=doc_id)
                 if self._faults is not None else None)
        if fault is not None and (fault.kind == "fail"
                                  or self._file is None):
            # In-memory logs have no bytes to tear: every armed kind
            # degrades to a plain append failure.
            from ..testing.faults import FaultError

            raise FaultError("oplog.append", fault.kind, doc_id)
        log.append(msg)
        if self._file is not None:
            rec = {"doc": doc_id, "msg": encode_sequenced_message(msg)}
            line = canonical_json(rec).decode("utf-8") + "\n"
            if fault is not None and fault.kind == "torn":
                self._torn_append(log, line, fault)
            try:
                self._file.write(line)  # commit-point: op record; unwinds: _docs
                if self._autoflush:
                    if self._batch_depth:
                        # Group commit (batched ingress): defer the fsync
                        # to the single flush at batch() exit — see the
                        # SEMANTICS.md batched-ingress note for what this
                        # weakens (in-process subscribers may observe a
                        # record before the batch's fsync lands).
                        self._batch_dirty = True
                    else:
                        # Durable-before-broadcast: the append rides first
                        # in the sequencer broadcast chain, so flushing
                        # here means no client ever sees an op the log
                        # could lose (the reference's scriptorium-
                        # durability property).
                        self.flush()
            except OSError:
                # Exception safety: the record is not durable, so it must
                # not stay visible in memory either — a retry would be
                # deduped against it and the durable log would keep a
                # hole.  Best-effort tail repair clears any partial bytes
                # (a record torn at the newline may instead be SEALED
                # complete — then the reopen-dedup above absorbs the
                # retry's duplicate line).
                log.pop()
                self._repair_open_tail()
                raise

    def append_columns(self, doc_id: str, segment: ColumnSegment) -> None:
        """Bulk columnar append: one in-memory entry and ONE bulk line
        encode for a whole stamped segment — the durable half of the
        columnar ingress path (``Sequencer.submit_columns``'s gate).

        Failure contract: raises :class:`ColumnAppendError` carrying how
        many rows landed durably; rows ``[0, landed)`` stay in the log
        (they may already be fsync-scheduled), everything later was
        never written.  With a fault injector armed the bulk path drops
        to per-row boxed appends so every ``oplog.append`` occurrence
        fires exactly as it would under per-op ingress — fault schedules
        line up byte-for-byte across the columnar and boxed modes.
        """
        self._check_writable()
        n = len(segment)
        if n == 0:
            return
        if segment.last_seq <= self._floors.get(doc_id, 0):
            return  # wholly below the truncation floor: a replay no-op
        log = self._docs.setdefault(doc_id, [])
        if self._faults is not None or (
                log and segment.start_seq <= entry_last_seq(log[-1])):
            # Fault-exact (or replayed-prefix dedup) slow path: per-row
            # boxed appends keep occurrence counting and exactly-once
            # semantics identical to per-op ingress.
            for j in range(n):
                try:
                    self.append(doc_id, segment.materialize(j))
                except BaseException as err:
                    if not isinstance(err, Exception):
                        raise
                    raise ColumnAppendError(j, err) from err
            return
        log.append(segment)
        if self._file is None:
            return
        # ONE bulk encode; the writes ride the shared buffered handle so
        # a failure isolates to the row it hit, like per-op appends.
        lines = [canonical_json({"doc": doc_id,
                                 "msg": segment.wire_dict(j)}
                                ).decode("utf-8") + "\n"
                 for j in range(n)]
        landed = 0
        try:
            for line in lines:
                self._file.write(line)  # commit-point: columnar op records; unwinds: _docs
                landed += 1
            if self._autoflush:
                if self._batch_depth:
                    self._batch_dirty = True
                else:
                    self.flush()
        except OSError as err:
            # Keep the landed prefix (its bytes are written and may be
            # durable), drop the failed row and everything after it,
            # repair any partial final line.
            if landed:
                log[-1] = segment.prefix(landed)
            else:
                log.pop()
            self._repair_open_tail()
            raise ColumnAppendError(landed, err) from err

    def _torn_append(self, log: List[SequencedMessage], line: str,
                     fault) -> None:
        """Injected torn partial write: a strict prefix of the record
        reaches the disk (fsynced — the tear is as durable as a real
        crash would make it), then the append fails and the log
        self-repairs by truncating back to the record start.  The caller
        sees an OSError; the file never serves the torn bytes."""
        from ..testing.faults import FaultError

        self._file.flush()
        start = os.fstat(self._file.fileno()).st_size
        frac = fault.arg if 0.0 < fault.arg < 1.0 else 0.5
        cut = max(1, min(len(line) - 2, int(len(line) * frac)))
        self._file.write(line[:cut])
        self._file.flush()
        os.fsync(self._file.fileno())
        with open(self._path, "r+b") as g:
            g.truncate(start)
        log.pop()
        raise FaultError("oplog.append", "torn",
                         f"{cut}/{len(line)} bytes")

    def _repair_open_tail(self) -> None:
        """Best-effort: clear a partial final line left by a failed write
        so later appends do not merge onto it.  The append handle is
        O_APPEND — its next write lands at the repaired EOF.  Tolerates a
        concurrently-sealed handle (ValueError on a closed file): the
        on-disk repair below is the part that matters."""
        try:
            if self._file is not None:
                self._file.flush()
        except (OSError, ValueError):
            pass
        try:
            repair_jsonl_tail(self._path)
        except OSError:
            pass

    @contextlib.contextmanager
    def batch(self):
        """Group commit: appends inside the block skip their per-append
        autoflush; the outermost exit pays ONE flush (fsync) for the whole
        batch — the per-batch durability point of the batched ingress
        surface (``ShardedOrderingService.submit_many``).  Exception-safe:
        a batch that aborts partway still flushes the records that landed
        (they were broadcast; they must not be losable), and a FAILED
        deferred flush keeps the batch marked dirty — the records' bytes
        were already written to the file object, so the next successful
        flush (a later batch exit, an explicit ``flush()``, or ``close``)
        makes them durable; the failure itself propagates so no caller
        mistakes the batch for committed.  Nests: inner batches defer to
        the outermost.  In-memory logs (no file) make this a no-op."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0 and self._batch_dirty:
                self.flush()
                self._batch_dirty = False

    def flush(self) -> None:
        if self._file is not None:
            fault = (self._faults.fire("oplog.flush")
                     if self._faults is not None else None)
            if fault is not None and fault.kind == "fail":
                from ..testing.faults import FaultError

                raise FaultError("oplog.flush", "fail")
            self._file.flush()
            if fault is not None and fault.kind == "skip_fsync":
                return  # delayed fsync: bytes sit in the page cache
            os.fsync(self._file.fileno())

    def close(self) -> None:
        if self._file is not None:
            self.flush()
            self._file.close()
            self._file = None

    # -- summary-anchored truncation -------------------------------------------

    def floor(self, doc_id: str) -> int:
        """The document's truncation floor: highest seq sealed and
        dropped (0 if never truncated).  Reads must start at or above
        it; ``get(doc, from_seq=floor)`` is the exact boundary read."""
        return self._floors.get(doc_id, 0)

    def truncation_checkpoint(self, doc_id: str) -> Optional[dict]:
        """The orderer checkpoint persisted with the newest truncation
        marker, or None.  Recovery of a truncated doc restores from this
        instead of full replay (the sealed prefix is gone)."""
        return self._trunc_ckpts.get(doc_id)

    def _apply_marker(self, doc_id: str, below: int,
                      checkpoint: Optional[dict]) -> int:
        """Apply a truncation floor to the in-memory view: raise the
        floor, remember the checkpoint, drop entries wholly at or below
        the cut.  A columnar segment straddling the cut stays whole —
        the floor still guards reads into its sealed prefix."""
        if below <= self._floors.get(doc_id, 0):
            return 0
        self._floors[doc_id] = below
        if checkpoint is not None:
            self._trunc_ckpts[doc_id] = checkpoint
        log = self._docs.get(doc_id)
        if not log:
            return 0
        kept = []
        dropped = 0
        for entry in log:
            if entry_last_seq(entry) <= below:
                dropped += (len(entry)
                            if isinstance(entry, ColumnSegment) else 1)
            else:
                kept.append(entry)
        self._docs[doc_id] = kept
        return dropped

    def truncate(self, doc_id: str, below_seq: int,
                 checkpoint: Optional[dict] = None) -> int:
        """Summary-anchored truncation: seal and drop every record with
        ``seq <= below_seq``.  Returns the number of messages dropped.

        The CALLER owns the safety argument — ``below_seq`` must be at
        or under both the newest durable summary's ref_seq (so catch-up
        can always re-anchor) and the sequencer's minimum sequence
        number (so no live client's gap repair lands below the cut);
        see ``service.streamfold``.  ``checkpoint`` (an orderer
        checkpoint) rides in the durable marker so a later recovery can
        restore without the sealed prefix.

        Crash discipline mirrors the shard migration points: the
        ``oplog.truncate.seal`` site fires BEFORE the marker is durable
        (a crash here leaves the log byte-identical — nothing happened);
        the marker line is then appended and fsynced (the commit point);
        ``oplog.truncate.drop`` fires AFTER the marker but BEFORE
        physical compaction (a crash here reopens to the same floor —
        the marker re-applies the drop — with the dead bytes reclaimed
        by the next successful truncation's rewrite)."""
        self._check_writable()
        below_seq = min(below_seq, self.head(doc_id))
        if below_seq <= self._floors.get(doc_id, 0):
            return 0
        fault = (self._faults.fire("oplog.truncate.seal", doc=doc_id)
                 if self._faults is not None else None)
        if fault is not None:
            from ..testing.faults import FaultError

            raise FaultError("oplog.truncate.seal", fault.kind, doc_id)
        if self._file is not None:
            rec = {"doc": doc_id,
                   "truncate": {"below": below_seq,
                                "checkpoint": checkpoint}}
            self._file.write(canonical_json(rec).decode("utf-8") + "\n")
            self.flush()  # commit-point: truncation marker fsync
        dropped = self._apply_marker(doc_id, below_seq, checkpoint)
        self.truncations += 1
        self.truncated_msgs += dropped
        fault = (self._faults.fire("oplog.truncate.drop", doc=doc_id)
                 if self._faults is not None else None)
        if fault is not None:
            from ..testing.faults import FaultError

            raise FaultError("oplog.truncate.drop", fault.kind, doc_id)
        if self._file is not None:
            self._compact()
        return dropped

    def adopt_floor(self, doc_id: str, below: int,
                    checkpoint: Optional[dict] = None) -> None:
        """Import-side floor adoption (migration/failover of a TRUNCATED
        document): persist the source log's truncation marker into THIS
        log verbatim.  Unlike :meth:`truncate` there is no head clamp
        and no crash-point choreography — the sealed prefix never
        crossed the wire, so there is nothing here to seal or drop;
        the marker just records that seqs at or below ``below`` are
        vouched for by the summary anchor, and carries the recovery
        checkpoint along."""
        self._check_writable()
        if below <= self._floors.get(doc_id, 0):
            return
        if self._file is not None:
            rec = {"doc": doc_id,
                   "truncate": {"below": below, "checkpoint": checkpoint}}
            self._file.write(canonical_json(rec).decode("utf-8") + "\n")
            self.flush()  # commit-point: adopted truncation marker
        self._apply_marker(doc_id, below, checkpoint)

    def _compact(self) -> None:
        """Physically drop sealed bytes: rewrite the whole file from the
        in-memory view (markers first so a reopen raises each doc's
        floor before its surviving records), fsync the replacement, then
        atomically swap it in and reopen the append handle.  Atomicity
        rides ``os.replace`` — a crash mid-rewrite leaves the original
        intact and the tmp file as garbage."""
        before = os.path.getsize(self._path) if os.path.exists(
            self._path) else 0
        tmp = self._path + ".compact"
        with open(tmp, "w", encoding="utf-8") as out:
            for doc_id in sorted(set(self._docs) | set(self._floors)):
                floor = self._floors.get(doc_id, 0)
                if floor:
                    rec = {"doc": doc_id,
                           "truncate": {
                               "below": floor,
                               "checkpoint":
                                   self._trunc_ckpts.get(doc_id)}}
                    out.write(canonical_json(rec).decode("utf-8") + "\n")
                for entry in self._docs.get(doc_id, []):
                    if isinstance(entry, ColumnSegment):
                        for j in range(len(entry)):
                            rec = {"doc": doc_id,
                                   "msg": entry.wire_dict(j)}
                            out.write(canonical_json(rec)
                                      .decode("utf-8") + "\n")
                    else:
                        rec = {"doc": doc_id,
                               "msg": encode_sequenced_message(entry)}
                        out.write(canonical_json(rec)
                                  .decode("utf-8") + "\n")
            out.flush()
            os.fsync(out.fileno())
        if self._file is not None:
            self._file.close()
        os.replace(tmp, self._path)
        self._file = open(self._path, "a", encoding="utf-8")
        try:  # best-effort directory fsync so the rename is durable
            dfd = os.open(os.path.dirname(self._path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
        self.bytes_reclaimed += max(
            0, before - os.path.getsize(self._path))

    # -- read side (catch-up) --------------------------------------------------

    def doc_ids(self) -> List[str]:
        return sorted(self._docs)

    def head(self, doc_id: str) -> int:
        """Highest sequenced seq for the document (0 if none).  A
        truncated-then-idle doc reports its floor: the sealed history
        still happened even though its bytes are gone."""
        log = self._docs.get(doc_id)
        if log:
            return entry_last_seq(log[-1])
        return self._floors.get(doc_id, 0)

    def get(
        self, doc_id: str, from_seq: int = 0, to_seq: Optional[int] = None
    ) -> List[SequencedMessage]:
        """Ranged read: messages with ``from_seq < seq <= to_seq`` in order
        (the loader's catch-up fetch; half-open so ``from_seq`` is 'the seq
        my summary already covers').  Columnar segments materialize their
        in-range rows on the fly — readers always see plain
        :class:`SequencedMessage` objects.

        Raises :class:`TruncatedRangeError` when ``from_seq`` is below
        the truncation floor: the sealed prefix is gone and serving a
        silently-gapped tail would corrupt the reader.  The boundary
        read ``from_seq == floor`` is legal (half-open range — the
        floor seq itself is never returned)."""
        floor = self._floors.get(doc_id, 0)
        if from_seq < floor:
            raise TruncatedRangeError(doc_id, from_seq, floor)
        log = self._docs.get(doc_id, [])
        out = []
        for entry in log:
            if isinstance(entry, ColumnSegment):
                if entry.last_seq <= from_seq:
                    continue
                if to_seq is not None and entry.start_seq > to_seq:
                    break
                for j in range(len(entry)):
                    s = entry.start_seq + j
                    if s <= from_seq:
                        continue
                    if to_seq is not None and s > to_seq:
                        break
                    out.append(entry.materialize(j))
                continue
            if entry.seq <= from_seq:
                continue
            if to_seq is not None and entry.seq > to_seq:
                break
            out.append(entry)
        return out

    def is_contiguous(self, doc_id: str) -> bool:
        """True iff the document's seqs are exactly 1..head with no gap
        or duplicate — O(entries), not O(messages): columnar segments
        are contiguous by construction (seqs are an arange), so only
        their boundaries need checking.  A truncated doc is contiguous
        from its floor: the sealed prefix is vouched for by the marker's
        summary anchor, not re-checked."""
        floor = self._floors.get(doc_id, 0)
        prev = floor
        for entry in self._docs.get(doc_id, []):
            if isinstance(entry, ColumnSegment):
                if len(entry) == 0:
                    continue
                # A segment straddling the truncation cut is kept whole;
                # only its live suffix (> floor) counts for contiguity.
                start = max(entry.start_seq, floor + 1)
                if start != prev + 1:
                    return False
                prev = entry.last_seq
            else:
                if entry.seq != prev + 1:
                    return False
                prev = entry.seq
        return True
