"""Sequencer-attached streaming fold: incremental
summarization that rides the COMMIT stream instead of waiting for
catch-up traffic.

The bulk catch-up path is demand-driven: the first client asking for a
document pays pack → fold → extract for the whole tail since the last
summary.  Under a catch-up storm that demand arrives all at once —
admission bounds the damage, but the cold folds are still there.  This
service removes the demand spike at its source: every committed
micro-batch is folded SHORTLY AFTER it commits, the folded device state
stays PINNED in the tier-2.5 resident-state tier (suffix packs splice
onto device-resident base chunks — no re-upload, no re-fold of history),
and the resulting summaries are continuously published through the
store's idempotent ``upload_absent`` election.  A catch-up then finds a
summary at most one fold cadence behind the durable head and serves it
from the STREAMING HEAD lane — ``(handle, ref_seq)`` plus a bounded tail
the client replays itself (the summary + tail reference contract) — with
no fold, no admission, no device work.

Attachment — watchers, not subscribers: the sequencer's commit feed for
this service is the :meth:`~..protocol.sequencer.Sequencer.watch_commits`
list, which is deliberately INVISIBLE to ``has_subscribers_besides`` —
riding the ordinary subscriber list would force every columnar submit
through the boxing path (``columnar_ready`` would see a third
subscriber) and quietly destroy the zero-boxing pipeline this repo
exists to measure.  The hook itself only RECORDS the new head under the
service lock; all folding happens in :meth:`poll`, which the owner calls
at its own cadence (the server after each submit batch, the swarm once
per virtual tick).  Nothing here reads a wall clock: cadence is measured
in sequence numbers, so replay runs fold at identical points.

Summary-anchored truncation: once a summary at ``ref_seq`` is durable,
oplog records at or below ``min(ref_seq, MSN, head − retention_floor)``
can never be needed again — catch-up serves the summary, gap repair
starts strictly above the summary's ref_seq (``from_seq == floor`` is
the legal boundary), and in-flight submits referencing below MSN are
already nacked ``staleView``.  :meth:`poll` advances the oplog floor to
that cut after each publish, carrying the orderer checkpoint in the
truncation marker so a crashed process can still
:meth:`~.orderer.DocumentOrderer.recover` a log whose prefix is gone.

Degradation contract (chaos seam): a stalled streaming fold
(``stream.stall``) skips whole poll rounds — summaries age past
``stream_lag``, and catch-ups simply fall back to the existing cold-fold
path, byte-identical, with the downgrade visible in the counters.  A
``stream.crash`` aborts one poll round mid-selection; the unprocessed
documents stay pending and fold on the next round.  Streaming on vs. off
must converge byte-identically — the fold path is the SAME
``CatchupService`` fold either way, just invoked earlier and with
``pin_resident=True``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .catchup_cache import StreamHeadIndex

__all__ = ["StreamFoldService", "DEFAULT_CADENCE_OPS",
           "DEFAULT_RETENTION_FLOOR"]

#: fold once a document has this many committed-but-unfolded ops.  Small
#: enough that the streaming-head lane (`head - ref_seq <= cadence`)
#: covers a herd join, large enough that the per-fold fixed cost (dispatch
#: + extract) amortizes over a real micro-batch.
DEFAULT_CADENCE_OPS = 8

#: never truncate the newest N ops even when a summary covers them: a
#: live client repairing a gap close to the head must find the records,
#: and keeping a bounded hot tail makes the truncated log self-serving
#: for every `deltas()` read pattern the tests exercise.
DEFAULT_RETENTION_FLOOR = 64


class StreamFoldService:
    """Commit-driven incremental summarizer over one ordering service.

    Owns no device state itself: folding is delegated to the existing
    :class:`~.catchup.CatchupService` (same kernels, same caches, same
    byte-identical results), with ``pin_resident=True`` so each fold's
    device chunks stay pinned in the tier-2.5 resident-state tier for
    the NEXT micro-batch to splice onto.

    Counters (all under ``_lock``): ``polls`` (rounds entered),
    ``folds`` (rounds that folded at least one doc), ``docs_folded``,
    ``ops_folded`` (sequence numbers advanced past), ``publishes``
    (index publications), ``stalls`` (rounds skipped by
    ``stream.stall``), ``crashes`` (rounds aborted mid-selection by
    ``stream.crash``), ``truncations`` (oplog cuts that dropped
    records), ``truncated_msgs`` (records those cuts dropped).
    """

    def __init__(self, service, catchup, *,
                 cadence_ops: int = DEFAULT_CADENCE_OPS,
                 retention_floor: int = DEFAULT_RETENTION_FLOOR,
                 truncate: bool = True,
                 faults=None,
                 head_index: Optional[StreamHeadIndex] = None) -> None:
        if cadence_ops < 1:
            raise ValueError("cadence_ops must be >= 1")
        if retention_floor < 0:
            raise ValueError("retention_floor must be >= 0")
        self.service = service
        self.catchup = catchup
        self.cadence_ops = int(cadence_ops)
        self.retention_floor = int(retention_floor)
        self.truncate_enabled = bool(truncate)
        self._faults = faults
        self.head_index = head_index if head_index is not None \
            else StreamHeadIndex()
        self._lock = threading.Lock()
        self._pending: Dict[str, int] = {}  # doc -> committed head  guarded-by: _lock
        self._folded: Dict[str, int] = {}  # doc -> head at last fold  guarded-by: _lock
        self._attached = False  # guarded-by: _lock
        self.counters: Dict[str, int] = {
            "polls": 0, "folds": 0, "docs_folded": 0, "ops_folded": 0,
            "publishes": 0, "stalls": 0, "crashes": 0,
            "truncations": 0, "truncated_msgs": 0,
        }  # guarded-by: _lock

    # -- attachment ------------------------------------------------------------

    def attach(self) -> "StreamFoldService":
        """Install the commit hook on the ordering service (idempotent).
        Every already-live orderer and every later-created one feeds
        :meth:`_on_commit` from its sequencer's watcher list."""
        with self._lock:
            if self._attached:
                return self
            self._attached = True
        self.service.set_commit_hook(self._on_commit)
        return self

    def detach(self) -> None:
        with self._lock:
            if not self._attached:
                return
            self._attached = False
        self.service.set_commit_hook(None)

    def _on_commit(self, doc_id: str, head_seq: int) -> None:
        """Sequencer commit watcher: RECORD ONLY.  Runs inside the
        stamping path (possibly inside an open ``oplog.batch()``), so it
        must not fold, flush, or touch the device — it just remembers
        the newest committed head for :meth:`poll` to pick up."""
        with self._lock:
            prev = self._pending.get(doc_id, 0)
            if head_seq > prev:
                self._pending[doc_id] = int(head_seq)

    # -- the poll loop ---------------------------------------------------------

    def note_doc(self, doc_id: str) -> None:
        """Seed a document into the pending map from its durable head
        (used when attaching to a service with pre-existing history —
        the commit hook only sees commits made AFTER attachment)."""
        head = self.service.oplog.head(doc_id)
        if head > 0:
            self._on_commit(doc_id, head)

    def due(self, force: bool = False) -> List[str]:
        """Documents whose unfolded span reached the cadence (all
        pending docs when ``force``), in sorted order (determinism)."""
        with self._lock:
            return sorted(
                d for d, head in self._pending.items()
                if head > self._folded.get(d, 0)
                and (force
                     or head - self._folded.get(d, 0) >= self.cadence_ops)
            )

    def poll(self, force: bool = False) -> Dict[str, Tuple[str, int]]:
        """One streaming round: fold every due document's committed
        micro-batch, publish the summaries, advance the truncation
        floor.  Returns ``{doc_id: (handle, ref_seq)}`` for the folded
        documents.  MUST run outside any open ``oplog.batch()`` — the
        truncation marker's durability commit point is a flush.
        """
        with self._lock:
            self.counters["polls"] += 1
        fault = (self._faults.fire("stream.stall")
                 if self._faults is not None else None)
        if fault is not None:
            # Stalled round: fold nothing.  Lag grows past stream_lag
            # and catch-ups degrade to the cold-fold path — the
            # downgrade the counters (and the chaos verdict) look for.
            with self._lock:
                self.counters["stalls"] += 1
            return {}
        due = self.due(force=force)
        batch: List[str] = []
        crashed = False
        for doc_id in due:
            fault = (self._faults.fire("stream.crash", doc=doc_id)
                     if self._faults is not None else None)
            if fault is not None:
                # The round dies mid-selection: docs already selected
                # fold below; this doc and the rest stay pending and
                # fold next round.  The service survives (swallow +
                # count) — only the ROUND crashed, not the process.
                crashed = True
                break
            batch.append(doc_id)
        if crashed:
            with self._lock:
                self.counters["crashes"] += 1
        if not batch:
            return {}
        # Observe lag BEFORE folding: the honest "how far behind is the
        # newest durable summary" number the lag gate bounds by cadence.
        with self._lock:
            heads = {d: self._pending[d] for d in batch}
        for doc_id, head in heads.items():
            self.head_index.observe_lag(doc_id, head)
        # The SAME fold the demand path runs — byte-identical by
        # construction — pinned device-resident for the next splice.
        results = self.catchup.catch_up(batch, upload=True,
                                        pin_resident=True)
        epoch = self.service.storage.epoch
        folded_docs = 0
        folded_ops = 0
        with self._lock:
            for doc_id, (_handle, ref_seq) in results.items():
                prev = self._folded.get(doc_id, 0)
                if ref_seq > prev:
                    folded_ops += ref_seq - prev
                    self._folded[doc_id] = int(ref_seq)
                folded_docs += 1
            self.counters["docs_folded"] += folded_docs
            self.counters["ops_folded"] += folded_ops
            if folded_docs:
                self.counters["folds"] += 1
        for doc_id, (handle, ref_seq) in sorted(results.items()):
            if self.head_index.publish(doc_id, handle, ref_seq, epoch):
                with self._lock:
                    self.counters["publishes"] += 1
            if self.truncate_enabled:
                self._truncate_below_summary(doc_id, ref_seq)
        return results

    # -- summary-anchored truncation -------------------------------------------

    def _truncate_below_summary(self, doc_id: str, ref_seq: int) -> int:
        """Advance the oplog floor to ``min(newest durable summary
        ref_seq, MSN, head − retention_floor)``.  Every term is a
        CANNOT-BE-NEEDED bound: the summary serves everything at or
        below its ref_seq; a submit referencing below MSN is already
        nacked ``staleView`` (so no live client can gap-repair below
        it); the retention floor keeps a hot tail for near-head repairs
        regardless.  The orderer checkpoint rides the truncation marker
        so crash recovery never needs the dropped prefix."""
        oplog = self.service.oplog
        head = oplog.head(doc_id)
        # A sharded service keeps orderers per shard — the MSN/checkpoint
        # source is the owning shard's LocalOrderingService either way.
        owner = getattr(self.service, "_owner", None)
        svc = owner(doc_id) if callable(owner) else self.service
        with svc.state_lock:
            orderer = svc._orderers.get(doc_id)
            if orderer is None:
                # No live orderer → no checkpoint to anchor recovery on;
                # leave the log whole (the next poll after recovery cuts).
                return 0
            msn = orderer.sequencer.min_seq
            cut = min(int(ref_seq), int(msn),
                      int(head) - self.retention_floor)
            if cut <= oplog.floor(doc_id):
                return 0
            checkpoint = orderer.checkpoint()
        dropped = oplog.truncate(doc_id, cut, checkpoint=checkpoint)
        if dropped:
            with self._lock:
                self.counters["truncations"] += 1
                self.counters["truncated_msgs"] += dropped
        return dropped

    # -- introspection ---------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.counters)
            out["pending_docs"] = sum(
                1 for d, head in self._pending.items()
                if head > self._folded.get(d, 0))
        for key, value in self.head_index.stats().items():
            out[f"head_{key}"] = value
        # The log's own compaction counter: bytes physically dropped by
        # this service's truncations (the honest before/after-truncation
        # size delta — markers and rewrites already netted out).
        out["oplog_bytes_reclaimed"] = int(
            getattr(self.service.oplog, "bytes_reclaimed", 0))
        return out
