"""Tier 0 of the catch-up cache: the digest-gated delta download.

The port's copy of ``DeltaExportCache`` (with ``_DeltaEntry`` and
``tree_nbytes``) from ``fluidframework_tpu/service/catchup_cache.py``.
The pipeline (``ops/pipeline.py``) asks the fold for a per-document state
digest, fetches only that ``[D, 2]`` plane eagerly, and downloads and
extracts only the documents whose digest changed; unchanged documents
serve their cached summaries byte-identically.  The tier-1 result cache
(``CatchupResultCache``) and the streaming fold's ``StreamHeadIndex`` are
not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

from ..protocol.summary import SummaryBlob, SummaryTree
from ..utils.telemetry import CounterSet

#: accounting overhead charged per summary node (name + dict slot + object
#: headers) so byte budgets track real memory, not just blob payloads.
NODE_OVERHEAD = 96


def tree_nbytes(node) -> int:
    """Approximate retained bytes of a summary tree: blob payloads plus a
    flat per-node overhead.  Deterministic (no sys.getsizeof walks)."""
    if isinstance(node, SummaryBlob):
        return NODE_OVERHEAD + len(node.content)
    total = NODE_OVERHEAD
    if isinstance(node, SummaryTree):
        for name, child in node.children.items():
            total += len(name) + tree_nbytes(child)
    return total


class _DeltaEntry(NamedTuple):
    """One document's previous fold, as the delta path needs it: the
    host-side anchor that pins the fold's INPUT under the token contract,
    the device-computed state digest, and the extracted summary."""

    anchor: tuple           # (n_ops, final_seq, final_msn, attribution)
    digest: Tuple[int, int]
    tree: SummaryTree
    nbytes: int


class DeltaExportCache:
    """Tier 0 of the catch-up cache: per-document state digests + the
    previously extracted summaries, keyed by the pipeline's
    ``MergeTreeDocInput.cache_token`` (``(epoch, channel, base ref_seq,
    base summary digest)`` — the same append-only anchor tier 2 packs
    under).  The fold stays device-resident: a warm catch-up over a
    grown tail re-folds (cheaply, through the pack cache), fetches only
    the tiny digest plane, and downloads + extracts ONLY the documents
    whose digest changed — unchanged documents serve their cached
    summaries byte-identically.

    Correctness is structural, belt and braces:

    - a served summary requires the TOKEN (append-only op stream over a
      pinned base within one storage generation), the HOST ANCHOR
      (op-stream length — under append-only ops, equal length means the
      identical op list — plus ``final_seq``/``final_msn``/attribution,
      the extraction inputs that live outside device state), AND the
      64-bit device digest to all match;
    - any missing entry, anchor drift, or digest mismatch falls back to
      the full download — the delta path can lose a win, never bytes;
    - binary-stream and token-less documents bypass entirely.

    No wall-clock (LRU over insertion order); all mutation under one
    lock.  Counters: ``served`` (documents whose download+extract was
    skipped), ``changed`` (candidates whose digest moved), ``misses``
    (no candidate entry), ``inserts``/``evictions``, ``invalidations``
    (epoch drops), ``bytes_saved`` (d2h bytes the gather avoided).
    """

    def __init__(self, max_bytes: int = 256 << 20) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # dict insertion order IS the LRU order (touch = delete+reinsert)
        self._entries: Dict[tuple, _DeltaEntry] = {}  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._last_epoch: Optional[str] = None  # guarded-by: _lock
        self.counters = CounterSet(
            "served", "changed", "misses", "inserts", "evictions",
            "invalidations", "bytes_saved",
        )  # guarded-by: _lock (CounterSet is not internally synchronized)

    @staticmethod
    def _anchor(doc) -> tuple:
        return (len(doc.ops), doc.final_seq, doc.final_msn,
                bool(doc.attribution))

    @staticmethod
    def _eligible(doc) -> bool:
        # Binary-stream docs carry their ops opaquely (len(doc.ops) == 0
        # would alias every window): bypass, like tier 2 does.  Families
        # without a binary form (tree) simply lack the attribute — the
        # tier is family-generic, so probe, don't assume.
        return doc.cache_token is not None \
            and getattr(doc, "binary_ops", None) is None

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = self.counters.snapshot()
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
        return out

    def note_bytes_saved(self, nbytes: int) -> None:
        """The pipeline reports the d2h bytes its gather skipped."""
        with self._lock:
            self.counters.bump("bytes_saved", int(nbytes))

    # -- the delta handshake ---------------------------------------------------

    def _candidate_locked(self, doc) -> bool:
        entry = self._entries.get(doc.cache_token)
        return entry is not None and entry.anchor == self._anchor(doc)

    def candidate(self, doc) -> bool:
        """Dispatch-time pre-check (no digest yet): could this document
        possibly be served?"""
        if not self._eligible(doc):
            return False
        with self._lock:
            return self._candidate_locked(doc)

    def any_candidate(self, docs) -> bool:
        """Chunk-level :meth:`candidate` under ONE lock acquisition (the
        dispatch hot path runs this per chunk, not per doc).  A chunk
        with zero candidates keeps the plain full-fetch pipeline —
        including its dispatch-time async host copy — so cold runs pay
        nothing for the gate."""
        with self._lock:
            for doc in docs:
                if self._eligible(doc) and self._candidate_locked(doc):
                    return True
        return False

    def _serve_one_locked(self, doc, anchor: tuple,
                          digest: Tuple[int, int]):
        entry = self._entries.get(doc.cache_token)
        if entry is None or entry.anchor != anchor:
            self.counters.bump("misses")
            return None
        if entry.digest != digest:
            self.counters.bump("changed")
            return None
        # Touch: move to the back of the insertion order.
        del self._entries[doc.cache_token]
        self._entries[doc.cache_token] = entry
        self.counters.bump("served")
        return entry.tree

    def serve(self, doc, digest: Tuple[int, int]):
        """The fetched digest arrived: the cached summary iff token +
        anchor + digest all match (LRU-touched), else None (the caller
        downloads this document's rows)."""
        if not self._eligible(doc):
            return None
        anchor = self._anchor(doc)
        with self._lock:
            return self._serve_one_locked(doc, anchor, tuple(digest))

    def serve_many(self, docs, digests) -> Dict[int, SummaryTree]:
        """Batched :meth:`serve` over a chunk's fetched ``[D, 2]`` digest
        plane: ``{doc position: cached tree}`` for every servable doc,
        ONE lock acquisition for the whole chunk (the fetch hot path
        would otherwise serialize D acquire/release cycles against the
        extract threads' ``put`` calls)."""
        out: Dict[int, SummaryTree] = {}
        with self._lock:
            for d, doc in enumerate(docs):
                if not self._eligible(doc):
                    continue
                tree = self._serve_one_locked(
                    doc, self._anchor(doc),
                    (int(digests[d, 0]), int(digests[d, 1])))
                if tree is not None:
                    out[d] = tree
        return out

    def _put_locked(self, token: tuple, entry: _DeltaEntry) -> None:
        old = self._entries.pop(token, None)
        if old is not None:
            self._bytes -= old.nbytes
        if entry.nbytes > self.max_bytes:
            self.counters.bump("evictions")
            return
        self._entries[token] = entry
        self._bytes += entry.nbytes
        self.counters.bump("inserts")
        while self._bytes > self.max_bytes and self._entries:
            oldest = next(iter(self._entries))
            dropped = self._entries.pop(oldest)
            self._bytes -= dropped.nbytes
            self.counters.bump("evictions")

    def put(self, doc, digest: Tuple[int, int], tree: SummaryTree) -> None:
        """Publish/refresh a document's entry after extraction."""
        if not self._eligible(doc):
            return
        entry = _DeltaEntry(self._anchor(doc), tuple(digest), tree,
                            tree_nbytes(tree))
        with self._lock:
            self._put_locked(doc.cache_token, entry)

    def put_many(self, items) -> None:
        """Batched :meth:`put` over ``(doc, digest, tree)`` triples: the
        entries (including the ``tree_nbytes`` walks) are built OUTSIDE
        the lock, then one acquisition publishes the whole chunk —
        symmetric with :meth:`serve_many` on the read side."""
        entries = [
            (doc.cache_token,
             _DeltaEntry(self._anchor(doc), tuple(digest), tree,
                         tree_nbytes(tree)))
            for doc, digest, tree in items if self._eligible(doc)
        ]
        if not entries:
            return
        with self._lock:
            for token, entry in entries:
                self._put_locked(token, entry)

    # -- epoch invalidation ----------------------------------------------------

    def invalidate_epoch(self, current_epoch: str) -> int:
        """Drop entries pinned to a DIFFERENT storage generation.  The
        epoch is token component 0, so a dead generation can never be
        served even without this call — eager dropping frees the budget
        (same contract as :meth:`CatchupResultCache.invalidate_epoch`,
        including the one-live-store-per-cache caveat)."""
        with self._lock:
            if current_epoch == self._last_epoch:
                return 0
            self._last_epoch = current_epoch
            stale = [k for k in self._entries if k[0] != current_epoch]
            for key in stale:
                dropped = self._entries.pop(key)
                self._bytes -= dropped.nbytes
                self.counters.bump("invalidations")
        return len(stale)
