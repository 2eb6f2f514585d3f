"""The catch-up service's cache tiers 1 and 0 (the port's copies of
``CatchupResultCache`` with ``CachedFold`` / ``_Flight``, and of
``DeltaExportCache`` with ``_DeltaEntry`` and ``tree_nbytes``, from
``fluidframework_tpu/service/catchup_cache.py``).

Tier 1, the seq-anchored result cache: folded summaries keyed ``(storage
epoch, doc id, base summary digest, base ref_seq, tail head seq)``.  The
op log is append-only and the summary store content-addressed, so within
one storage generation that tuple pins the fold's exact input and a
cached tree is byte-identical to a fresh fold.  Concurrent requests for
one key collapse to one fold (single-flight): the first caller
``begin()``s and leads, the others ``join()`` and wait for its
``finish()``.  No wall-clock: recency is an LRU over dict insertion order.

Tier 0, the digest-gated delta download: the pipeline (``ops/pipeline.py``)
asks the fold for a per-document state digest, fetches only that
``[D, 2]`` plane eagerly, and downloads and extracts only the documents
whose digest changed; unchanged documents serve their cached summaries
byte-identically.

The streaming fold's ``StreamHeadIndex``: per document, the newest
summary the streaming fold has published, ``(handle, ref_seq)`` pinned to
a storage epoch; lag is measured in sequence numbers.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Optional, Tuple

from ..protocol.summary import SummaryBlob, SummaryTree
from ..utils.telemetry import CounterSet

#: default bound for join(): a crashed leader must never hang a follower
#: forever, even at call sites that never thought about timeouts
#: (CatchupService.JOIN_TIMEOUT carries the same value; the
#: Catchup.JoinTimeout gate overrides it per service).  Pass
#: timeout=None explicitly to wait unbounded.
DEFAULT_JOIN_TIMEOUT = 60.0

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


class CachedFold(NamedTuple):
    """A served cache entry: the folded tree plus its handle, digested
    ONCE at publish time — a hit is a dict lookup, never a Merkle walk."""

    tree: SummaryTree
    handle: str


class _Flight:
    """One in-flight fold: the leader publishes, waiters block on the
    event and read the result (None = leader abandoned; waiters retry)."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.result: Optional[CachedFold] = None


class CatchupResultCache:
    """Byte-bounded LRU of folded catch-up summaries with single-flight.

    All mutation happens under one lock; ``join()`` waits outside it.
    Counters: ``hits`` / ``misses`` (lookup outcomes), ``inserts`` /
    ``evictions`` (LRU churn), ``waits`` (single-flight joins that
    blocked on a leader), ``invalidations`` (epoch drops).
    """

    def __init__(self, max_bytes: int = 256 << 20) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # dict insertion order IS the LRU order (touch = delete+reinsert).
        self._entries: Dict[tuple, Tuple[CachedFold, int]] = {}  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._flights: Dict[tuple, _Flight] = {}  # guarded-by: _lock
        self._last_epoch: Optional[str] = None  # guarded-by: _lock (invalidate fast path)
        self.counters = CounterSet(
            "hits", "misses", "inserts", "evictions", "waits",
            "invalidations",
        )  # guarded-by: _lock (CounterSet is not internally synchronized)

    # -- introspection ---------------------------------------------------------

    @property
    def current_bytes(self) -> int:
        # Under the lock (fluidrace FL-RACE-GUARD): `_bytes` is adjusted
        # in multi-step insert/evict sequences — an unlocked read could
        # observe a torn mid-eviction value.
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = self.counters.snapshot()
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
        return out

    # -- plain lookup/insert ---------------------------------------------------

    def lookup(self, key: tuple) -> Optional[CachedFold]:
        """Cached (tree, handle) for ``key`` (LRU-touched), or None."""
        with self._lock:
            found = self._get_locked(key)
            self.counters.bump("hits" if found is not None else "misses")
            return found

    def _get_locked(self, key: tuple) -> Optional[CachedFold]:
        """Uncounted fetch + LRU touch.  Counting discipline: ``hits``
        bump wherever an entry is served; ``misses`` bump ONLY at the
        authoritative claim point (``begin``/``lookup``) — ``join`` is a
        probe and counting its empty result too would double-count every
        doc that probes first and claims right after."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        # Touch: move to the back of the insertion order.
        del self._entries[key]
        self._entries[key] = entry
        return entry[0]

    def insert(self, key: tuple, tree: SummaryTree) -> CachedFold:
        with self._lock:
            return self._insert_locked(key, tree)

    def _insert_locked(self, key: tuple, tree: SummaryTree) -> CachedFold:
        # Digest ONCE here, at publish time — every later hit serves the
        # stored handle instead of re-walking the tree.
        fold = CachedFold(tree, tree.digest())
        nbytes = tree_nbytes(tree)
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old[1]
        if nbytes > self.max_bytes:
            # Never admit an entry the budget cannot hold: admitting it
            # would evict the whole cache for a single un-keepable tree.
            self.counters.bump("evictions")
            return fold
        self._entries[key] = (fold, nbytes)
        self._bytes += nbytes
        self.counters.bump("inserts")
        while self._bytes > self.max_bytes and self._entries:
            oldest = next(iter(self._entries))
            _fold, n = self._entries.pop(oldest)
            self._bytes -= n
            self.counters.bump("evictions")
        return fold

    # -- single-flight ---------------------------------------------------------

    def begin(self, key: tuple):
        """Claim a key: ``("hit", CachedFold)`` when cached, else
        ``("lead", None)`` — the caller is now the leader and MUST
        ``finish`` or ``abandon`` the key (use try/finally).  A second
        ``begin`` for a key already in flight also leads (callers
        serialized by the catch-up lock re-claim after an abandon);
        waiters use :meth:`join`."""
        with self._lock:
            found = self._get_locked(key)
            if found is not None:
                self.counters.bump("hits")
                return "hit", found
            self.counters.bump("misses")
            self._flights.setdefault(key, _Flight())
            return "lead", None

    def finish(self, key: tuple, tree: SummaryTree) -> CachedFold:
        """Leader publishes: insert into the LRU and wake every waiter.
        Returns the (tree, handle) pair so the leader reuses the one
        digest computed at insert."""
        with self._lock:
            fold = self._insert_locked(key, tree)
            flight = self._flights.pop(key, None)
        if flight is not None:
            flight.result = fold
            flight.done.set()
        return fold

    def abandon(self, key: tuple) -> None:
        """Leader failed: wake waiters empty-handed (they retry or fold
        themselves).  Safe on a key that was already finished."""
        with self._lock:
            flight = self._flights.pop(key, None)
        if flight is not None:
            flight.done.set()

    def join(self, key: tuple,
             timeout: Optional[float] = DEFAULT_JOIN_TIMEOUT,
             reap_on_timeout: bool = True) -> Optional[CachedFold]:
        """Wait-or-read: the cached (tree, handle); else, when a leader
        is in flight, block until it publishes and return its result
        (None if it abandoned or ``timeout`` elapsed); else None
        immediately.

        With ``reap_on_timeout`` (the default), a timeout presumes the
        leader crashed without reaching its finally-abandon: the flight
        is removed — only if it is still THE flight this caller waited
        on, so a fresh leader's flight is never popped — and its event
        set, waking every other waiter stuck on the dead leader (they
        retry or fold themselves).  A merely-slow leader losing its
        flight is benign: ``finish`` on a popped flight still publishes
        to the LRU.  Callers waiting a DELIBERATELY short bound (the
        server's warm priority lane giving up and taking the admission
        fold lane instead) pass ``reap_on_timeout=False`` — an impatient
        reader must not tear down a live leader's flight."""
        with self._lock:
            found = self._get_locked(key)
            if found is not None:
                self.counters.bump("hits")
                return found
            flight = self._flights.get(key)
            if flight is None:
                return None  # probe only: begin() counts the miss
            self.counters.bump("waits")
        if not flight.done.wait(timeout):
            if reap_on_timeout:
                self._reap_flight(key, flight)
            return None
        return flight.result

    def _reap_flight(self, key: tuple, flight: _Flight) -> None:
        """A waiter timed out: presume the leader crashed without its
        finally-abandon and remove the flight — one critical section,
        identity-guarded: the re-validation pops the flight only if it is
        still THE object this waiter waited on, so a fresh leader's
        flight is never reaped (pinned by
        test_join_timeout_pop_is_identity_guarded)."""
        with self._lock:
            if self._flights.get(key) is flight:
                self._flights.pop(key)
                # set() only for the flight this caller reaped: when the
                # guard fails, whoever popped it (finish/abandon/another
                # reaper) sets the event once the result is in place —
                # setting it here would wake the other waiters to
                # result=None on a COMPLETED fold.
                flight.done.set()

    # -- epoch invalidation ----------------------------------------------------

    def invalidate_epoch(self, current_epoch: str) -> int:
        """Drop every entry pinned to a DIFFERENT storage generation.
        The epoch is key component 0, so stale generations can never be
        served even without this call — eager dropping just frees the
        budget the moment the store is recreated.  Returns entries
        dropped.  O(1) while the epoch is unchanged (the hot serving
        loop calls this per request; the full scan runs only on an
        actual generation change).  Callers sharing one cache must all
        serve the SAME store: this treats every other epoch as dead, so
        two live stores alternating here would evict each other."""
        with self._lock:
            if current_epoch == self._last_epoch:
                return 0
            self._last_epoch = current_epoch
            stale = [k for k in self._entries if k[0] != current_epoch]
            for key in stale:
                _tree, n = self._entries.pop(key)
                self._bytes -= n
                self.counters.bump("invalidations")
        return len(stale)


# ---------------------------------------------------------------------------
# Tier 0: digest-gated delta-download cache
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Streaming-head publication index
# ---------------------------------------------------------------------------


class StreamHeadIndex:
    """The streaming fold's published-summary index: per document, the
    NEWEST summary the streaming fold has durably published — ``(handle,
    ref_seq)``, pinned to a storage epoch.  Unlike the byte-bounded
    tiers, this is a tiny unbounded map (one tuple per live document):
    its job is bookkeeping, not caching — the server's streaming-head
    serve lane and the truncation cut both read it, and the lag gates
    (``stream_lag_max``) are computed against it.

    All mutation under one lock; no wall-clock anywhere (lag is measured
    in SEQUENCE NUMBERS — head seq minus published ref_seq — so replay
    runs report identical lag).  ``publish`` is monotone per document
    within an epoch: a stale ref_seq (an out-of-order worker) never
    regresses the index.  Counters: ``publishes`` (accepted),
    ``regressions`` (stale publishes ignored), ``invalidations``
    (epoch drops)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[str, int]] = {}  # guarded-by: _lock
        self._epoch: Optional[str] = None  # guarded-by: _lock
        self._lag_max = 0  # guarded-by: _lock (high-water, seqs)
        self.counters = CounterSet(
            "publishes", "regressions", "invalidations",
        )  # guarded-by: _lock

    def publish(self, doc_id: str, handle: str, ref_seq: int,
                epoch: str) -> bool:
        """Record a durably published summary.  A first publish in a new
        epoch sweeps the old generation (same one-live-store contract as
        the cache tiers).  Returns False for a non-advancing ref_seq."""
        with self._lock:
            if epoch != self._epoch:
                if self._entries:
                    self.counters.bump("invalidations", len(self._entries))
                    self._entries.clear()
                self._epoch = epoch
                self._lag_max = 0
            old = self._entries.get(doc_id)
            if old is not None and old[1] >= ref_seq:
                self.counters.bump("regressions")
                return False
            self._entries[doc_id] = (handle, ref_seq)
            self.counters.bump("publishes")
            return True

    def get(self, doc_id: str, epoch: str) -> Optional[Tuple[str, int]]:
        """The published ``(handle, ref_seq)`` for ``doc_id`` in the
        CURRENT epoch, else None (a dead generation is never served)."""
        with self._lock:
            if epoch != self._epoch:
                return None
            return self._entries.get(doc_id)

    def published_ref_seq(self, doc_id: str) -> int:
        """The newest published ref_seq (0 when never published) — the
        truncation cut's summary anchor."""
        with self._lock:
            entry = self._entries.get(doc_id)
            return entry[1] if entry is not None else 0

    def observe_lag(self, doc_id: str, head_seq: int) -> int:
        """Record (and return) this document's current lag in sequence
        numbers: committed head minus newest published ref_seq.  Feeds
        the ``stream_lag_max`` high-water gate."""
        with self._lock:
            entry = self._entries.get(doc_id)
            lag = max(0, int(head_seq) - (entry[1] if entry else 0))
            if lag > self._lag_max:
                self._lag_max = lag
            return lag

    def invalidate_epoch(self, current_epoch: str) -> int:
        """Eager sweep on a storage generation change (parity with the
        cache tiers' contract)."""
        with self._lock:
            if current_epoch == self._epoch:
                return 0
            dropped = len(self._entries)
            self._entries.clear()
            self._epoch = current_epoch
            self._lag_max = 0
            if dropped:
                self.counters.bump("invalidations", dropped)
        return dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = self.counters.snapshot()
            out["entries"] = len(self._entries)
            out["lag_max"] = self._lag_max
        return out
