"""Chunked, pipelined bulk catch-up replay on the card: the port of the
reference's product path, ``fluidframework_tpu/ops/pipeline.py``
(``pipelined_mergetree_replay``, the family-generic
``pipelined_family_replay``).

Shape (as the reference's):

- documents are chunked (``chunk_docs``) so shapes stay bucketed and
  transfers bounded;
- chunks are fact-scheduled (annotate-free documents grouped first);
  results return in the CALLER's order regardless;
- packing (C++, GIL released) and the upload narrowing run in a thread
  pool, extraction (widen + C++ bodies) in another, a chunk cut into
  document slices that run as tasks of their own (once every chunk of
  the call is packed, the pack pool's idle workers take slices too); a
  chunk whose family can pack it by document ranges (``slice_pack``: the
  native record packs of string streams, tree and matrix records) is cut
  into ranges on both pools' workers,
  driven from a third pool whose threads intern and join; ALL
  device interaction — upload, dispatch, starting the d2h copy, the
  waits — stays on the calling thread (the reference's
  single-device-thread contract);
- the blocking fetch trails the dispatch front by ``fetch_depth`` chunks,
  so upload, fold and download of neighbouring chunks overlap: each
  dispatch records an event on the compute stream, and the chunk's d2h
  copy runs on a dedicated copy stream behind that event into pinned host
  buffers (``DeviceExport``);
- oracle-fallback documents route around the device exactly like
  ``replay_mergetree_batch`` (shared ``partition_replay`` + post-fold
  overflow handling inside ``summaries_from_export``).

The stage schema is the reference's: busy seconds under
``pack/upload/dispatch/device_wait/download/extract`` plus the byte
counters ``h2d_bytes``/``d2h_bytes``.  ``upload`` times the explicit
host-to-device copies (the reference's upload rides inside its dispatch
call, so its ``upload`` reads 0 without the device-resident tier).  The
port adds ``HOST_CPU_KEYS``: the pool legs' thread CPU seconds beside
their wall seconds, and the counters ``extract_tasks``: the extract tasks
submitted (a chunk's slices), and ``pack_tasks``: the pack tasks each
chunk ran (1, or its ranges).  While a ``torch.profiler`` session runs,
the calling thread's legs are spans (``pipeline.<leg>``, and
``pipeline.replay``, ``pipeline.wait_pack``, ``pipeline.wait_extract``
around the whole call and its waits on the pools), on the clock of the
trace's device events.

The catch-up cache tiers ride the same loop, as in the reference:

- tier 2, :class:`PackCache` — packed windows reused across calls (exact
  hit: no pack work; suffix hit: only the new rows packed onto copies);
- tier 2.5, ``ops/device_cache.DevicePackCache`` (``device_cache``) —
  packed chunks kept resident on the device: an exact hit uploads
  nothing, a suffix hit uploads only the new rows and splices them into
  the resident planes in place (``ops/resident_cuda.splice_rows``);
  ``pin_resident`` pins what a call serves into its resident-state tier;
- tier 0, ``service/catchup_cache.DeltaExportCache`` (``delta_cache``) —
  the fold also writes a per-document state digest; only that ``[D, 2]``
  plane is copied at dispatch, and only documents whose digest moved are
  gathered and downloaded (``delta_route``), the rest serve their cached
  summaries.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from time import perf_counter, thread_time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..convert import tensors_to
from ..utils.telemetry import CounterSet, span
from .batching import partition_replay
from .family import KernelFamily
from .interning import Interner, next_bucket_fine
from .mergetree_kernel import (
    I8_LIMIT,
    I16_LIMIT,
    K_INSERT,
    K_NOOP,
    K_OBLITERATE,
    MTOps,
    MergeTreeDocInput,
    NOT_REMOVED,
    _DocPack,
    export_to_numpy,
    fill_sequence_op_rows,
    gather_export_rows,
    known_oracle_fallback,
    narrow_ops_for_upload,
    narrow_state_for_upload,
    oracle_fallback_summary,
    pack_mergetree_batch,
    replay_export,
    resolve_device,
    slice_mergetree_pack,
    split_export_digest,
    summaries_from_export,
)
from .parts import Parts, map_leaves

# ---------------------------------------------------------------------------
# Pack cache (tier 2 of the catch-up cache): packed-chunk reuse
# ---------------------------------------------------------------------------


def _copy_interner(src: Interner) -> Interner:
    out = Interner()
    out._by_key = dict(src._by_key)
    out.values = list(src.values)
    return out


def _copy_doc_pack(pack):
    out = _DocPack()
    out.clients = _copy_interner(pack.clients)
    out.interval_ops = list(pack.interval_ops)
    out.needs_fallback = pack.needs_fallback
    return out


#: monotone pack-generation ids — the lineage tokens tier 2 stamps into
#: ``meta["_pack_lineage"]`` so the device-resident tier (tier 2.5,
#: ops/device_cache.py) can PROVE a set of host arrays is the literal
#: suffix-extension of what it holds resident.  itertools.count.__next__
#: is atomic under CPython, so the stamp needs no extra locking.  ONE
#: counter across every family, so a generation id never collides
#: between two families' caches.
_PACK_GEN = itertools.count(1)


class _PackEntry:
    """One cached packed window: the wide (pre-narrow) chunk arrays plus
    the per-doc window bookkeeping needed to match and extend it."""

    __slots__ = ("tokens", "n_ops", "first_seq", "last_seq", "t_rows",
                 "state", "ops", "meta", "nbytes", "gen")

    def __init__(self, tokens, n_ops, first_seq, last_seq, t_rows,
                 state, ops, meta, nbytes, gen=0):
        self.gen = gen
        self.tokens = tokens
        self.n_ops = n_ops
        self.first_seq = first_seq
        self.last_seq = last_seq
        self.t_rows = t_rows
        self.state = state
        self.ops = ops
        self.meta = meta
        self.nbytes = nbytes


def _doc_window(doc):
    n = len(doc.ops)
    if n == 0:
        return 0, 0, 0
    return n, doc.ops[0].seq, doc.ops[-1].seq


def match_windows(n_ops, first_seq, last_seq, chunk) -> Optional[str]:
    """THE window-matching rule shared by tier 2 (:class:`PackCache`)
    and tier 2.5 (``ops/device_cache.DevicePackCache``), for EVERY
    family (both carry ascending-seq message lists): "exact" when every
    doc's op window is unchanged vs the cached per-doc
    ``(n_ops, first_seq, last_seq)``, "suffix" when every window
    extends its cached one (same first seq, the old tail still in
    place, any new rows strictly past it — same-seq rows only ever
    arrive inside one sequenced message, which the cached window
    already held in full), else None.  One derivation point: the two
    tiers deciding differently would let resident device buffers
    disagree with the packed host arrays they mirror."""
    exact = True
    for d, doc in enumerate(chunk):
        n, first, _last = _doc_window(doc)
        cached_n = n_ops[d]
        if n < cached_n:
            return None
        if cached_n:
            if first != first_seq[d] \
                    or doc.ops[cached_n - 1].seq != last_seq[d]:
                return None
            if n > cached_n and doc.ops[cached_n].seq <= last_seq[d]:
                return None
        if n != cached_n:
            exact = False
    return "exact" if exact else "suffix"


class PackCache:
    """Suffix-aware cache of packed chunk outputs — tier 2 of the
    catch-up cache, attacking the pack leg of the host side.
    Family-generic: the default instance serves ``pack_mergetree_batch``
    windows; window matching, lineage stamping, LRU, and locking are THIS
    class, while packing/extension go through the family hooks.

    Chunks are keyed by the ordered tuple of per-doc ``cache_token``s
    (doc + base summary + storage generation identity, supplied by the
    catch-up service); any doc without a token — or any doc the family
    marks ``bypass`` (e.g. binary-stream docs, whose C++ pack is already
    the fast path) — bypasses the cache.

    Three outcomes per chunk:

    - **exact**: every doc's op window is unchanged → the cached arrays
      are returned as-is (zero pack work; only the meta's ``docs`` are
      re-pointed so extraction reads fresh ``final_seq``/``final_msn``).
    - **suffix**: every doc's window extends the cached one (same first
      seq, tail grew — the append-only op log guarantees the shared
      prefix is byte-identical under an equal token) → the family's
      ``extend`` packs ONLY the new suffix rows onto copies of the
      cached arrays, provided the chunk's shape buckets hold; any
      violation just falls back to a full repack — never corrupts.
    - **miss**: a full family pack whose result is cached.

    Extraction-side summaries are byte-identical in all three cases
    (pinned by tests): intern ids may differ from a fresh pack's, but
    ids never reach the summary bytes — everything resolves through the
    chunk's own tables.

    Thread-safe: lookups/stores lock, and suffix extensions serialize on
    their own mutex (they append to an entry's shared arena/interner);
    full packs and exact hits run lock-free.
    """

    def __init__(self, max_bytes: int = 192 << 20,
                 family: Optional[KernelFamily] = None) -> None:
        self.family = family if family is not None else MERGETREE_FAMILY
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # Serializes suffix extension: extend appends to the cached
        # entry's SHARED arena and value interner (append-only, so
        # readers are safe, but two concurrent extends of the same entry
        # would interleave writes).  Extends are the rare path — one
        # mutex for all of them costs nothing and makes the thread-safety
        # claim unconditional instead of relying on callers never
        # sharing a token tuple across concurrent pack() calls.
        self._extend_lock = threading.Lock()
        # tokens -> _PackEntry (insertion order = LRU order)
        self._entries: dict = {}  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self.counters = CounterSet(
            "exact_hits", "suffix_hits", "misses", "bypass", "inserts",
            "evictions",
        )  # guarded-by: _lock (CounterSet is not internally synchronized)

    def stats(self) -> dict:
        with self._lock:
            out = self.counters.snapshot()
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
        return out

    # -- public entry point ----------------------------------------------------

    def pack(self, chunk):
        """(state, ops, meta) for ``chunk`` — cached, suffix-extended, or
        freshly packed."""
        family = self.family
        tokens = tuple(d.cache_token for d in chunk)
        if any(t is None for t in tokens) \
                or any(family.bypass(d) for d in chunk):
            with self._lock:
                self.counters.bump("bypass")
            return family.pack(chunk)
        with self._lock:
            entry = self._entries.get(tokens)
        if entry is not None:
            kind = self._match(entry, chunk)
            if kind == "exact":
                with self._lock:
                    self._touch(tokens)
                    self.counters.bump("exact_hits")
                return entry.state, entry.ops, dict(
                    entry.meta, docs=list(chunk),
                    _pack_lineage=("exact", entry.gen))
            if kind == "suffix" and family.extend is not None:
                parent_gen = entry.gen
                with self._extend_lock:
                    extended = family.extend(entry, chunk)
                if extended is not None:
                    state, ops, meta = extended
                    gen = self._store(tokens, chunk, state, ops, meta)
                    # The lineage stamp: these arrays are the literal
                    # extension of generation ``parent_gen`` — the
                    # device-resident tier's suffix-splice license.
                    meta["_pack_lineage"] = ("suffix", parent_gen, gen)
                    with self._lock:
                        self.counters.bump("suffix_hits")
                    return state, ops, meta
        with self._lock:
            self.counters.bump("misses")
        state, ops, meta = family.pack(chunk)
        gen = self._store(tokens, chunk, state, ops, meta)
        meta["_pack_lineage"] = ("full", gen)
        return state, ops, meta

    # -- bookkeeping -----------------------------------------------------------

    def _touch(self, tokens) -> None:  # holds-lock: _lock
        entry = self._entries.pop(tokens, None)
        if entry is not None:
            self._entries[tokens] = entry

    def _store(self, tokens, chunk, state, ops, meta) -> int:
        """Insert/replace the entry; returns its pack generation (fresh
        even when the byte budget refuses the entry — the lineage stamp
        must still be unique per produced array set)."""
        n_ops, first_seq, last_seq = [], [], []
        for doc in chunk:
            n, first, last = _doc_window(doc)
            n_ops.append(n)
            first_seq.append(first)
            last_seq.append(last)
        t_rows = list(self.family.entry_rows(chunk, meta))
        # The stored meta never serves extraction directly — both the
        # exact-hit and suffix paths re-point ``docs`` at the fresh chunk
        # — so drop the doc inputs (and with them the per-op Python
        # message lists, the dominant retained memory the byte budget
        # would otherwise silently under-count).
        gen = next(_PACK_GEN)
        entry = _PackEntry(tokens, n_ops, first_seq, last_seq, t_rows,
                           state, ops, dict(meta, docs=None),
                           self.family.entry_nbytes(state, ops, meta),
                           gen=gen)
        with self._lock:
            old = self._entries.pop(tokens, None)
            if old is not None:
                self._bytes -= old.nbytes
            if entry.nbytes > self.max_bytes:
                self.counters.bump("evictions")
                return gen
            self._entries[tokens] = entry
            self._bytes += entry.nbytes
            self.counters.bump("inserts")
            while self._bytes > self.max_bytes and self._entries:
                oldest = next(iter(self._entries))
                dropped = self._entries.pop(oldest)
                self._bytes -= dropped.nbytes
                self.counters.bump("evictions")
        return gen

    @staticmethod
    def _match(entry: _PackEntry, chunk) -> Optional[str]:
        return match_windows(entry.n_ops, entry.first_seq,
                             entry.last_seq, chunk)


# ---------------------------------------------------------------------------
# Merge-tree tier-2 suffix extension (the family's ``extend`` hook)
# ---------------------------------------------------------------------------


def _extend_mergetree(entry: _PackEntry, chunk):
    """Pack only each doc's suffix ops on top of the cached arrays;
    None = shape/bucket constraints do not hold (caller full-packs)."""
    meta = entry.meta
    T = entry.ops.kind.shape[1]
    S = int(meta["_S"])
    K = int(meta["props_K"])
    key_ids = {k: i for i, k in enumerate(meta["prop_keys"])}
    # Pre-scan (no shared state touched): per-doc text-op counts and
    # the suffix's new property keys, so every bucket check happens
    # before any mutation.
    new_t_counts, suffixes = [], []
    new_keys = []
    for d, doc in enumerate(chunk):
        suffix = doc.ops[entry.n_ops[d]:]
        suffixes.append(suffix)
        t_count = entry.t_rows[d]
        for msg in suffix:
            contents = msg.contents
            if contents["kind"].startswith("interval"):
                continue
            t_count += 1
            for key in (contents.get("props") or {}):
                if key not in key_ids and key not in new_keys:
                    new_keys.append(key)
        new_t_counts.append(t_count)
    if len(key_ids) + len(new_keys) > K:
        return None  # props bucket would grow: repack
    if next_bucket_fine(max(max(new_t_counts), 1), floor=16) != T:
        return None  # op-row bucket would grow
    base_counts = [int(n) for n in np.asarray(entry.state.n)]
    s_need = max(bc + 2 * tc
                 for bc, tc in zip(base_counts, new_t_counts))
    if next_bucket_fine(max(s_need, 1), floor=32) != S:
        return None  # slot bucket would grow
    for key in new_keys:
        key_ids[key] = len(key_ids)

    # Commit: copy the op arrays (the cached entry must stay intact),
    # share the append-only arena/value interner and the untouched
    # base state, and fill only the suffix rows.
    op = {f: np.copy(getattr(entry.ops, f)) for f in MTOps._fields}
    arena = meta["arena"]
    values: Interner = meta["values"]
    doc_packs = [_copy_doc_pack(p) for p in meta["doc_packs"]]
    try:
        _fill_mergetree_suffixes(chunk, suffixes, entry, op, arena,
                                 values, doc_packs, key_ids)
    except ValueError:
        # An op shape this fill doesn't know (drift vs
        # pack_mergetree_batch's row fill) must degrade to a full
        # pack — which raises the same error if the op is genuinely
        # malformed — never crash only-when-warm.  The arena/interner
        # appends already made are unreferenced and harmless.
        return None
    new_meta = dict(
        meta,
        docs=list(chunk),
        doc_packs=doc_packs,
        prop_keys=sorted(key_ids, key=key_ids.__getitem__),
    )
    _refresh_mergetree_facts(entry.state, op, new_meta, chunk)
    return entry.state, MTOps(**op), new_meta


def _fill_mergetree_suffixes(chunk, suffixes, entry, op, arena, values,
                             doc_packs, key_ids) -> None:
    # THE shared row fill (mergetree_kernel.fill_sequence_op_rows) —
    # byte-drift between fresh and suffix-cached packs is impossible
    # by construction.
    for d, doc in enumerate(chunk):
        pack = doc_packs[d]
        if known_oracle_fallback(doc):
            pack.needs_fallback = True
        fill_sequence_op_rows(op, d, entry.t_rows[d] - 1, suffixes[d],
                              pack, arena, key_ids.__getitem__, values)


def _refresh_mergetree_facts(state, op, meta, chunk) -> None:
    """Re-derive the chunk facts over the COMBINED arrays — same
    predicates as ``pack_mergetree_batch``, except the i16 text bound
    checks the actual per-doc rebased span ends (suffix text is not
    contiguous with the doc's original arena span)."""
    doc_base = np.asarray(meta["doc_base"], np.int32)
    S = int(meta["_S"])
    is_ins = op["kind"] == K_INSERT
    op_end = np.where(
        is_ins, op["tstart"] + op["tlen"] - doc_base[:, None], 0
    )
    live = np.arange(state.tstart.shape[1],
                     dtype=np.int32)[None, :] < np.asarray(
                         state.n)[:, None]
    st_end = np.where(
        live,
        np.asarray(state.tstart) + np.asarray(state.tlen)
        - doc_base[:, None],
        0,
    )
    max_off = max(int(op_end.max(initial=0)),
                  int(st_end.max(initial=0)))
    max_seq = max(
        int(op["seq"].max(initial=0)),
        max((d.final_seq for d in chunk), default=0),
        max((d.base_seq for d in chunk), default=0),
    )
    max_clients = max(
        (len(p.clients) for p in meta["doc_packs"]), default=0
    )
    n_values = len(meta["values"])
    meta["i16_ok"] = (
        max_seq < I16_LIMIT and max_off < I16_LIMIT and S < I16_LIMIT
        and n_values < I16_LIMIT and max_clients < I16_LIMIT
    )
    real_ops = op["kind"] != K_NOOP
    max_tlen = max(int(op["tlen"].max(initial=0)),
                   int(np.asarray(state.tlen).max(initial=0)))
    meta["i8_ok"] = (
        meta["i16_ok"] and max_seq < I8_LIMIT and max_tlen < I8_LIMIT
        and n_values < I8_LIMIT and max_clients < I8_LIMIT
    )
    sequential = not bool(
        (real_ops & (op["ref_seq"] != op["seq"] - 1)).any()
    )
    meta["sequential"] = sequential
    meta["ob_rows"] = bool(
        (np.asarray(state.ob1_seq) != NOT_REMOVED).any()
        or (op["kind"] == K_OBLITERATE).any()
    )
    meta["ov_rows"] = bool(
        (np.asarray(state.rem2_client) >= 0).any()
    ) or not sequential
    meta["has_props"] = len(meta["prop_keys"]) > 0


# -- tier-0 delta-download routing: ONE derivation point --------------------
# The byte-identity-critical cache logic (serve gate, entry publication,
# the changed-rows sub-meta) lives here once, for every family.


def delta_route(docs, dig_np, delta_cache):
    """The per-chunk tier-0 decision after the digest plane arrived:
    ``("full", {}, None)`` — nothing servable, the cold/fallback/oracle
    route; ``("served", served, None)`` — every document serves without
    a download; ``("partial", served, changed)`` — only ``changed``
    positions' rows must cross."""
    served = (delta_cache.serve_many(docs, dig_np)
              if delta_cache.any_candidate(docs) else {})
    if not served:
        return "full", served, None
    if len(served) == len(docs):
        return "served", served, None
    return "partial", served, [d for d in range(len(docs))
                               if d not in served]


def delta_store_all(delta_cache, docs, dig_np, trees) -> None:
    """(Re)publish every document's tier-0 entry — the cold-fill leg."""
    delta_cache.put_many(
        (doc, (int(dig_np[d, 0]), int(dig_np[d, 1])), trees[d])
        for d, doc in enumerate(docs))


def delta_sub_meta(meta, changed,
                   per_doc: Sequence[str] = ("doc_base",)) -> dict:
    """The per-doc meta rows of only the CHANGED positions (the gathered
    rows' extraction view); chunk-global meta passes through.
    ``per_doc`` names the family's per-doc ndarray meta entries that
    must slice alongside ``docs``/``doc_packs``."""
    docs = meta["docs"]
    rows = np.asarray(changed, np.intp)
    out = dict(
        meta,
        docs=[docs[d] for d in changed],
        doc_packs=[meta["doc_packs"][d] for d in changed],
    )
    for key in per_doc:
        if key in meta:
            out[key] = np.asarray(meta[key])[rows]
    return out


def delta_merge_changed(delta_cache, meta, dig_np, served, changed, got):
    """Served trees + freshly extracted changed trees → the chunk's
    result list, publishing the changed documents' new tier-0 entries."""
    docs = meta["docs"]
    res: List = [None] * len(docs)
    for d, tree in served.items():
        res[d] = tree
    for d, tree in zip(changed, got):
        res[d] = tree
    delta_cache.put_many(
        (docs[d], (int(dig_np[d, 0]), int(dig_np[d, 1])), tree)
        for d, tree in zip(changed, got))
    return res


# ---------------------------------------------------------------------------
# Stage accounting
# ---------------------------------------------------------------------------


#: THE stage schema, identical for every family (the byte counters ride as
#: ints next to the busy seconds)
STAGE_KEYS = ("pack", "upload", "dispatch", "device_wait", "download",
              "extract")

#: the port's twins of the host legs ``pack`` / ``extract``: thread CPU
#: seconds over the same intervals, summed over the threads that ran
#: them; wall minus CPU is the time the leg's threads were off the CPU
#: (waiting for the interpreter lock or for a core)
HOST_CPU_KEYS = ("pack_cpu", "extract_cpu")

#: counts an extract task returns beside its ``stats`` that belong to the
#: stage: ``extract_nodes``, the forest nodes a tree extraction wrote into
#: summaries, and ``extract_native_docs``, the documents whose header the
#: tree family's native writer wrote (both 0 for merge-tree)
EXTRACT_STAGE_COUNTS = ("extract_nodes", "extract_native_docs")
#: counts that belong to the stage and that one family alone keeps, so the
#: schema does not seed them: ``extract_cells``, the cells a matrix
#: extraction wrote into summaries, and ``resolve_rows``, the matrix
#: fold's resolve rows a chunk dispatched (its meta's ``resolve_rows``)
FAMILY_STAGE_COUNTS = ("extract_cells", "resolve_rows")


def merge_extract_counts(st: dict, stats: Optional[dict],
                         stage: Optional[dict]) -> None:
    """Add one extract task's counts: ``EXTRACT_STAGE_COUNTS`` and
    ``FAMILY_STAGE_COUNTS`` to ``stage``, the rest to ``stats``."""
    for k, v in st.items():
        into = stage if k in EXTRACT_STAGE_COUNTS \
            or k in FAMILY_STAGE_COUNTS else stats
        if into is not None:
            into[k] = into.get(k, 0) + v


def seed_stage(stage: Optional[dict]) -> None:
    """Pre-seed the full stage schema so every fold reports the SAME keys
    (a leg that never ran reads 0, instead of being absent)."""
    if stage is None:
        return
    for key in STAGE_KEYS + HOST_CPU_KEYS:
        stage.setdefault(key, 0.0)
    stage.setdefault("h2d_bytes", 0)
    stage.setdefault("d2h_bytes", 0)
    stage.setdefault("extract_tasks", 0)
    stage.setdefault("pack_tasks", 0)
    for key in EXTRACT_STAGE_COUNTS:
        stage.setdefault(key, 0)


@contextlib.contextmanager
def _leg(stage: Optional[dict], key: str):
    """One leg on the calling thread, inside the span ``pipeline.<key>``:
    its wall seconds go to ``stage[key]`` and, for ``pack`` / ``extract``,
    its thread CPU seconds to the ``_cpu`` twin."""
    cpu = key + "_cpu" in HOST_CPU_KEYS
    t0, c0 = perf_counter(), (thread_time() if cpu else 0.0)
    with span("pipeline." + key):
        yield
    if stage is not None:
        _add_leg(stage, key, perf_counter() - t0,
                 thread_time() - c0 if cpu else None)


def _add_leg(stage: Optional[dict], key: str, wall: float,
             cpu: Optional[float] = None) -> None:
    """Add a leg's wall seconds (and its CPU twin's, if given)."""
    if stage is not None:
        stage[key] = stage.get(key, 0.0) + wall
        if cpu is not None:
            stage[key + "_cpu"] = stage.get(key + "_cpu", 0.0) + cpu


def _count_d2h(stage: Optional[dict], nbytes: int) -> None:
    """Accumulate the bytes fetched over the d2h link this call."""
    if stage is not None:
        stage["d2h_bytes"] = stage.get("d2h_bytes", 0) + int(nbytes)


def _count_h2d(stage: Optional[dict], nbytes: int) -> None:
    """The upload-side twin of :func:`_count_d2h`: bytes of pack data this
    call pushed over the h2d link."""
    if stage is not None:
        stage["h2d_bytes"] = stage.get("h2d_bytes", 0) + int(nbytes)


def _nbytes(handle) -> int:
    """Byte size of a buffer (or tuple of buffers) from shape metadata."""
    leaves = handle if isinstance(handle, tuple) else (handle,)
    return int(sum(leaf.nbytes for leaf in leaves))


def _np_nbytes(tree) -> int:
    """Bytes of the NUMPY leaves of a state/ops tree: what the upload leg
    pushes over the h2d link."""
    if tree is None:
        return 0
    return int(sum(leaf.nbytes for leaf in tree
                   if isinstance(leaf, np.ndarray)))


class _HostSlots:
    """Pinned host buffers for the d2h copies, reused round robin.

    A slot holds one flat pinned buffer per export leaf; a chunk's numpy
    views into it go to the extract pool, and the slot is released when
    that chunk's extraction is collected (on the calling thread).  So no
    pinned memory is allocated per chunk, and none is freed on a worker
    thread: a buffer that has to grow is retired and freed on ``close``."""

    def __init__(self, n_slots: int) -> None:
        self._bufs: List[list] = [[] for _ in range(n_slots)]
        self._busy = [False] * n_slots
        self._retired: list = []
        self._next = 0

    def take(self, leaves):
        """(slot id, pinned host tensors shaped like ``leaves``)."""
        i = self._next
        if self._busy[i]:
            raise RuntimeError(
                "pinned host slot still in use: more chunks in flight than "
                "the pipeline sized its slots for")
        self._next = (i + 1) % len(self._bufs)
        self._busy[i] = True
        bufs = self._bufs[i]
        out = []
        for j, leaf in enumerate(leaves):
            nbytes = leaf.numel() * leaf.element_size()
            if j == len(bufs) or bufs[j].numel() < nbytes:
                buf = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                                  pin_memory=True)
                if j == len(bufs):
                    bufs.append(buf)
                else:
                    self._retired.append(bufs[j])
                    bufs[j] = buf
            out.append(bufs[j][:nbytes].view(leaf.dtype).view(leaf.shape))
        return i, out

    def release(self, i: int) -> None:
        self._busy[i] = False

    def close(self) -> None:
        self._bufs = [[] for _ in self._bufs]
        self._retired = []


class DeviceExport:
    """A dispatched export (or its digest leaf): its leaves on the device,
    an event recorded on the compute stream right after the dispatch, and
    (once started) the d2h copy into pinned host buffers on a dedicated
    copy stream.

    The port's counterpart of the reference's duck-typed device handles
    and its ``_block_until_ready`` / ``_start_host_copy``:
    ``block_until_ready()`` waits for the fold + export without copying
    (the honest boundary between ``device_wait`` and ``download``),
    ``copy_to_host_async()`` starts the copy, ``to_numpy()`` waits for it
    and returns numpy views (a leaf, or a tuple of leaves), and
    ``gather_rows(idx)`` fetches only some documents' rows (the tier-0
    partial route, ``mergetree_kernel.gather_export_rows``).  ``nbytes``
    is the size of the whole export.  On the CPU there is nothing to wait
    for or copy.  ``slot`` names the pinned host slot the copy used (None
    when nothing was copied); the pipeline releases it once the chunk's
    extraction is collected."""

    def __init__(self, export, copy_stream=None, slots=None) -> None:
        self._tuple = isinstance(export, tuple)
        self._leaves = export if self._tuple else (export,)
        self.nbytes = int(sum(x.nbytes for x in self._leaves))
        self._on_card = self._leaves[0].device.type == "cuda"
        self._copy_stream = copy_stream
        self._slots = slots
        self._host = None
        self._copied = None
        self.slot = None
        self._ready = None
        if self._on_card:
            self._ready = torch.cuda.Event()
            self._ready.record()  # on the current (compute) stream

    def block_until_ready(self) -> None:
        """Wait for the fold + export to finish, without copying."""
        if self._ready is not None:
            self._ready.synchronize()

    def copy_to_host_async(self) -> None:
        """Start the d2h copy on the copy stream, behind the compute
        event."""
        if not self._on_card or self._host is not None:
            return
        self._copy_stream.wait_event(self._ready)
        self.slot, self._host = self._slots.take(self._leaves)
        with torch.cuda.stream(self._copy_stream):
            for host, leaf in zip(self._host, self._leaves):
                host.copy_(leaf, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(self._copy_stream)

    def to_numpy(self):
        """Wait for the copy; numpy views of the host leaves."""
        if self._on_card:
            self.copy_to_host_async()
            self._copied.synchronize()
            host = self._host
        else:
            host = self._leaves
        self._leaves = None  # the device buffers are no longer needed
        out = tuple(h.numpy() for h in host)
        return out if self._tuple else out[0]

    def gather_rows(self, idx):
        """``(rows, moved_bytes)`` of the documents ``idx`` only: exact
        rows on the CPU; on the card the bucketed gather of
        ``gather_export_rows``, copied through a pinned slot."""
        leaves = self._leaves if self._tuple else self._leaves[0]
        self._leaves = None
        return gather_export_rows(
            leaves, idx, fetch=self._fetch if self._on_card else None)

    def _fetch(self, tensors):
        """Copy device tensors (made on the compute stream) to a pinned
        slot on the copy stream; numpy views once the copy is done."""
        made = torch.cuda.Event()
        made.record()  # after the gather, on the current (compute) stream
        self._copy_stream.wait_event(made)
        self.slot, host = self._slots.take(tensors)
        with torch.cuda.stream(self._copy_stream):
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return [h.numpy() for h in host]


# ---------------------------------------------------------------------------
# The family-generic pipelined fold
# ---------------------------------------------------------------------------


def pipelined_family_replay(
    family: KernelFamily,
    docs,
    *,
    chunk_docs: int = 1024,
    pack_threads: int = 4,
    extract_threads: int = 3,
    fetch_depth: int = 2,
    schedule: bool = True,
    stats: Optional[dict] = None,
    stage: Optional[dict] = None,
    packed_out: Optional[list] = None,
    pack_cache: Optional[PackCache] = None,
    delta_cache=None,
    device_cache=None,
    pin_resident: bool = False,
    device="cuda",
):
    """Canonical summaries for ``docs`` in the given order, through the
    chunked pipeline and its cache tiers for any registered kernel family.

    ``stats`` accumulates ``device_docs``/``fallback_docs`` (plus
    ``delta_docs`` for documents served from the tier-0 delta cache
    without a download); ``stage`` (if given) accumulates busy seconds
    under ``STAGE_KEYS``, the pool legs' CPU seconds under
    ``HOST_CPU_KEYS`` and the integer byte counters
    ``h2d_bytes``/``d2h_bytes``; ``packed_out`` (if given) collects
    ``(state, ops, meta, tag)`` per chunk in schedule order, always the
    HOST arrays as narrowed for the upload (never resident tensors, which
    a later splice rewrites in place).  ``pack_cache`` (a
    :class:`PackCache` over this family, tier 2) reuses packed windows
    across calls for documents carrying a ``cache_token``;
    ``delta_cache`` (a ``service.catchup_cache.DeltaExportCache``, tier 0)
    turns on the digest-gated delta download; ``device_cache`` (an
    ``ops.device_cache.DevicePackCache`` on ``device``, tier 2.5) keeps
    packed chunks resident on the device across calls, and
    ``pin_resident=True`` pins every chunk this call serves into its
    resident-state tier.  ``device`` defaults to the card;
    ``device="cpu"`` runs the plain versions."""
    dev = resolve_device(device)
    if device_cache is not None and device_cache.device != dev:
        raise ValueError(f"device_cache lives on {device_cache.device}, "
                         f"the pipeline runs on {dev}")
    if device_cache is not None and device_cache.mesh is not None:
        raise ValueError("device_cache is placed on a mesh: the one-device "
                         "pipeline cannot read per-part buffers")
    # Seed HERE, not in the fold: a batch that routes entirely to
    # fallback never reaches _pipelined_fold, and the schema must hold
    # for it too.
    seed_stage(stage)

    def fold(batch):
        return _pipelined_fold(
            family, batch, chunk_docs, pack_threads, extract_threads,
            fetch_depth, schedule, stats, stage, packed_out, dev,
            pack_cache, delta_cache, device_cache, pin_resident)

    with span("pipeline.replay"):
        return partition_replay(
            docs, family.known_fallback, family.fallback_summary, fold,
            stats=stats,
        )


def pipelined_mergetree_replay(
    docs: Sequence[MergeTreeDocInput],
    *,
    chunk_docs: int = 1024,
    pack_threads: int = 4,
    extract_threads: int = 3,
    fetch_depth: int = 2,
    schedule: bool = True,
    stats: Optional[dict] = None,
    stage: Optional[dict] = None,
    packed_out: Optional[list] = None,
    pack_cache: Optional[PackCache] = None,
    delta_cache=None,
    device_cache=None,
    pin_resident: bool = False,
    device="cuda",
):
    """The merge-tree instance of :func:`pipelined_family_replay`, with
    the reference's signature and defaults plus ``device``."""
    return pipelined_family_replay(
        MERGETREE_FAMILY, docs,
        chunk_docs=chunk_docs, pack_threads=pack_threads,
        extract_threads=extract_threads, fetch_depth=fetch_depth,
        schedule=schedule, stats=stats, stage=stage,
        packed_out=packed_out, pack_cache=pack_cache,
        delta_cache=delta_cache, device_cache=device_cache,
        pin_resident=pin_resident, device=device,
    )


#: the fewest documents an extract slice takes: a chunk of fewer than
#: twice this (the service's and the server's handful of documents) stays
#: one task
MIN_SLICE_DOCS = 64


def _pipelined_fold(family, batch, chunk_docs, pack_threads,
                    extract_threads, fetch_depth, schedule, stats, stage,
                    packed_out, device, pack_cache=None, delta_cache=None,
                    device_cache=None, pin_resident=False):
    order = family.order(batch, schedule)
    sched = [batch[i] for i in order]
    starts = list(range(0, len(sched), chunk_docs))
    on_card = device.type == "cuda"
    # Chunks holding pinned slots: up to fetch_depth + 1 between dispatch
    # and fetch, and extract_threads being extracted, when the next takes
    # one; each holds up to two (the digest plane, and the export or its
    # gathered rows).
    slots = _HostSlots(2 * (fetch_depth + extract_threads + 3)) \
        if on_card else None
    copy_stream = torch.cuda.Stream(device=device) if on_card else None

    # The pool legs time themselves on their own threads (wall and
    # thread CPU seconds, returned last) and open no span: the calling
    # thread adds both to ``stage`` and spans its waits on them.  A pack
    # returns the tasks it ran besides.
    def pack_one(lo):
        t0, c0 = perf_counter(), thread_time()
        chunk = sched[lo:lo + chunk_docs]
        if pack_cache is not None:
            state, ops, meta = pack_cache.pack(chunk)
        else:
            state, ops, meta = family.pack(chunk)
        state, ops = family.narrow(chunk, state, ops, meta)
        return state, ops, meta, perf_counter() - t0, thread_time() - c0, 1

    def timed(fn, *args):
        t0, c0 = perf_counter(), thread_time()
        res = fn(*args)
        return res, perf_counter() - t0, thread_time() - c0

    def pack_sliced(lo, sliced, k, prev_turn, turn):
        """A chunk's pack cut into ``k`` document ranges
        (``family.slice_pack``): the intern here, once the previous
        sliced chunk's intern is done, so that the chunk the device takes
        first is packed first; each range's begin, then each range's
        finish, spread over both pools as extract slices are; the join
        here.  It runs on a thread of neither pool, so no worker waits on
        a task queued to its own pool.  Its busy seconds sum every step's
        thread."""
        chunk = sched[lo:lo + chunk_docs]
        busy = [0.0, 0.0]

        def add(dt, dc) -> None:
            busy[0] += dt
            busy[1] += dc

        def ranges(step) -> None:
            futs = [(ex_pool if j < extract_threads else pack_pool).submit(
                timed, step, j) for j in range(k)]
            wait(futs)
            for fut in futs:
                add(*fut.result()[1:])

        try:
            try:
                if prev_turn is not None:
                    prev_turn.wait()
                add(*timed(sliced.intern)[1:])
            finally:
                turn.set()
            ranges(sliced.begin)
            add(*timed(sliced.size)[1:])
            ranges(sliced.finish)
            (state, ops, meta), dt, dc = timed(sliced.join)
        finally:
            sliced.close()
        add(dt, dc)
        (state, ops), dt, dc = timed(family.narrow, chunk, state, ops, meta)
        add(dt, dc)
        return state, ops, meta, busy[0], busy[1], k

    def extract_rows(meta, arr, lo, hi, dig_np):
        """Extract documents ``[lo, hi)`` of a chunk from its full
        download (through the same sub-meta view as the delta route);
        with ``dig_np`` also (re)publish their tier-0 entries — the
        cold-fill leg of the delta path."""
        t0, c0 = perf_counter(), thread_time()
        if hi - lo < len(meta["docs"]):
            meta = delta_sub_meta(meta, range(lo, hi), family.per_doc_meta)
            arr = map_leaves(lambda a: a[lo:hi], arr)
        st: dict = {}
        res = family.extract(meta, arr, st)
        if dig_np is not None:
            delta_store_all(delta_cache, meta["docs"], dig_np[lo:hi], res)
        return res, st, perf_counter() - t0, thread_time() - c0

    def extract_served(docs, served):
        """Whole chunk served from tier 0: zero download, zero extract."""
        return [served[d] for d in range(len(docs))], \
            {"delta_docs": len(docs)}, 0.0, 0.0

    def extract_delta(meta, arr, changed, served, dig_np):
        """Extract ONLY the changed documents from their gathered rows;
        unchanged documents serve their cached summaries byte-identically
        (the cached tree came out of this same extraction under an equal
        digest + host anchor)."""
        t0, c0 = perf_counter(), thread_time()
        st: dict = {}
        got = family.extract(
            delta_sub_meta(meta, changed, family.per_doc_meta), arr, st)
        res = delta_merge_changed(delta_cache, meta, dig_np, served,
                                  changed, got)
        st["delta_docs"] = st.get("delta_docs", 0) + len(served)
        return res, st, perf_counter() - t0, thread_time() - c0

    out: List = []

    def collect(entry) -> None:
        futs, held = entry
        with span("pipeline.wait_extract"):
            parts = [fut.result() for fut in futs]
        # The slices are views into the pinned slots: free them only
        # once the chunk's last slice has returned.
        for slot in held:
            slots.release(slot)
        for res, st, dt, dc in parts:
            out.extend(res)
            _add_leg(stage, "extract", dt, dc)
            merge_extract_counts(st, stats, stage)

    pack_futs: collections.deque = collections.deque()
    ex_futs: collections.deque = collections.deque()
    inflight: collections.deque = collections.deque()
    last_turn: Optional[threading.Event] = None
    # At most pack_threads + 1 packs are pending, so each sliced pack has
    # a thread of the last pool to itself.
    with ThreadPoolExecutor(max_workers=pack_threads) as pack_pool, \
            ThreadPoolExecutor(max_workers=extract_threads) as ex_pool, \
            ThreadPoolExecutor(max_workers=pack_threads + 1) as sliced_pool:
        try:
            def submit_pack(lo):
                # A chunk of at least two slices' documents, which no pack
                # cache serves, is cut into as many document ranges as
                # both pools have workers, where the family offers it.
                nonlocal last_turn
                chunk = sched[lo:lo + chunk_docs]
                k = min(pack_threads + extract_threads,
                        len(chunk) // MIN_SLICE_DOCS)
                sliced = family.slice_pack(chunk, k) \
                    if k > 1 and pack_cache is None \
                    and family.slice_pack is not None else None
                if sliced is None:
                    return pack_pool.submit(pack_one, lo)
                turn = threading.Event()
                fut = sliced_pool.submit(pack_sliced, lo, sliced, k,
                                         last_turn, turn)
                last_turn = turn
                return fut

            next_i = 0
            while next_i < len(starts) and len(pack_futs) < pack_threads + 1:
                pack_futs.append(submit_pack(starts[next_i]))
                next_i += 1

            def submit_slices(meta, arr, dig_np=None) -> list:
                # While chunks remain to be packed, the extract pool alone
                # takes slices, so packs never queue behind them; once
                # every chunk is packed, the pack pool's workers are idle
                # for the rest of the call and take their share.
                packing = next_i < len(starts) or bool(pack_futs)
                n_docs = len(meta["docs"])
                k = max(1, min(extract_threads if packing
                               else pack_threads + extract_threads,
                               n_docs // MIN_SLICE_DOCS))
                cuts = [n_docs * j // k for j in range(k + 1)]
                return [
                    (ex_pool if j < extract_threads else pack_pool).submit(
                        extract_rows, meta, arr, cuts[j], cuts[j + 1],
                        dig_np)
                    for j in range(k)]

            def fetch_one(meta, core, dig, cand) -> None:
                # Wait for the DEVICE first (fold + export), so "download"
                # times the copy alone and d2h_bytes attributes what
                # actually crossed.
                with _leg(stage, "device_wait"):
                    core.block_until_ready()
                    if dig is not None:
                        dig.block_until_ready()
                docs = meta["docs"]
                if dig is None:
                    with _leg(stage, "download"):
                        arr = family.fetch(core)
                    _count_d2h(stage, _nbytes(arr))
                    futs = submit_slices(meta, arr)
                else:
                    with _leg(stage, "download"):
                        # the tiny eager round trip
                        dig_np = family.fetch(dig)
                    _count_d2h(stage, dig_np.nbytes)
                    # Host cache work stays OUTSIDE the download window;
                    # one lock acquisition serves the whole chunk.
                    route, served, changed = (
                        delta_route(docs, dig_np, delta_cache)
                        if cand else ("full", {}, None))
                    if route == "full":
                        # Cold / all-changed / fallback route — and the
                        # golden oracle the delta path is tested against.
                        with _leg(stage, "download"):
                            arr = family.fetch(core)
                        _count_d2h(stage, _nbytes(arr))
                        futs = submit_slices(meta, arr, dig_np)
                    elif route == "served":
                        delta_cache.note_bytes_saved(_nbytes(core))
                        futs = [ex_pool.submit(extract_served, docs, served)]
                    else:
                        # Exact rows on host-readable buffers; a bucketed
                        # device gather (or the whole buffer when padding
                        # would move it all) on the card — the family's
                        # gather owns that choice and reports the bytes
                        # that really crossed.
                        with _leg(stage, "download"):
                            sub, fetched = family.gather_rows(
                                core, np.asarray(changed, np.int32))
                        _count_d2h(stage, fetched)
                        delta_cache.note_bytes_saved(
                            max(0, _nbytes(core) - fetched))
                        futs = [ex_pool.submit(extract_delta, meta, sub,
                                               changed, served, dig_np)]
                if stage is not None:
                    stage["extract_tasks"] += len(futs)
                held = [h.slot for h in (core, dig)
                        if h is not None and h.slot is not None]
                ex_futs.append((futs, held))
                if len(ex_futs) >= extract_threads + 1:
                    collect(ex_futs.popleft())

            want_digest = delta_cache is not None
            while pack_futs:
                fut = pack_futs.popleft()
                with span("pipeline.wait_pack"):
                    state, ops, meta, dt, dc, tasks = fut.result()
                if next_i < len(starts):
                    pack_futs.append(submit_pack(starts[next_i]))
                    next_i += 1
                _add_leg(stage, "pack", dt, dc)
                if stage is not None:
                    stage["pack_tasks"] += tasks
                    if meta.get("resolve_rows"):
                        stage["resolve_rows"] = stage.get(
                            "resolve_rows", 0) + meta["resolve_rows"]
                if stats is not None and meta.get("native_docs"):
                    # documents a family's native record pack packed
                    stats["native_pack_docs"] = \
                        stats.get("native_pack_docs", 0) + meta["native_docs"]
                # --- upload leg (tier 2.5): resident buffers on a warm
                # window, an in-place suffix splice on a grown one, the
                # full upload otherwise.  All device interaction stays on
                # THIS thread; h2d_bytes counts the pack data that really
                # crossed (the reference's rule: the per-document base
                # counts only when the tier uploads it).
                with _leg(stage, "upload"):
                    base_dev = None
                    if device_cache is not None:
                        state_d, ops_d, base_dev, up_bytes = \
                            device_cache.acquire(state, ops, meta,
                                                 pin=pin_resident)
                        _count_h2d(stage, up_bytes)
                    else:
                        _count_h2d(stage,
                                   _np_nbytes(state) + _np_nbytes(ops))
                    if base_dev is None:
                        # No tier, or a chunk the tier bypasses
                        # (token-less, binary): the plain upload.
                        state_d = tensors_to(state, device)
                        ops_d = tensors_to(ops, device)
                        base_dev = map_leaves(
                            lambda a: torch.from_numpy(
                                np.ascontiguousarray(a)).to(device),
                            family.aux(meta, want_digest))
                with _leg(stage, "dispatch"):
                    ex = family.dispatch(state_d, ops_d, meta, want_digest,
                                         base_dev)
                    core, dig = family.split_digest(ex, want_digest)
                    cand = want_digest and delta_cache.any_candidate(
                        meta["docs"])
                    core = DeviceExport(core, copy_stream, slots)
                    if dig is not None:
                        dig = DeviceExport(dig, copy_stream, slots)
                        dig.copy_to_host_async()
                    if dig is None or not cand:
                        # No tier-0 candidate can skip the download: start
                        # the full copy at dispatch.  With candidates
                        # present, starting it would move the very bytes
                        # the delta download exists to avoid.
                        core.copy_to_host_async()
                if packed_out is not None:
                    packed_out.append((state, ops, meta,
                                       family.chunk_tag(meta)))
                inflight.append((meta, core, dig, cand))
                if len(inflight) > fetch_depth:
                    fetch_one(*inflight.popleft())
            while inflight:
                fetch_one(*inflight.popleft())
            while ex_futs:
                collect(ex_futs.popleft())
        finally:
            for f in pack_futs:
                f.cancel()
            for futs, _held in ex_futs:
                for f in futs:
                    f.cancel()
    if slots is not None:
        slots.close()
    # Restore the caller's order.
    restored: List = [None] * len(batch)
    for pos, i in enumerate(order):
        restored[i] = out[pos]
    return restored


# ---------------------------------------------------------------------------
# The merge-tree family instance
# ---------------------------------------------------------------------------


def _has_props(doc: MergeTreeDocInput) -> bool:
    for msg in doc.ops:
        op = msg.contents
        if not op["kind"].startswith("interval") and op.get("props"):
            return True
    return bool(any(r.get("p") for r in (doc.base_records or [])))


def _chunk_S(meta: dict) -> int:
    """The chunk's padded slot capacity (pack_mergetree_batch's S bucket),
    recovered from the packed meta for the cold-start export."""
    return int(meta["_S"])


def _mt_order(batch, schedule: bool):
    order = list(range(len(batch)))
    if schedule and any(d.binary_ops is not None for d in batch):
        # Fact-homogeneous scheduling: annotate-free documents first, so
        # their chunks elide the props rows.  Stable sort; the caller's
        # order is restored.  Binary documents carry the fact in their
        # header (O(1)); a batch with no binary documents keeps its order.
        order.sort(key=lambda i: batch[i].binary_prop_keys is not None
                   if batch[i].binary_ops is not None
                   else _has_props(batch[i]))
    return order


def _mt_narrow(chunk, state, ops, meta):
    warm = any(d.base_records for d in chunk)
    return (narrow_state_for_upload(state, meta) if warm else None,
            narrow_ops_for_upload(ops, meta))


def _mt_aux(meta, digest: bool):
    """The per-document arena base the dispatch consumes next to
    state/ops: real bases when the narrow layout or the digest reads
    them, zeros otherwise."""
    if bool(meta.get("i16_ok")) or digest:
        return np.asarray(meta["doc_base"], np.int32)
    return np.zeros((len(meta["docs"]),), np.int32)


def _mt_dispatch(state, ops, meta, digest: bool, aux_dev):
    return replay_export(state, ops, meta, S=_chunk_S(meta), digest=digest,
                         doc_base=aux_dev)


def _mt_dispatch_sharded(mesh, state, ops, meta, digest: bool, aux_dev):
    """The fold+export per part of ``mesh`` (``ops.parts.Parts`` of the
    part's planes, each on its device): the one-device dispatch once a
    part, on the part's device and its current stream, every part in the
    chunk's layout (the chunk-global ``meta`` facts), so the reassembled
    export equals one device's.  No collective: the fold is per
    document."""
    states = state if state is not None else (None,) * len(ops)
    return Parts(_mt_dispatch(s, o, meta, digest, a)
                 for s, o, a in zip(states, ops, aux_dev))


def _mt_entry_rows(chunk, meta):
    return [
        sum(1 for m in doc.ops
            if not m.contents["kind"].startswith("interval"))
        for doc in chunk
    ]


def _mt_entry_nbytes(state, ops, meta) -> int:
    return (
        sum(np.asarray(x).nbytes for x in ops)
        + sum(np.asarray(x).nbytes for x in state)
        + len(meta["arena"]) * 4
    )


def _mt_pad_token(k: int) -> tuple:
    """A deterministic cache token for mesh pad documents: the padded
    chunk's token tuple must stay all-non-None for tier-2/2.5 keying,
    and an empty pad doc's "stream" is trivially append-only under a
    fixed token.  Component 0 is a sentinel epoch, so the tier-0/2.5
    epoch sweeps treat pad entries as stale on any real epoch change."""
    return ("\x00pad", f"\x00pad{k}", 0, "")


MERGETREE_FAMILY = KernelFamily(
    name="mergetree",
    known_fallback=known_oracle_fallback,
    fallback_summary=oracle_fallback_summary,
    pack=pack_mergetree_batch,
    bypass=lambda d: d.binary_ops is not None,
    entry_rows=_mt_entry_rows,
    entry_nbytes=_mt_entry_nbytes,
    extend=_extend_mergetree,
    order=_mt_order,
    narrow=_mt_narrow,
    aux=_mt_aux,
    dispatch=_mt_dispatch,
    split_digest=split_export_digest,
    chunk_tag=_chunk_S,
    fetch=export_to_numpy,
    gather_rows=gather_export_rows,
    extract=lambda meta, arr, st: summaries_from_export(meta, arr,
                                                        stats=st),
    per_doc_meta=("doc_base",),
    slice_pack=slice_mergetree_pack,
    make_pad=lambda: MergeTreeDocInput(doc_id="\x00pad", ops=[]),
    pad_token=_mt_pad_token,
    dispatch_sharded=_mt_dispatch_sharded,
)
