"""Device-resident pack buffers — tier 2.5 of the catch-up cache.

The port of ``fluidframework_tpu/ops/device_cache.py``.  Tier 2
(:class:`~fluidframework_tpu_torch.ops.pipeline.PackCache`) removes the
host pack work of a warm catch-up and tier 0 makes its download
delta-only; this tier removes the upload.  It keeps the packed chunk
tensors resident in device memory across fold calls, keyed by the
chunk's ordered ``cache_token`` tuple — the same identity tier 2 proves
sound:

- **exact** hit (every document's op window unchanged): the dispatch leg
  consumes the resident tensors directly — ZERO h2d bytes for ops, state
  and the per-document aux plane;
- **suffix** hit (windows grew under the same pack-cache lineage): only
  the new suffix rows cross the link as fine-bucketed ``[D, L]`` row
  planes, and ``resident_cuda.splice_rows`` writes them into the resident
  tensors IN PLACE (one launch for the tuple; each tensor keeps its
  storage, so no second copy of any plane);
- a narrow→wide transfer-encoding flip of an otherwise matching window
  migrates the resident tensors on the device
  (``resident_cuda.widen_resident``, zero link bytes) so the window can
  still serve or splice;
- anything else — bucket overflow, a wide→narrow flip, unknown pack
  lineage, window mismatch — falls back to the full upload and re-stores.
  The resident tier can lose a win, never corrupt.

Soundness of the suffix splice is structural, as in the reference: the
token contract pins the shared prefix bytes; the **pack lineage**
(``meta["_pack_lineage"]``, stamped by tier 2) proves the host arrays in
hand are the literal suffix-extension of the arrays the resident tensors
were built from; the **encoding signature** (per-field dtype and shape
of the narrowed upload arrays) pins the transfer encoding.

Placement: every entry lives on ``device`` (the card by default;
``device="cpu"`` for the tests).  A spilled entry (the pinned tier, over
its budget) holds host copies — pinned memory when the device is the
card — and re-uploads them on its next acquire.  All device work here
(uploads, the splice, the migration, spills and restores) runs on the
caller's thread and current stream, the pipeline's single device thread
and the stream its folds read these buffers on; the lock guards only the
entry map and the counters.  A migrated entry drops its narrow tensors:
only folds on that same stream ever read them, so the caching allocator
may reuse their memory in stream order (no ``record_stream`` needed).

Byte-bounded LRU over insertion order (no wall clock), epoch
invalidation (tokens carry the storage epoch as component 0).  Counters:
``served`` (exact hits — zero-upload dispatches), ``spliced`` (suffix
splices), ``misses``, ``bypass``, ``inserts``, ``evictions``,
``invalidations``, ``bytes_saved`` (h2d bytes the tier kept off the link)
and the pinned tier's ``pins``, ``unpins``, ``spills``, ``unspills``.
The reference's mesh placement (``set_sharding``) waits for the port's
multi-GPU slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..utils.telemetry import CounterSet
from .interning import next_bucket_fine
from .mergetree_kernel import MTOps, resolve_device
# The shared tier-2/2.5 contracts live in the pipeline module (no cycle:
# the pipeline never imports this module): _np_nbytes is THE "what the
# upload leg pushes over h2d" byte rule, _doc_window / match_windows THE
# window-identity rules, MERGETREE_FAMILY the bypass and aux rules.
from .pipeline import (MERGETREE_FAMILY, _doc_window, _np_nbytes,
                       map_leaves, match_windows)
from .resident_cuda import splice_rows, widen_resident


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _dev_nbytes(*trees) -> int:
    return int(sum(leaf.nbytes for tree in trees for leaf in _leaves(tree)))


def tuple_sig(state, ops) -> tuple:
    """The transfer-encoding signature over namedtuple plane trees of host
    arrays: per-field dtype + shape of the (already narrowed) upload
    arrays.  Any bucket growth, narrow↔wide encoding flip, or cold↔warm
    change moves it — and a moved signature means the resident tensors
    cannot be extended, only replaced (unless the family's ``migrate``
    can convert them on the device)."""
    sig = tuple((f, str(getattr(ops, f).dtype), getattr(ops, f).shape)
                for f in type(ops)._fields)
    if state is not None:
        sig += tuple((f, str(getattr(state, f).dtype),
                      getattr(state, f).shape)
                     for f in type(state)._fields)
    return sig


def gather_suffix_rows(tuple_type, host_tree, t_old: np.ndarray,
                       t_new: np.ndarray, floor: int = 8):
    """Host-side suffix-row gather for the splice upload: each document's
    rows ``[t_old[d], t_new[d])`` taken from the combined host planes into
    fine-bucketed ``[D, L, ...]`` arrays (pad rows clone the last valid
    index — never written by the splice).  Returns ``(rows_np, L)`` or
    ``(None, L)`` when ``L`` reaches the full plane width (the full upload
    is then cheaper than a splice)."""
    lead = np.asarray(getattr(host_tree, tuple_type._fields[0]))
    T = lead.shape[1]
    grow = int((t_new - t_old).max(initial=0))
    L = min(next_bucket_fine(max(grow, 1), floor=floor), T)
    if L >= T:
        return None, L
    idx = np.minimum(
        t_old[:, None] + np.arange(L, dtype=np.int32)[None, :], T - 1)
    rows_np = {}
    for f in tuple_type._fields:
        v = np.asarray(getattr(host_tree, f))
        take = idx if v.ndim == 2 else idx[:, :, None]
        rows_np[f] = np.take_along_axis(v, take, axis=1)
    return rows_np, L


class _ResidentEntry:
    """One chunk's device-resident upload state + the host bookkeeping
    needed to match and extend it."""

    __slots__ = ("tokens", "n_ops", "first_seq", "last_seq", "t_rows",
                 "sig", "gen", "state", "ops", "base", "aux", "nbytes",
                 "pinned", "spilled")

    def __init__(self, tokens, n_ops, first_seq, last_seq, t_rows, sig,
                 gen, state, ops, base, aux=None):
        self.tokens = tokens
        self.n_ops = n_ops
        self.first_seq = first_seq
        self.last_seq = last_seq
        self.t_rows = t_rows            # np [D]: used op rows per doc
        self.sig = sig
        self.gen = gen                  # tier-2 pack generation (or None)
        self.state = state              # device state tree or None (cold)
        self.ops = ops                  # device ops tree
        self.base = base                # device per-doc aux tensor
        self.aux = aux                  # family host bookkeeping (counts)
        self.nbytes = _dev_nbytes(state, ops, base)
        #: the resident-state tier: a pinned entry is exempt from the LRU
        #: sweep.  Over the pin budget the oldest pinned entry SPILLS to
        #: host copies (spilled=True): device memory freed, the next
        #: acquire re-uploads from the host copy instead of repacking.
        self.pinned = False
        self.spilled = False


def _lineage_gen(meta: dict) -> Optional[int]:
    """The tier-2 pack generation of the host arrays in hand (None when
    tier 2 did not produce them — exact reuse only)."""
    lin = meta.get("_pack_lineage")
    return lin[-1] if lin else None


def _lineage_parent(meta: dict) -> Optional[int]:
    """For a suffix-extended pack, the generation it extended."""
    lin = meta.get("_pack_lineage")
    if lin and lin[0] == "suffix":
        return lin[1]
    return None


# ---------------------------------------------------------------------------
# The merge-tree device-ops instance
# ---------------------------------------------------------------------------


class MergeTreeDeviceOps:
    """The merge-tree family's tier-2.5 hooks: int16/int8 narrow
    encodings (with the on-device narrow→wide migration), a single op-row
    splice axis, and the per-document arena base as the aux plane."""

    @staticmethod
    def bypass(docs) -> bool:
        return any(MERGETREE_FAMILY.bypass(d) for d in docs)

    @staticmethod
    def sig(state, ops) -> tuple:
        return tuple_sig(state, ops)

    @staticmethod
    def aux(meta):
        # A resident entry always carries the real bases: the migration
        # and the digest read them (the family's digest-on rule).
        return MERGETREE_FAMILY.aux(meta, True)

    @staticmethod
    def t_rows(host_ops) -> np.ndarray:
        return np.count_nonzero(
            np.asarray(host_ops.kind), axis=1).astype(np.int32)

    @staticmethod
    def entry_aux(meta):
        return None

    @staticmethod
    def _widened_sig(sig: tuple) -> tuple:
        """The signature the same arrays would carry in the WIDE (int32)
        transfer encoding — shapes unchanged, every non-bool dtype
        int32."""
        return tuple((f, dt if dt == "bool" else "int32", shape)
                     for f, dt, shape in sig)

    def migrate(self, cache: "DevicePackCache", tokens,
                entry: _ResidentEntry, sig: tuple, docs) -> None:
        if not (entry.sig != sig
                and self._widened_sig(entry.sig) == sig
                and cache.match(entry, docs) is not None):
            return
        # The ONLY signature change is a narrow→wide transfer-encoding
        # flip (full-scale suffix growth does this: the new text lands at
        # the shared arena tail, past the int16 offset bound).  Widen the
        # resident tensors on the device — zero bytes over the link — so
        # the window can still serve/splice.
        old_nbytes = entry.nbytes
        entry.ops = widen_resident(entry.ops, entry.base)
        if entry.state is not None:
            entry.state = widen_resident(entry.state, entry.base)
        entry.sig = sig
        entry.nbytes = _dev_nbytes(entry.state, entry.ops, entry.base)
        cache.reaccount_migrated(tokens, entry, old_nbytes)

    def splice(self, cache: "DevicePackCache", entry: _ResidentEntry,
               docs, state, ops: MTOps, meta: dict) -> Optional[int]:
        """Upload only the suffix rows and splice them into the resident
        op tensors in place; returns the uploaded bytes, or None when the
        extension does not apply (the caller uploads in full).  The base
        state of a warm chunk is pinned by the token (it derives from the
        base summary alone), so only the op planes move."""
        t_new = self.t_rows(ops)
        t_old = entry.t_rows
        if np.any(t_new < t_old):
            return None
        rows_np, _L = gather_suffix_rows(MTOps, ops, t_old, t_new)
        if rows_np is None:
            return None  # suffix ~ whole buffer: full upload is cheaper
        uploaded = sum(v.nbytes for v in rows_np.values()) \
            + 2 * t_new.nbytes
        rows = MTOps(**{f: cache.put(v) for f, v in rows_np.items()})
        start = cache.put(t_old)
        count = cache.put(t_new - t_old)
        splice_rows(entry.ops, rows, start, count)
        entry.t_rows = t_new
        return int(uploaded)


class DevicePackCache:
    """Byte-bounded LRU of device-resident packed chunk tensors (see the
    module docstring).  ``device`` places every entry (the card by
    default); ``pin_max_bytes`` budgets the pinned resident-state tier;
    ``device_ops`` selects the family (default: merge-tree; the tree
    family's is ``tree_pipeline.TreeDeviceOps``)."""

    def __init__(self, max_bytes: int = 192 << 20, device="cuda",
                 pin_max_bytes: int = 64 << 20, device_ops=None) -> None:
        self.max_bytes = int(max_bytes)
        #: device-byte budget for the PINNED tier (resident doc state of
        #: the streaming fold).  Separate from ``max_bytes`` so a wide
        #: pinned working set cannot starve the ordinary LRU tier, and
        #: vice versa.
        self.pin_max_bytes = int(pin_max_bytes)
        self.device = resolve_device(device)
        self._fam = device_ops if device_ops is not None \
            else MergeTreeDeviceOps()
        self._lock = threading.Lock()
        # tokens -> _ResidentEntry (insertion order = LRU order)
        self._entries: dict = {}  # guarded-by: _lock
        self._bytes = 0       # device bytes of unspilled entries
        self._host_bytes = 0  # host bytes of spilled entries
        self._pinned_bytes = 0  # device bytes of pinned, unspilled entries
        self._last_epoch = None  # guarded-by: _lock
        self.counters = CounterSet(
            "served", "spliced", "misses", "bypass", "inserts",
            "evictions", "invalidations", "bytes_saved",
            "pins", "unpins", "spills", "unspills",
        )  # guarded-by: _lock (CounterSet is not internally synchronized)

    # -- placement -------------------------------------------------------------

    def put(self, x) -> torch.Tensor:
        """A copy of a host array (or tensor) on the cache's device —
        always a copy: a resident tensor is spliced in place later, so it
        must never share storage with a host array."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, copy=True)

    def put_tree(self, tree):
        """``put`` over every leaf of a namedtuple, a plain tuple (a
        family's aux counts) or a single array."""
        return map_leaves(self.put, tree)

    @staticmethod
    def _host_copy(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.device.type == "cuda":
            host = torch.empty(leaf.shape, dtype=leaf.dtype,
                               pin_memory=True)
            host.copy_(leaf)
            return host
        return leaf.clone()

    def _host_tree(self, tree):
        """Host copies of a resident tree (pinned when it lies on the
        card); the device memory frees once the last reference dies."""
        return map_leaves(self._host_copy, tree)

    # -- the pinned resident-state tier ----------------------------------------

    def _pool_sub(self, entry: _ResidentEntry) -> None:  # holds-lock
        if entry.spilled:
            self._host_bytes -= entry.nbytes
        else:
            self._bytes -= entry.nbytes
            if entry.pinned:
                self._pinned_bytes -= entry.nbytes

    def _pool_add(self, entry: _ResidentEntry) -> None:  # holds-lock
        if entry.spilled:
            self._host_bytes += entry.nbytes
        else:
            self._bytes += entry.nbytes
            if entry.pinned:
                self._pinned_bytes += entry.nbytes

    def _spill_locked(self, entry: _ResidentEntry) -> None:
        """Move an entry's tensors to host copies.  Holds _lock; MUST run
        on the device-interaction thread (d2h, in stream order)."""
        self._pool_sub(entry)
        entry.state = self._host_tree(entry.state)
        entry.ops = self._host_tree(entry.ops)
        entry.base = self._host_tree(entry.base)
        entry.spilled = True
        self._pool_add(entry)
        self.counters.bump("spills")

    def _enforce_pin_budget(self, keep) -> None:  # holds-lock: _lock
        """Spill oldest pinned entries until the pinned tier fits its
        device-byte budget; ``keep`` (a tokens key) is spilled LAST — it
        is the entry the caller is actively serving."""
        while self._pinned_bytes > self.pin_max_bytes:
            victim = next(
                (k for k, e in self._entries.items()
                 if e.pinned and not e.spilled and k != keep), None)
            if victim is None:
                victim = keep if keep in self._entries else None
                if victim is None or self._entries[victim].spilled:
                    break
            self._spill_locked(self._entries[victim])

    def pin(self, tokens) -> bool:
        """Mark the chunk's resident entry as pinned doc state: exempt
        from the LRU sweep, budgeted by ``pin_max_bytes`` with
        spill-to-host (oldest-pinned-first) when the pinned set grows past
        it.  Returns False when no entry exists for ``tokens``.  MUST be
        called from the device-interaction thread (a budget overflow
        spills — a d2h copy)."""
        with self._lock:
            entry = self._entries.get(tokens)
            if entry is None:
                return False
            if not entry.pinned:
                entry.pinned = True
                if not entry.spilled:
                    self._pinned_bytes += entry.nbytes
                self.counters.bump("pins")
                self._enforce_pin_budget(tokens)
            return True

    def unpin(self, tokens) -> bool:
        """Return a pinned entry to ordinary LRU life (a spilled one stays
        spilled until its next acquire re-uploads it)."""
        with self._lock:
            entry = self._entries.get(tokens)
            if entry is None or not entry.pinned:
                return False
            entry.pinned = False
            if not entry.spilled:
                self._pinned_bytes -= entry.nbytes
            self.counters.bump("unpins")
            return True

    def _restore_spilled(self, entry: _ResidentEntry):
        """Re-upload a spilled entry's host copies (the spill's other
        half).  Returns the h2d bytes and the uploaded ``(state, ops,
        base)`` — the caller serves those even when the pin budget spills
        the entry straight back.  Caller thread = device thread; the lock
        is NOT held across the uploads."""
        live = (self.put_tree(entry.state), self.put_tree(entry.ops),
                self.put_tree(entry.base))
        entry.state, entry.ops, entry.base = live
        with self._lock:
            if self._entries.get(entry.tokens) is entry:
                self._host_bytes -= entry.nbytes
                entry.spilled = False
                self._bytes += entry.nbytes
                if entry.pinned:
                    self._pinned_bytes += entry.nbytes
                    self._enforce_pin_budget(entry.tokens)
                self._sweep_unpinned(keep=entry.tokens)
            else:
                entry.spilled = False
            self.counters.bump("unspills")
        return entry.nbytes, live

    def _sweep_unpinned(self, keep=None) -> None:  # holds-lock: _lock
        """Evict oldest UNPINNED entries until the device pool fits — the
        LRU sweep of the cache tier; the pinned tier never evicts (it
        spills instead, on its own budget)."""
        while self._bytes > self.max_bytes:
            victim = next(
                (k for k, e in self._entries.items()
                 if not e.pinned and not e.spilled and k != keep), None)
            if victim is None:
                break
            self._pool_sub(self._entries.pop(victim))
            self.counters.bump("evictions")

    # -- introspection ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            out = self.counters.snapshot()
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
            out["pinned_entries"] = sum(
                1 for e in self._entries.values() if e.pinned)
            out["pinned_bytes"] = self._pinned_bytes
            out["spilled_bytes"] = self._host_bytes
        return out

    # -- the dispatch-side handshake -------------------------------------------

    def acquire(self, state, ops, meta: dict, pin: bool = False):
        """Device-resident ``(state, ops, aux, h2d_bytes)`` for a packed
        chunk about to dispatch: the resident tensors on an exact hit
        (zero upload), an in-place suffix splice on a lineage-proven
        extension, else a full upload that (re)stores the entry.
        Token-less / family-bypass chunks bypass and return the host
        arrays unchanged (``aux=None`` — the dispatcher uploads them as
        without the tier); ``h2d_bytes`` is what this call put on the
        link.  MUST be called from the single device-interaction thread.

        ``pin=True`` additionally pins the served entry into the
        resident-state tier — see :meth:`pin`.  A spilled entry that
        matches is restored by re-uploading its host copies (cheaper than
        a repack; counted in ``h2d_bytes``).  The tensors returned are the
        ones the fold must read, even when pinning spills the entry right
        after (the spill copies them to the host; these references keep
        the device memory alive until the fold is done with it)."""
        docs = meta["docs"]
        tokens = tuple(d.cache_token for d in docs)
        if any(t is None for t in tokens) or self._fam.bypass(docs):
            with self._lock:
                self.counters.bump("bypass")
            return state, ops, None, _np_nbytes(state) + _np_nbytes(ops)
        sig = self._fam.sig(state, ops)
        full_bytes = _np_nbytes(state) + _np_nbytes(ops)
        with self._lock:
            entry = self._entries.get(tokens)
        if entry is not None and entry.sig != sig and not entry.spilled:
            self._fam.migrate(self, tokens, entry, sig, docs)
        if entry is not None and entry.sig == sig:
            kind = self.match(entry, docs)
            restored, live = 0, None
            if kind is not None and entry.spilled:
                restored, live = self._restore_spilled(entry)
            if kind == "exact":
                with self._lock:
                    self._touch(tokens)
                    self.counters.bump("served")
                    self.counters.bump("bytes_saved",
                                       max(0, full_bytes - restored))
                gen = _lineage_gen(meta)
                if gen is not None:
                    # Content is equal either way; tracking the freshest
                    # tier-2 generation keeps future suffix lineage
                    # checks matching.
                    entry.gen = gen
                out = live or (entry.state, entry.ops, entry.base)
                if pin:
                    self.pin(tokens)
                return (*out, restored)
            if kind == "suffix" and entry.gen is not None \
                    and _lineage_parent(meta) == entry.gen:
                if live is not None and entry.spilled:
                    # The pin budget spilled the entry straight back:
                    # splice the uploaded tensors, as the reference
                    # splices its re-uploaded arrays.
                    entry.state, entry.ops, entry.base = live
                uploaded = self._fam.splice(self, entry, docs, state,
                                            ops, meta)
                if uploaded is not None:
                    uploaded += restored
                    self._refresh_windows(entry, docs, meta)
                    with self._lock:
                        self._touch(tokens)
                        self.counters.bump("spliced")
                        self.counters.bump("bytes_saved",
                                           max(0, full_bytes - uploaded))
                    out = (entry.state, entry.ops, entry.base)
                    if pin:
                        self.pin(tokens)
                    return (*out, uploaded)
        # Miss / signature moved / unprovable lineage: full upload.
        with self._lock:
            self.counters.bump("misses")
        state_dev = self.put_tree(state)
        ops_dev = self.put_tree(ops)
        aux_host = self._fam.aux(meta)
        base_dev = self.put_tree(aux_host)
        self._store(tokens, docs, sig, _lineage_gen(meta), state_dev,
                    ops_dev, base_dev, ops, meta, pin=pin)
        return state_dev, ops_dev, base_dev, \
            full_bytes + _np_nbytes(tuple(_leaves(aux_host)))

    # -- matching --------------------------------------------------------------

    @staticmethod
    def match(entry: _ResidentEntry, docs) -> Optional[str]:
        """The shared tier-2/2.5 window rule (``match_windows``) over the
        resident entry's bookkeeping."""
        return match_windows(entry.n_ops, entry.first_seq,
                             entry.last_seq, docs)

    def _refresh_windows(self, entry: _ResidentEntry, docs,
                         meta: dict) -> None:
        """After a successful splice: advance the entry's window
        bookkeeping, lineage generation, and family aux counts to the
        combined (extended) chunk."""
        n_ops, first_seq, last_seq = [], [], []
        for doc in docs:
            n, first, last = _doc_window(doc)
            n_ops.append(n)
            first_seq.append(first)
            last_seq.append(last)
        entry.n_ops = n_ops
        entry.first_seq = first_seq
        entry.last_seq = last_seq
        entry.gen = _lineage_gen(meta)
        entry.aux = self._fam.entry_aux(meta)

    # -- bookkeeping -----------------------------------------------------------

    def reaccount_migrated(self, tokens, entry: _ResidentEntry,
                           old_nbytes: int) -> None:
        """Re-account an encoding-migrated entry (~2× the bytes) in ONE
        identity-guarded critical section: the adjustment applies only if
        the map still holds THE entry that was migrated, and the LRU sweep
        rebalances the budget (the migrated entry itself is never evicted
        mid-serve — if it alone exceeds the budget it is un-mapped, same
        policy as _store's never-admit rule, while this call keeps serving
        its tensors)."""
        with self._lock:
            if self._entries.get(tokens) is not entry:
                return
            delta = entry.nbytes - old_nbytes
            self._bytes += delta
            if entry.pinned:
                self._pinned_bytes += delta
                self._enforce_pin_budget(tokens)
            self._sweep_unpinned(keep=tokens)
            if self._bytes > self.max_bytes and not entry.pinned:
                self._pool_sub(self._entries.pop(tokens))
                self.counters.bump("evictions")

    def _touch(self, tokens) -> None:  # holds-lock: _lock
        entry = self._entries.pop(tokens, None)
        if entry is not None:
            self._entries[tokens] = entry

    def _store(self, tokens, docs, sig, gen, state_dev, ops_dev, base_dev,
               host_ops, meta: dict, pin: bool = False) -> None:
        n_ops, first_seq, last_seq = [], [], []
        for doc in docs:
            n, first, last = _doc_window(doc)
            n_ops.append(n)
            first_seq.append(first)
            last_seq.append(last)
        t_rows = self._fam.t_rows(host_ops)
        entry = _ResidentEntry(tokens, n_ops, first_seq, last_seq, t_rows,
                               sig, gen, state_dev, ops_dev, base_dev,
                               aux=self._fam.entry_aux(meta))
        with self._lock:
            old = self._entries.pop(tokens, None)
            if old is not None:
                self._pool_sub(old)
                # A re-store inherits the old entry's pin: the pin names
                # the DOC's resident state, not one encoding of it.
                entry.pinned = old.pinned
            entry.pinned = entry.pinned or pin
            if entry.nbytes > self.max_bytes:
                self.counters.bump("evictions")
                return
            self._entries[tokens] = entry
            self._bytes += entry.nbytes
            if entry.pinned:
                self._pinned_bytes += entry.nbytes
                if pin and (old is None or not old.pinned):
                    self.counters.bump("pins")
                self._enforce_pin_budget(tokens)
            self.counters.bump("inserts")
            self._sweep_unpinned(keep=tokens)

    # -- epoch invalidation ----------------------------------------------------

    def invalidate_epoch(self, current_epoch: str) -> int:
        """Drop entries holding any token pinned to a DIFFERENT storage
        generation (token component 0 is the epoch — same contract as
        tier 0).  O(1) while the epoch is unchanged."""
        with self._lock:
            if current_epoch == self._last_epoch:
                return 0
            self._last_epoch = current_epoch
            stale = [key for key in self._entries
                     if any(tok[0] != current_epoch for tok in key)]
            for key in stale:
                # Pins do not survive an epoch flip: the pinned state was
                # derived under the dead storage generation.
                self._pool_sub(self._entries.pop(key))
                self.counters.bump("invalidations")
        return len(stale)
