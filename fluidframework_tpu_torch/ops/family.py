"""Kernel-family descriptor: the contract a batched replay kernel
implements to ride the shared catch-up pipeline (``ops/pipeline.py``).

The port's copy of ``fluidframework_tpu/ops/family.py``.  Everything the
pipeline does per chunk — pack, tier-2 window reuse, upload (tier 2.5),
dispatch, the tier-0 digest handshake, download, extraction, fallback
routing — goes through these hooks, and ``pipelined_mergetree_replay`` is
one instance of the generic fold, ``pipelined_tree_replay``
(``ops/tree_pipeline.py``) the second.

A family's ``(state, ops)`` are namedtuples of ``[D, ...]`` planes with
the document axis leading — the invariant every generic helper
(``match_windows``, ``gather_export_rows``) relies on.  Hooks that a
family does not support are None and the corresponding tier degrades
(e.g. ``extend=None`` turns every grown-tail window into a full repack —
a lost win, never corruption).  The mesh hooks (``make_pad``,
``pad_token``, ``dispatch_sharded``) serve the doc-sharded fold of
``parallel/shard.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One replay kernel's bindings into the family-generic pipeline.

    routing
      - ``known_fallback(doc)`` → falsy | True | reason str: pre-pack
        oracle routing (reasons feed the per-reason fallback counters);
      - ``fallback_summary(doc)`` → SummaryTree: the exactness escape
        hatch (also the post-fold fallback the extractor takes).

    pack / tier 2
      - ``pack(chunk)`` → ``(state, ops, meta)`` as host arrays;
      - ``bypass(doc)`` → bool: cache-ineligible beyond a missing token
        (e.g. merge-tree binary streams);
      - ``entry_rows(chunk, meta)`` → per-document used op-row counts
        (the suffix fill offsets the cache entry tracks);
      - ``entry_nbytes(state, ops, meta)`` → retained bytes for the LRU
        budget;
      - ``extend(entry, chunk)`` → ``(state, ops, meta)`` | None: pack
        only the suffix on top of a cached window (None = repack).

    upload / dispatch
      - ``order(batch, schedule)`` → schedule-order index list;
      - ``narrow(chunk, state, ops, meta)`` → ``(state_u | None,
        ops_u)``: the h2d transfer encodings (state None for a cold
        chunk);
      - ``aux(meta, digest)`` → the host array (or tuple of arrays) the
        dispatch needs next to state/ops (merge-tree: the per-document
        arena base; tree: the used node and container row counts);
      - ``dispatch(state_u, ops_u, meta, digest, aux_dev)`` → export
        leaves on the device;
      - ``split_digest(export, want)`` → ``(core, digest | None)``;
      - ``chunk_tag(meta)`` → value stored in ``packed_out`` tuples.

    download / extract / tier 0
      - ``fetch(core)`` → host arrays (the full d2h transfer);
      - ``gather_rows(core, idx)`` → ``(rows, moved_bytes)``: only the
        changed documents' rows;
      - ``extract(meta, arr, stats)`` → summaries (counting post-fold
        fallbacks into ``stats``);
      - ``per_doc_meta``: names of per-document ndarray meta entries the
        changed-rows sub-meta must slice alongside docs/doc_packs.

    mesh (``parallel/shard.py``)
      - ``make_pad()`` → an empty pad document;
      - ``pad_token(k)`` → deterministic cache token for pad documents;
      - ``dispatch_sharded(mesh, state_u, ops_u, meta, digest,
        aux_dev)`` → the export per part of the mesh
        (``ops.parts.Parts``; the inputs are per part too, each part on
        its own device).
    """

    name: str
    # routing
    known_fallback: Callable[[Any], Any]
    fallback_summary: Callable[[Any], Any]
    # pack / tier 2
    pack: Callable[[Any], Tuple[Any, Any, dict]]
    bypass: Callable[[Any], bool]
    entry_rows: Callable[[Any, dict], Any]
    entry_nbytes: Callable[[Any, Any, dict], int]
    extend: Optional[Callable[[Any, Any], Any]]
    # upload / dispatch
    order: Callable[[Any, bool], Any]
    narrow: Callable[[Any, Any, Any, dict], Tuple[Any, Any]]
    aux: Callable[[dict, bool], Any]
    dispatch: Callable[[Any, Any, dict, bool, Any], Any]
    split_digest: Callable[[Any, bool], Tuple[Any, Any]]
    chunk_tag: Callable[[dict], Any]
    # download / extract / tier 0
    fetch: Callable[[Any], Any]
    gather_rows: Callable[[Any, Any], Tuple[Any, int]]
    extract: Callable[[dict, Any, dict], Any]
    per_doc_meta: Tuple[str, ...] = ()
    # mesh
    make_pad: Optional[Callable[[], Any]] = None
    pad_token: Optional[Callable[[int], tuple]] = None
    dispatch_sharded: Optional[Callable[..., Any]] = None
