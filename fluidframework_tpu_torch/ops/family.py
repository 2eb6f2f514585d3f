"""Kernel-family descriptor: the contract a batched replay kernel
implements to ride the shared catch-up pipeline (``ops/pipeline.py``).

The port's copy of ``fluidframework_tpu/ops/family.py``.  Everything the
pipeline does per chunk — pack, upload encoding, dispatch, download,
extraction, fallback routing — goes through these hooks, and
``pipelined_mergetree_replay`` is one instance of the generic fold.  Only
the merge-tree instance is ported so far.

A family's ``(state, ops)`` are namedtuples of ``[D, ...]`` planes with
the document axis leading.  The reference's hooks for the catch-up cache
tiers (``bypass``, ``entry_rows``, ``entry_nbytes``, ``extend``,
``gather_rows``, ``per_doc_meta``) and the mesh (``make_pad``,
``pad_token``, ``dispatch_sharded``) join this descriptor with the
slices that port those paths (ROADMAP queue 1 items 3 and 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One replay kernel's bindings into the family-generic pipeline.

    routing
      - ``known_fallback(doc)`` → falsy | True | reason str: pre-pack
        oracle routing (reasons feed the per-reason fallback counters);
      - ``fallback_summary(doc)`` → SummaryTree: the exactness escape
        hatch (also the post-fold fallback the extractor takes).

    pack
      - ``pack(chunk)`` → ``(state, ops, meta)`` as host arrays.

    upload / dispatch
      - ``order(batch, schedule)`` → schedule-order index list;
      - ``narrow(chunk, state, ops, meta)`` → ``(state_u | None,
        ops_u)``: the h2d transfer encodings (state None for a cold
        chunk);
      - ``aux(meta, digest)`` → the host array the dispatch needs next
        to state/ops (merge-tree: the per-document arena base);
      - ``dispatch(state_u, ops_u, meta, digest, aux_dev)`` → export
        leaves on the device;
      - ``split_digest(export, want)`` → ``(core, digest | None)``;
      - ``chunk_tag(meta)`` → value stored in ``packed_out`` tuples.

    download / extract
      - ``fetch(core)`` → host arrays (the full d2h transfer);
      - ``extract(meta, arr, stats)`` → summaries (counting post-fold
        fallbacks into ``stats``).
    """

    name: str
    # routing
    known_fallback: Callable[[Any], Any]
    fallback_summary: Callable[[Any], Any]
    # pack
    pack: Callable[[Any], Tuple[Any, Any, dict]]
    # upload / dispatch
    order: Callable[[Any, bool], Any]
    narrow: Callable[[Any, Any, Any, dict], Tuple[Any, Any]]
    aux: Callable[[dict, bool], Any]
    dispatch: Callable[[Any, Any, dict, bool, Any], Any]
    split_digest: Callable[[Any, bool], Tuple[Any, Any]]
    chunk_tag: Callable[[dict], Any]
    # download / extract
    fetch: Callable[[Any], Any]
    extract: Callable[[dict, Any, dict], Any]
