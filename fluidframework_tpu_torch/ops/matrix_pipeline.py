"""SharedMatrix as the third kernel family of the generic catch-up
pipeline.

This module binds ``ops/matrix_kernel.py`` into ``ops/pipeline.py``: a
chunk of matrix documents is packed (the native record pack,
``matrix_native``, when every document carries records and no base
summary, else ``pack_matrix_batch``), uploaded, folded by K4
(``matrix_fold_cuda.fold_resolving``: both axis streams of every document,
each setCell's row and column resolved to handles), downloaded and
written into summaries as document slices (the native writer,
``matrix_native.write_summaries``, for natively packed documents; the
Python route, ``summary_from_matrix_state``, for the rest and for any
document the writer leaves), with the pipeline's pools, slices and spans.
``pipelined_matrix_replay`` is the bulk entry point, byte-identical to
``replay_matrix_batch`` and the ``dds/matrix.py`` oracle.

The cache tiers stay off for this family: every document bypasses the
pack caches (``bypass``), a grown window repacks (``extend`` None), and
the fold writes no digest, so the delta tier downloads every chunk whole.
A violated fact of the matrix stream raises from the download, as in
``replay_matrix_batch``.

The export is ``[D, ...]`` with the document leading (the pipeline slices
it by documents): each axis plane the summaries read as ``[D, 2, W]``
(rows then columns, cut on the card to the width ``W`` no stream can pass,
``meta["width"]``), ``n`` / ``overflow`` ``[D, 2]``, ``resolved``
``[D, 2, T]`` and the fact violations ``[D, 2]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..protocol.summary import SummaryTree
from .family import KernelFamily
from .matrix_fold_cuda import check_facts, fold_resolving
from .matrix_kernel import (
    MatrixDocInput,
    known_matrix_fallback,
    oracle_matrix_fallback,
    pack_matrix_batch,
    summary_from_matrix_state,
)
from .matrix_native import (
    WRITER_PLANES,
    RecordDocPack,
    RecordPack,
    load_library,
    pack_records,
    write_summaries,
)
from .mergetree_kernel import K_INSERT, K_REMOVE, export_to_numpy, \
    gather_export_rows
from .pipeline import pipelined_family_replay

__all__ = ["MATRIX_FAMILY", "EXPORT_FIELDS", "pipelined_matrix_replay",
           "summaries_from_matrix_export"]

#: the export's leaves, in order
EXPORT_FIELDS = WRITER_PLANES + ("n", "overflow", "resolved", "violations")


def _native(chunk: Sequence[MatrixDocInput]) -> bool:
    """Every document carries records, no messages and no base summary."""
    return all(doc.records is not None and not doc.ops
               and doc.base_summary is None for doc in chunk)


def _matrix_pack(chunk: Sequence[MatrixDocInput]):
    """The chunk's ``(state | None, ops, meta)``: the native record pack
    where it applies, else ``pack_matrix_batch`` with the meta the family
    reads (``doc_packs``, the slot bucket ``S``, the width ``W`` no
    stream passes, ``resolve_rows``)."""
    if _native(chunk):
        packed = pack_records(chunk)
        if packed is not None:
            return packed
    state, ops, meta = pack_matrix_batch(chunk)
    S = state.tstart.shape[1]
    kind = np.asarray(ops.kind)
    real = np.count_nonzero((kind == K_INSERT) | (kind == K_REMOVE), axis=1)
    # an insert adds at most two slots (a split and its own), a remove at
    # most two splits
    bound = int((np.asarray(state.n) + 2 * real).max(initial=0))
    meta.update(doc_packs=meta["packs"], S=S, width=max(1, min(S, bound)),
                resolve_rows=sum(2 * len(p.cells) for p in meta["packs"]))
    return state, ops, meta


def _slice_matrix_pack(chunk, k: int):
    """The native record pack cut into ``k`` document ranges, or None
    where the chunk packs whole (``KernelFamily.slice_pack``)."""
    lib = load_library() if _native(chunk) else None
    return None if lib is None else RecordPack(lib, chunk, k)


def _matrix_narrow(chunk, state, ops, meta):
    """A cold chunk uploads no state (the fold builds the fill); a warm
    one its whole state.  The op planes stay int32: K4 reads them so."""
    return (None if meta["cold"] else state), ops


def _matrix_dispatch(state, ops, meta: dict, digest: bool, aux_dev):
    """K4 on the chunk, and the export: the summary planes cut to the
    chunk's width, ``n``, ``overflow``, ``resolved`` and the violation
    counts, each ``[D, 2, ...]``."""
    final, resolved, violations = fold_resolving(
        state, ops, cold=meta["cold"], S=meta["S"])
    D, W = ops.kind.shape[0] // 2, meta["width"]
    planes = tuple(getattr(final, f)[:, :W].contiguous().reshape(D, 2, W)
                   for f in WRITER_PLANES)
    return planes + (final.n.reshape(D, 2), final.overflow.reshape(D, 2),
                     resolved.reshape(D, 2, -1), violations.reshape(D, 2))


def _matrix_fetch(core):
    """The export on the host; raises ``ValueError`` when the fold counted
    a violated fact (``check_facts``)."""
    arr = export_to_numpy(core)
    check_facts(arr[-1])
    return arr


def summaries_from_matrix_export(meta, arr, stats: Optional[dict] = None,
                                 counts: Optional[dict] = None) -> List:
    """A downloaded chunk (or slice) → canonical summaries.  The natively
    packed documents go to the native writer, one call; every other
    document, and one the writer leaves (an axis that overflowed, which
    the Python route sends to the oracle), takes
    ``summary_from_matrix_state``, the same bytes and counts in Python.
    ``counts`` (when given) gets the documents the writer wrote
    (``extract_native_docs``) and the cells the summaries hold
    (``extract_cells``)."""
    planes = dict(zip(EXPORT_FIELDS, arr))
    docs, packs = meta["docs"], meta["doc_packs"]
    out: List = [None] * len(docs)
    rows = [d for d, p in enumerate(packs) if isinstance(p, RecordDocPack)]
    written = write_summaries(meta, planes, rows) if rows else None
    native = cells = 0
    for d, (header, body, n) in zip(rows, written or ()):
        if header is not None:
            out[d] = SummaryTree().add_blob("header", header) \
                .add_blob("body", body)
            native += 1
            cells += n
    if stats is not None and native:
        stats["device_docs"] = stats.get("device_docs", 0) + native
    if counts is not None and native:
        for key, v in (("extract_native_docs", native),
                       ("extract_cells", cells)):
            counts[key] = counts.get(key, 0) + v
    rest = [d for d, tree in enumerate(out) if tree is None]
    if rest:
        W, T = planes["tstart"].shape[2], planes["resolved"].shape[2]
        flat = {f: planes[f].reshape(-1, W) for f in WRITER_PLANES}
        flat.update(n=planes["n"].reshape(-1),
                    overflow=planes["overflow"].reshape(-1))
        resolved = planes["resolved"].reshape(-1, T)
        sub = dict(meta, packs=packs)
        for d in rest:
            out[d] = summary_from_matrix_state(sub, flat, resolved, d,
                                               stats=stats, counts=counts)
    return out


MATRIX_FAMILY = KernelFamily(
    name="matrix",
    known_fallback=known_matrix_fallback,
    fallback_summary=oracle_matrix_fallback,
    pack=_matrix_pack,
    bypass=lambda doc: True,
    entry_rows=lambda chunk, meta: [0] * len(chunk),
    entry_nbytes=lambda state, ops, meta: 0,
    extend=None,
    order=lambda batch, schedule: list(range(len(batch))),
    narrow=_matrix_narrow,
    aux=lambda meta, digest: None,
    dispatch=_matrix_dispatch,
    split_digest=lambda export, want: (export, None),
    chunk_tag=lambda meta: None,
    fetch=_matrix_fetch,
    gather_rows=gather_export_rows,
    extract=lambda meta, arr, st: summaries_from_matrix_export(
        meta, arr, stats=st, counts=st),
    per_doc_meta=("cell_lo", "cell_hi", "fww"),
    slice_pack=_slice_matrix_pack,
)


def pipelined_matrix_replay(docs: Sequence[MatrixDocInput], **kwargs):
    """Bulk SharedMatrix catch-up through the generic pipeline:
    ``pipelined_family_replay`` over :data:`MATRIX_FAMILY`, with its
    defaults (``chunk_docs`` 1,024, 4 pack and 3 extract threads,
    ``fetch_depth`` 2; ``device`` the card).  Byte-identical to
    ``replay_matrix_batch`` and the ``dds/matrix.py`` oracle."""
    return pipelined_family_replay(MATRIX_FAMILY, docs, **kwargs)
