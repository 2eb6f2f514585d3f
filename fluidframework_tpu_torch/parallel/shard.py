"""Document-sharded replay over a device list.

The port of ``fluidframework_tpu/parallel/shard.py``.  The reference lays
a batch's ``[D, ...]`` planes out over a ``jax.sharding.Mesh`` with a
``docs`` axis and lets XLA partition the vmapped fold; here a
:class:`DocMesh` is an ordered device list (``torch.cuda.device_count()``
cards by default), and a batch's document axis splits into ``mesh.size``
equal contiguous parts in mesh order: part ``i`` is uploaded to the
``i``-th device and folded there by the family's kernel, on that device's
current stream (every kernel wrapper enters its tensors' device).  The
fold is per document, so no collective is needed: the host waits on
every part and reassembles the results in order.  A list that names one
card more than once still runs the split, the per-part launches and the
reassembly, one part after another on that card.

- :func:`replay_family_sharded` is the generic sharded fold of the
  merge-tree (K1) and tree (K5) families, with the one-device pipeline's
  cache tiers and stage schema: tier-2 pack reuse, the tier-0
  digest-gated delta download, and tier 2.5 placed on the mesh (an exact
  hit uploads nothing; a suffix hit splices each part in place with K6).
  Byte counters count the padded buffers, as the reference does.
- :func:`replay_map_sharded` splits the batch on document boundaries and
  packs each part on its own, so every key's rows stay on one part and
  each part's K7 launch computes whole per-key maxima (the reference
  shards the flat op axis and lets XLA combine the maxima across chips).
- :func:`replay_matrix_sharded` pads to ``size // gcd(size, 2)``
  documents so the ``[2D]`` stream axis splits evenly, launches K4 per
  part and checks each part's violated facts.

:func:`dcn_mesh` keeps the reference's two-level ``(slice, docs)`` grid
and its validation; its document axis is the grid flattened in order.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.interning import next_bucket_fine
from ..ops.mergetree_kernel import MergeTreeDocInput
from ..ops.parts import Parts, put_parts
from ..protocol.summary import SummaryTree

DOC_AXIS = "docs"
SLICE_AXIS = "slice"


class DocMesh:
    """An ordered, immutable device list with the reference mesh's
    ``size``, ``shape``, ``axis_names`` and ``devices`` (an object array
    of that shape); compared and hashed by value.  ``flat`` is the
    document axis: the devices in mesh order, one a part."""

    __slots__ = ("flat", "shape", "axis_names", "size", "devices")

    def __init__(self, devices: Sequence, shape: tuple,
                 axis_names: tuple) -> None:
        flat = tuple(devices)
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        grid = grid.reshape(shape)
        grid.flags.writeable = False
        for name, value in (("flat", flat), ("shape", tuple(shape)),
                            ("axis_names", tuple(axis_names)),
                            ("size", len(flat)), ("devices", grid)):
            object.__setattr__(self, name, value)

    def __setattr__(self, name, value):
        raise AttributeError("a DocMesh is immutable")

    def _key(self) -> tuple:
        return (tuple(str(d) for d in self.flat), self.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, DocMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"DocMesh({[str(d) for d in self.flat]}, "
                f"shape={self.shape}, axis_names={self.axis_names})")


def _as_device(d):
    """A device of the list: a ``torch.device`` from a name or a card
    index; any other object (a device-like record) as it is."""
    if isinstance(d, torch.device):
        return d
    if isinstance(d, str):
        return torch.device(d)
    if isinstance(d, int):
        return torch.device("cuda", d)
    return d


def _visible_cards() -> list:
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device: a doc mesh spans the visible cards by "
            "default; pass devices (e.g. ['cpu', 'cpu']) to fold on the "
            "CPU")
    return [torch.device("cuda", i) for i in range(n)]


def doc_mesh(devices: Optional[Sequence] = None) -> DocMesh:
    """A 1-D mesh over every visible card (or the given devices),
    document-sharded.  A list may name one device more than once."""
    devs = [_as_device(d) for d in (devices if devices is not None
                                    else _visible_cards())]
    if not devs:
        raise ValueError("a doc mesh needs at least one device")
    return DocMesh(devs, (len(devs),), (DOC_AXIS,))


def _slice_of(d) -> int:
    return getattr(d, "slice_index", 0) or 0


def dcn_mesh(n_slices: int, devices: Optional[Sequence] = None) -> DocMesh:
    """A 2-D ``(slice, docs)`` mesh: the outer axis across slices, the
    inner across a slice's devices.  Devices that expose ``slice_index``
    are grouped by it (then by ``id``), and a row that would straddle two
    hardware slices raises; cards expose none, so a flat list reshapes in
    order.  A count that does not split into ``n_slices`` raises."""
    devs = [_as_device(d) for d in (devices if devices is not None
                                    else _visible_cards())]
    if any(hasattr(d, "slice_index") for d in devs):
        devs = sorted(devs, key=lambda d: (_slice_of(d),
                                           getattr(d, "id", 0)))
    if n_slices <= 0 or len(devs) % n_slices:
        raise ValueError(
            f"{len(devs)} devices do not split into {n_slices} slices")
    per_slice = len(devs) // n_slices
    hw_slices = {_slice_of(d) for d in devs}
    if len(hw_slices) > 1:
        # Every mesh row must stay within one hardware slice.
        for row_start in range(0, len(devs), per_slice):
            row = devs[row_start:row_start + per_slice]
            if len({_slice_of(d) for d in row}) > 1:
                raise ValueError(
                    f"n_slices={n_slices} does not match the hardware "
                    f"slice grouping ({len(hw_slices)} slices of "
                    f"{len(devs) // len(hw_slices)} devices); a mesh "
                    "row would straddle a DCN boundary")
    return DocMesh(devs, (n_slices, per_slice), (SLICE_AXIS, DOC_AXIS))


def _doc_spec(mesh: DocMesh) -> tuple:
    """The document axis spans ALL mesh axes, flattened in order: on a
    1-D mesh ``("docs",)``, on a ``dcn_mesh`` ``("slice", "docs")``."""
    return tuple(mesh.axis_names)


def _pad_docs(docs: Sequence, multiple: int, make_pad):
    """Pad the doc list to a multiple of the mesh size with empty
    documents (noop streams) so the doc axis splits evenly."""
    docs = list(docs)
    while len(docs) % multiple:
        docs.append(make_pad())
    return docs


def _shard_put(mesh: DocMesh, tree):
    """Host arrays split into the mesh's parts, each copied to its
    device (``ops.parts.Parts``)."""
    return put_parts(tree, mesh.flat)


def _wait(mesh: DocMesh) -> None:
    """Wait for every part's work on its device (the honest boundary
    between the fold and the copies)."""
    for dev in dict.fromkeys(mesh.flat):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _leaf_list(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _leaf_list(x)]
    return [tree]


def _concat(parts_np):
    """Per-part host results (a leaf or a tuple of leaves each) joined
    along the document axis in mesh order."""
    if isinstance(parts_np[0], tuple):
        return tuple(np.concatenate(leaves) for leaves in zip(*parts_np))
    return np.concatenate(parts_np)


def _fetch_parts(family, core: Parts):
    return _concat([family.fetch(part) for part in core])


def _gather_parts(family, core: Parts, idx: np.ndarray):
    """``(rows, moved_bytes)`` of the documents ``idx`` of an export
    placed on parts.  One part: the family's own gather.  Several: the
    reference's rule for a buffer spread over devices — ``idx`` padded to
    ``next_bucket_fine(m, floor=8)`` rows (the pad rows cross and are
    counted), each part gathering its share on its device, or the whole
    buffer when the padded count reaches its rows."""
    if len(core) == 1:
        return family.gather_rows(core[0], idx)
    rows = np.asarray(idx, np.intp)
    m = rows.shape[0]
    bucket = next_bucket_fine(m, floor=8)
    lead = [part if isinstance(part, tuple) else (part,) for part in core]
    total = sum(int(p[0].shape[0]) for p in lead)
    if bucket >= total:
        full = _fetch_parts(family, core)
        moved = sum(a.nbytes for a in _leaf_list(full))
        got = tuple(a[rows] for a in full) if isinstance(full, tuple) \
            else full[rows]
        return got, moved
    padded = np.concatenate([rows, np.repeat(rows[-1:], bucket - m)])
    per_leaf: List[list] = [[] for _ in lead[0]]
    lo = 0
    for leaves in lead:
        hi = lo + int(leaves[0].shape[0])
        local = padded[(padded >= lo) & (padded < hi)] - lo
        if local.size:
            for j, leaf in enumerate(leaves):
                sel = torch.from_numpy(local.astype(np.int64)).to(
                    leaf.device)
                per_leaf[j].append(
                    torch.index_select(leaf, 0, sel).cpu().numpy())
        lo = hi
    fetched = [np.concatenate(chunks) for chunks in per_leaf]
    moved = sum(a.nbytes for a in fetched)
    got = [a[:m] for a in fetched]
    return (tuple(got) if isinstance(core[0], tuple) else got[0]), moved


def replay_family_sharded(
    family,
    docs: Sequence,
    mesh: Optional[DocMesh] = None,
    stats: Optional[dict] = None,
    stage: Optional[dict] = None,
    pack_cache=None,
    delta_cache=None,
    device_cache=None,
) -> List[SummaryTree]:
    """THE generic doc-sharded catch-up fold: pack → narrow → split over
    the mesh → the family's fold+export on each part's device → shared
    host extraction, serving the one-device pipeline's four cache tiers
    and stage schema — ``pack_cache`` (tier 2 suffix reuse),
    ``delta_cache`` (tier 0: only the digest plane and changed documents'
    rows cross d2h), ``device_cache`` (tier 2.5, placed on the mesh:
    exact hits upload nothing, suffix hits splice each part in place) —
    with ``stage`` accumulating the ``pack``/``upload``/``dispatch``/
    ``device_wait``/``download``/``extract`` busy split, the
    ``pack_cpu``/``extract_cpu`` twins, plus ``h2d_bytes``/``d2h_bytes``
    (each leg a ``pipeline.<leg>`` span while a profiler runs).  Every
    family decision rides the ``KernelFamily`` hooks
    (``dispatch_sharded``, ``make_pad``, ``pad_token`` for the mesh).
    ``stats`` accumulates ``device_docs`` / ``fallback_docs`` (+ the
    per-reason split) as the batch entry points do, plus ``delta_docs``
    for tier-0 serves.  The whole batch is one
    chunk, padded to a multiple of ``mesh.size``, as in the reference."""
    from ..ops.batching import partition_replay
    from ..ops.pipeline import (
        _count_d2h,
        _count_h2d,
        _leg,
        _nbytes,
        _np_nbytes,
        delta_merge_changed,
        delta_route,
        delta_store_all,
        delta_sub_meta,
        merge_extract_counts,
        seed_stage,
    )

    seed_stage(stage)
    if mesh is None:
        mesh = doc_mesh()
    if device_cache is not None:
        device_cache.set_sharding(mesh)

    def _bump_stats(st: dict) -> None:
        merge_extract_counts(st, stats, stage)

    def fold_batch_export(batch):
        n_real = len(batch)
        pad_base = len(batch)
        padded = _pad_docs(batch, mesh.size, family.make_pad)
        # Pad docs carry a deterministic token so the padded chunk's
        # token tuple keys tiers 2/2.5 (any None would bypass both) —
        # but only when every REAL doc is tokened; a mixed chunk
        # bypasses anyway and must keep doing so.
        if family.pad_token is not None \
                and all(d.cache_token is not None for d in batch):
            for k in range(pad_base, len(padded)):
                padded[k].cache_token = family.pad_token(k)
        with _leg(stage, "pack"):
            if pack_cache is not None:
                state, ops, meta = pack_cache.pack(padded)
            else:
                state, ops, meta = family.pack(padded)
            state_n, ops_n = family.narrow(padded, state, ops, meta)
        want_digest = delta_cache is not None

        # --- upload leg: the resident tier or a split upload a part;
        # h2d_bytes counts what really crossed either way.
        with _leg(stage, "upload"):
            aux_dev = None
            if device_cache is not None:
                state_u, ops_u, aux_dev, up_bytes = device_cache.acquire(
                    state_n, ops_n, meta)
                if not isinstance(ops_u, Parts):
                    # Bypass route (token-less chunk): split like the
                    # plain path so the parts still fold on their devices.
                    ops_u = _shard_put(mesh, ops_u)
                    state_u = _shard_put(mesh, state_u)
            else:
                up_bytes = _np_nbytes(state_n) + _np_nbytes(ops_n)
                ops_u = _shard_put(mesh, ops_n)
                state_u = _shard_put(mesh, state_n)
            if aux_dev is None:
                aux_host = family.aux(meta, want_digest)
                up_bytes += _np_nbytes(tuple(_leaf_list(aux_host)))
                aux_dev = _shard_put(mesh, aux_host)
        _count_h2d(stage, up_bytes)

        # --- dispatch a part + honest device wait.
        with _leg(stage, "dispatch"):
            export = family.dispatch_sharded(mesh, state_u, ops_u, meta,
                                             want_digest, aux_dev)
            split = [family.split_digest(part, want_digest)
                     for part in export]
            core = Parts(c for c, _d in split)
            dig = Parts(d for _c, d in split) if want_digest else None
        with _leg(stage, "device_wait"):
            _wait(mesh)

        # Pad trimming: served/changed/extraction all operate on the
        # REAL prefix (pads sit at the tail), so stats and the tier-0
        # entries never see a pad.
        meta_real = dict(
            meta,
            docs=meta["docs"][:n_real],
            doc_packs=meta["doc_packs"][:n_real],
        )
        for key in family.per_doc_meta:
            if key in meta:
                meta_real[key] = np.asarray(meta[key])[:n_real]
        real_docs = meta_real["docs"]

        def trim(ex_np):
            return tuple(a[:n_real] for a in ex_np) \
                if isinstance(ex_np, tuple) else ex_np[:n_real]

        def extract(meta_x, arr, extra=()):
            st: dict = {}
            with _leg(stage, "extract"):
                res = family.extract(meta_x, arr, st)
                for fn in extra:
                    fn(res)
            _bump_stats(st)
            return res

        def fetch_full():
            # d2h_bytes counts the PADDED buffer — that is what crosses
            # the link; pads trim host-side after the transfer.
            with _leg(stage, "download"):
                raw = _fetch_parts(family, core)
            _count_d2h(stage, _nbytes(raw))
            return trim(raw)

        if dig is None:
            return extract(meta_real, fetch_full())
        with _leg(stage, "download"):
            dig_full = _fetch_parts(family, dig)  # the full padded plane
        _count_d2h(stage, dig_full.nbytes)
        dig_np = dig_full[:n_real]
        # The shared tier-0 decision + entry publication (one derivation
        # point with the one-device pipeline); pads never enter the
        # handshake.
        route, served, changed = delta_route(real_docs, dig_np,
                                             delta_cache)
        if route == "full":
            def store(res):
                delta_store_all(delta_cache, real_docs, dig_np, res)

            return extract(meta_real, fetch_full(), extra=(store,))
        if route == "served":
            delta_cache.note_bytes_saved(
                sum(leaf.nbytes for leaf in _leaf_list(core)))
            _bump_stats({"delta_docs": len(real_docs)})
            return [served[d] for d in range(len(real_docs))]
        with _leg(stage, "download"):
            sub, fetched = _gather_parts(family, core,
                                         np.asarray(changed, np.int32))
        _count_d2h(stage, fetched)
        delta_cache.note_bytes_saved(max(
            0, sum(leaf.nbytes for leaf in _leaf_list(core)) - fetched))
        st: dict = {}
        with _leg(stage, "extract"):
            got = family.extract(
                delta_sub_meta(meta_real, changed, family.per_doc_meta),
                sub, st)
            res = delta_merge_changed(delta_cache, meta_real, dig_np,
                                      served, changed, got)
        st["delta_docs"] = st.get("delta_docs", 0) + len(served)
        _bump_stats(st)
        return res

    return partition_replay(
        docs, family.known_fallback, family.fallback_summary,
        fold_batch_export, stats=stats,
    )


def replay_mergetree_sharded(
    docs: Sequence[MergeTreeDocInput],
    mesh: Optional[DocMesh] = None,
    stats: Optional[dict] = None,
    stage: Optional[dict] = None,
    pack_cache=None,
    delta_cache=None,
    device_cache=None,
) -> List[SummaryTree]:
    """Doc-sharded merge-tree catch-up replay — the merge-tree instance
    of :func:`replay_family_sharded` (K1's fold+export once a part).
    Byte-identical to the one-device path and the CPU oracle; uploads
    the narrow encodings and fetches the same export buffer."""
    from ..ops.pipeline import MERGETREE_FAMILY

    return replay_family_sharded(
        MERGETREE_FAMILY, docs, mesh=mesh, stats=stats, stage=stage,
        pack_cache=pack_cache, delta_cache=delta_cache,
        device_cache=device_cache,
    )


def _doc_groups(n_docs: int, n_parts: int) -> list:
    """Contiguous runs of documents, one a part, sizes differing by at
    most one (the first ``n_docs % n_parts`` parts one longer)."""
    base, extra = divmod(n_docs, n_parts)
    out, lo = [], 0
    for i in range(n_parts):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def map_sharded_replay_step(mesh: DocMesh):
    """The per-part LWW reduction: ``step(batches)`` launches K7
    (``map_lww_cuda.lww``) once for each packed part (a
    ``map_kernel._PackedBatch``, or None for an empty part) on the
    part's device, and returns each part's ``(present, win_val)`` on
    that device (None for an empty part).  Every part holds whole
    documents, so its per-key maxima are complete: no combine across
    parts."""
    from ..ops.map_kernel import lww_inputs
    from ..ops.map_lww_cuda import lww

    def step(batches):
        return [None if batch is None else
                lww(lww_inputs(batch, dev), batch.num_docs)
                for batch, dev in zip(batches, mesh.flat)]

    return step


def replay_map_sharded(docs, mesh: Optional[DocMesh] = None,
                       stats: Optional[dict] = None) -> List[SummaryTree]:
    """Doc-sharded SharedMap catch-up replay; byte-compatible with
    ``replay_map_batch`` and the CPU oracle.  The batch splits on
    document boundaries into ``mesh.size`` contiguous runs, each packed
    on its own, so every key's rows stay on one part.  ``stats``
    accumulates ``device_docs`` like the batch entry point (the LWW
    reduction has no fallback cases)."""
    from ..ops.map_kernel import pack_map_batch, summaries_from_lww

    if not docs:
        return []
    if stats is not None:
        stats["device_docs"] = stats.get("device_docs", 0) + len(docs)
    if mesh is None:
        mesh = doc_mesh()
    groups = _doc_groups(len(docs), mesh.size)
    batches = [pack_map_batch(docs[lo:hi]) if hi > lo else None
               for lo, hi in groups]
    results = map_sharded_replay_step(mesh)(batches)
    out: List[SummaryTree] = []
    for batch, res in zip(batches, results):
        if batch is not None:
            present, win_val = res
            out.extend(summaries_from_lww(batch, present.cpu(),
                                          win_val.cpu()))
    return out


def matrix_sharded_replay_step(mesh: DocMesh):
    """The per-part matrix fold: ``step(state, ops, cold, S)`` with
    ``ops`` (and ``state``, None for a cold batch) placed on the mesh's
    parts (``ops.parts.Parts``) launches K4
    (``matrix_fold_cuda.fold_resolving``) once a part on the part's
    device; returns each part's ``(final, resolved, violations)`` on its
    device.  The caller checks each part's violations
    (``matrix_kernel.download_matrix_fold`` does)."""
    from ..ops.matrix_fold_cuda import fold_resolving

    def step(state, ops, cold: bool, S: int):
        states = state if state is not None else (None,) * len(ops)
        return [fold_resolving(s, o, cold=cold, S=S)
                for s, o in zip(states, ops)]

    return step


def _merge_matrix_parts(downloads):
    """Per-part ``download_matrix_fold`` results → one host state dict
    and resolved array over every stream, in order (slot planes padded
    to the widest part; extraction reads a stream only up to its n)."""
    states = [d[0] for d in downloads]
    width = max(s["tstart"].shape[1] for s in states)
    out = {}
    for key in states[0]:
        planes = [s[key] for s in states]
        if planes[0].ndim == 2:
            planes = [np.pad(p, ((0, 0), (0, width - p.shape[1])))
                      for p in planes]
        out[key] = np.concatenate(planes)
    return out, np.concatenate([d[1] for d in downloads])


def replay_matrix_sharded(
    docs, mesh: Optional[DocMesh] = None, step=None,
    stats: Optional[dict] = None,
) -> List[SummaryTree]:
    """Doc-sharded SharedMatrix catch-up replay (see
    :func:`replay_mergetree_sharded`).  Matrices pack as TWO axis streams
    each, so the doc list pads to ``size // gcd(size, 2)`` documents to
    keep the ``[2D]`` axis evenly split; K4 runs once a part and every
    part's violated facts are checked.  ``stats`` accumulates
    ``device_docs``/``fallback_docs`` like the batch entry point
    (pre-pack routing + per-axis overflow fallbacks)."""
    from ..ops.batching import partition_replay
    from ..ops.matrix_kernel import (
        MatrixDocInput,
        download_matrix_fold,
        known_matrix_fallback,
        oracle_matrix_fallback,
        pack_matrix_batch,
        summary_from_matrix_state,
    )

    if mesh is None:
        mesh = doc_mesh()
    the_step = step if step is not None else (
        matrix_sharded_replay_step(mesh) if docs else None)

    def fold_batch(batch):
        n_real = len(batch)
        # Pad the doc count so 2·D is divisible by the mesh size for ANY
        # size (odd meshes need D to be a multiple of the size itself).
        doc_mult = mesh.size // math.gcd(mesh.size, 2)
        padded = _pad_docs(
            batch, max(1, doc_mult),
            lambda: MatrixDocInput(doc_id="\x00pad", ops=[]))
        state, ops, meta = pack_matrix_batch(padded)
        ops_p = _shard_put(mesh, ops)
        state_p = None if meta["cold"] else _shard_put(mesh, state)
        parts = the_step(state_p, ops_p, meta["cold"],
                         state.tstart.shape[1])
        state_np, resolved_np = _merge_matrix_parts(
            [download_matrix_fold(*part) for part in parts])
        return [
            summary_from_matrix_state(meta, state_np, resolved_np, d,
                                      stats=stats)
            for d in range(n_real)
        ]

    return partition_replay(
        docs, known_matrix_fallback, oracle_matrix_fallback, fold_batch,
        stats=stats,
    )


def tree_sharded_replay_step(mesh: DocMesh):
    """The per-part tree edit-fold: ``step(state, edits)`` with both
    placed on the mesh's parts launches K5 (``tree_fold_cuda.fold``) once
    a part on its device; returns the final planes per part (``Parts``)
    and every document's overflow flag on the host, in order."""
    from ..ops.tree_fold_cuda import fold

    def step(state, edits):
        finals = Parts(fold(s, e) for s, e in zip(state, edits))
        overflow = np.concatenate([f.overflow.cpu().numpy()
                                   for f in finals])
        return finals, overflow

    return step


def replay_tree_sharded(
    docs, mesh: Optional[DocMesh] = None,
    stats: Optional[dict] = None,
    stage: Optional[dict] = None,
    pack_cache=None,
    delta_cache=None,
    device_cache=None,
) -> List[SummaryTree]:
    """Doc-sharded SharedTree catch-up replay — the second instance of
    :func:`replay_family_sharded` (K5's fold, with its digest under
    tier 0, once a part): the merge-tree route's tier stack and stage
    schema.  ``stats`` accumulates ``device_docs``/``fallback_docs``
    (with the per-reason split) like the batch entry point."""
    from ..ops.tree_pipeline import TREE_FAMILY

    return replay_family_sharded(
        TREE_FAMILY, docs, mesh=mesh, stats=stats, stage=stage,
        pack_cache=pack_cache, delta_cache=delta_cache,
        device_cache=device_cache,
    )

