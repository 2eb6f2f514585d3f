"""SharedTree as the second kernel family of the generic catch-up
pipeline: the port of ``fluidframework_tpu/ops/tree_pipeline.py``.

This module binds ``ops/tree_kernel.py`` into the tiers of
``ops/pipeline.py``:

- **tier 2** (:class:`~fluidframework_tpu_torch.ops.pipeline.PackCache`
  over :data:`TREE_FAMILY`): packed forest windows reuse across catch-ups
  — an exact edit-window hit costs a dict lookup, a grown tail packs ONLY
  its suffix messages onto copies of the cached planes through the SAME
  per-message fill the fresh pack uses (``fill_tree_doc_messages``).
  Tree suffixes also materialize new node/container rows; those land
  strictly in the per-document row suffixes of the state planes
  (interning is append-only), which is what makes the tier-2.5 splice
  sound;
- **tier 2.5** (:class:`~fluidframework_tpu_torch.ops.device_cache.
  DevicePackCache` with :class:`TreeDeviceOps`): forest and edit planes
  stay resident on the device; an exact window dispatches with zero h2d
  pack bytes, a lineage-proven grown tail uploads only its new edit rows
  and its new node/container rows, spliced in place along three row axes
  by ``resident_cuda.splice_row_groups`` (one launch for the three);
- **tier 0** (the family-agnostic ``DeltaExportCache``): the fold also
  writes a per-document ``[D, 2]`` digest of the final forest
  (:func:`tree_doc_digests`, masked to each document's used rows so
  bucket padding and neighbours' growth never perturb it); unchanged
  documents serve their cached summaries with no download, changed
  documents gather only their rows.

On the card the fold and its digest are one kernel,
``tree_fold_cuda.fold_digest`` (``csrc/tree_fold.cu``); without tier 0
it is ``tree_fold_cuda.fold``.  ``pipelined_tree_replay`` is the bulk
entry point with the reference's stage schema.  The reference's mesh
hooks (``make_pad``, ``pad_token``, ``dispatch_sharded``) wait for the
port's multi-GPU slice, as the merge-tree family's do.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..protocol.summary import SummaryTree
from .device_cache import DevicePackCache, gather_suffix_rows, tuple_sig
from .family import KernelFamily
from .interning import Interner
from .mergetree_kernel import (_mix_u32, export_to_numpy,
                               gather_export_rows)
from .parts import Parts, per_part
from .pipeline import (PackCache, _copy_interner, _mt_pad_token,
                       pipelined_family_replay)
from .tree_fold_cuda import fold, fold_digest
from .tree_kernel import (
    CONT_FIELDS,
    NODE_FIELDS,
    TreeDocInput,
    TreeEdits,
    TreeState,
    _DocPack,
    fill_tree_doc_messages,
    known_tree_fallback,
    oracle_fallback_summary,
    pack_tree_batch,
    scatter_tree_doc_rows,
    slice_tree_pack,
    summary_from_state,
    tree_buckets,
)
from .tree_native import value_table, write_headers

__all__ = [
    "TREE_FAMILY",
    "TreeDeviceOps",
    "pipelined_tree_replay",
    "summaries_from_tree_export",
    "tree_device_cache",
    "tree_doc_digests",
    "tree_pack_cache",
]


# ---------------------------------------------------------------------------
# The digest over the final forest (the tier-0 gate)
# ---------------------------------------------------------------------------

#: the digest's salt index is a plane's place in NODE_FIELDS; container
#: planes (CONT_FIELDS) follow at _CONT_SALT_BASE
_CONT_SALT_BASE = 8
#: XORed into active values, so a stored 0 at an active position never
#: aliases a masked (padding) position's zero contribution
_ACTIVE_XOR = 0xA5A5A5A5
_LANE_SALTS = (0x9E3779B9, 0x85EBCA6B)
_U32 = 0xFFFFFFFF


def tree_doc_digests(final: TreeState, n_nodes: torch.Tensor,
                     n_cont: torch.Tensor) -> torch.Tensor:
    """``[D, 2]`` int32 digest of each document's final forest, bit for
    bit the reference's ``tree_doc_digests``: only the rows a document
    interned (``idx < n_nodes[d]`` / ``idx < n_cont[d]``) count, weights
    are salted by plane and row, active values XOR a constant, and
    ``n_nodes``, ``n_cont`` and ``overflow`` are mixed in; two
    independently salted 32-bit lanes.  The reference's uint32
    arithmetic runs here in int64 masked to 32 bits."""
    D, N = final.next.shape
    C = final.head.shape[1]
    dev = final.next.device
    n_nodes = n_nodes.to(device=dev, dtype=torch.int64)
    n_cont = n_cont.to(device=dev, dtype=torch.int64)
    node_idx = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    cont_idx = torch.arange(C, device=dev, dtype=torch.int64)[None, :]
    act_n = node_idx < n_nodes[:, None]
    act_c = cont_idx < n_cont[:, None]

    def weighted(plane, idx, active, salt_id, salt):
        v = torch.where(active, (plane.to(torch.int64) & _U32) ^ _ACTIVE_XOR,
                        0)
        w = _mix_u32((idx * 0x01000193 + salt_id + salt) & _U32)
        return (v * w & _U32).sum(dim=1)

    lanes = []
    for salt in _LANE_SALTS:
        acc = torch.zeros((D,), dtype=torch.int64, device=dev)
        for i, f in enumerate(NODE_FIELDS):
            acc = acc + weighted(getattr(final, f), node_idx, act_n, i, salt)
        for i, f in enumerate(CONT_FIELDS):
            acc = acc + weighted(getattr(final, f), cont_idx, act_c,
                                 _CONT_SALT_BASE + i, salt)
        acc = acc & _U32
        acc = acc ^ _mix_u32((n_nodes + salt) & _U32)
        acc = acc ^ _mix_u32((n_cont * 3 + salt) & _U32)
        acc = acc ^ torch.where(final.overflow, 0x5BD1E995, 0)
        lanes.append(_mix_u32(acc))
    out = torch.stack(lanes, dim=-1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


# ---------------------------------------------------------------------------
# Dispatch / extraction (the family's export legs)
# ---------------------------------------------------------------------------


def _tree_aux(meta: dict, digest: bool):
    """Per-document used-row counts — the digest's mask inputs (tiny [D]
    planes; uploaded, or served resident by tier 2.5)."""
    return (np.asarray(meta["n_nodes"], np.int32),
            np.asarray(meta["n_cont"], np.int32))


def _tree_dispatch(state: TreeState, edits: TreeEdits, meta: dict,
                   digest: bool, aux_dev):
    """The fold+export on the device: the 10 final forest planes in
    ``TreeState`` field order (``overflow`` rides as a bool plane — the
    host routes MAX_DEPTH fallbacks off it) and, under ``digest``, the
    ``[D, 2]`` digest plane LAST."""
    if not digest:
        return tuple(fold(state, edits))
    n_nodes, n_cont = aux_dev
    final, dig = fold_digest(state, edits, n_nodes, n_cont)
    return tuple(final) + (dig,)


def _tree_dispatch_sharded(mesh, state: TreeState, edits: TreeEdits,
                           meta: dict, digest: bool, aux_dev):
    """The fold+export per part of ``mesh``: the one-device dispatch on
    each part's device (``ops.parts.Parts`` in, ``Parts`` out).  The fold
    is per document: no collective."""
    return Parts(_tree_dispatch(s, e, meta, digest, a)
                 for s, e, a in zip(state, edits, aux_dev))


def _split_tree_digest(export, digested: bool):
    """``(core, digest_or_None)``: the digest plane rides LAST."""
    if not digested:
        return export, None
    return export[:-1], export[-1]


def summaries_from_tree_export(meta, arr, stats: Optional[dict] = None,
                               counts: Optional[dict] = None) -> List:
    """Downloaded final-forest planes → canonical summaries, routing
    pack-time and overflow fallbacks to the oracle (counted per reason).
    ``arr`` is the fetched core tuple in ``TreeState`` field order —
    either a whole chunk's rows or the tier-0 changed-rows gather (the
    meta is then the sliced sub-meta).

    A document the pack kept, whose fold did not overflow and which keeps
    no attribution has its header written by the native writer
    (``tree_native.write_headers``, one call for all of them); every other
    document, and one the writer leaves (a chain cycle among them), takes
    ``summary_from_state``, the same bytes and counts in Python.
    ``counts`` (when given) gets the forest nodes written
    (``extract_nodes``) and the documents the writer wrote
    (``extract_native_docs``)."""
    state_np = dict(zip(TreeState._fields, arr))
    docs, packs = meta["docs"], meta["doc_packs"]
    overflow = np.asarray(state_np["overflow"]).tolist()
    rows = [d for d in range(len(docs))
            if not packs[d].needs_fallback and not overflow[d]
            and not docs[d].attribution]
    written = write_headers(meta, state_np, rows) if rows else None
    out: List = [None] * len(docs)
    if written is not None:
        native = nodes = 0
        for d, (header, emitted) in zip(rows, written):
            if header is not None:
                out[d] = SummaryTree().add_blob("header", header)
                native += 1
                nodes += emitted
        if native:
            if stats is not None:
                stats["device_docs"] = stats.get("device_docs", 0) + native
            if counts is not None:
                for key, n in (("extract_nodes", nodes),
                               ("extract_native_docs", native)):
                    counts[key] = counts.get(key, 0) + n
    for d, tree in enumerate(out):
        if tree is None:
            out[d] = summary_from_state(meta, state_np, d, stats=stats,
                                        counts=counts)
    return out


def _tree_narrow(chunk, state, edits, meta):
    """No transfer narrowing for the forest planes (all int32; the linked
    list indices and seqs span the int32 range at bucket scale) — state
    uploads cold AND warm (a cold document's base rows are the
    materialized insert blocks)."""
    return state, edits


# ---------------------------------------------------------------------------
# Tier 2: the suffix extension (family ``extend`` hook)
# ---------------------------------------------------------------------------


def _copy_tree_pack(pack: _DocPack) -> _DocPack:
    out = _DocPack.__new__(_DocPack)
    out.node_ids = _copy_interner(pack.node_ids)
    out.node_types = list(pack.node_types)
    out.containers = _copy_interner(pack.containers)
    out.fallback_reason = pack.fallback_reason
    out.header_seq = pack.header_seq
    out.base_min_seq = pack.base_min_seq
    out.removal_time = dict(pack.removal_time)
    out.boundary = pack.boundary
    return out


def _extend_tree(entry, chunk: Sequence[TreeDocInput]):
    """Pack only each document's suffix messages on top of the cached
    forest planes; None = the shape buckets do not hold (the caller packs
    in full).

    Soundness: interning is append-only (old node/container indices are
    stable), and per-message fills only MATERIALIZE new rows — a suffix
    edit naming an existing node adds an edit row, never rewrites a
    packed state row — so the combined arrays are the cached arrays plus
    per-document row suffixes, written through the SAME fill/scatter
    helpers as a fresh pack."""
    meta = entry.meta
    T = entry.ops.kind.shape[1]
    N = entry.state.next.shape[1]
    C = entry.state.head.shape[1]
    # The sizing predicate over the COMBINED windows must land in the
    # SAME buckets (estimates bound the used rows, so an equal bucket
    # proves the cached arrays are large enough); tree_buckets is the one
    # derivation point, shared with the fresh pack.
    if tree_buckets(chunk) != (N, T):
        return None

    values: Interner = meta["values"]  # shared, append-only
    doc_packs = [_copy_tree_pack(p) for p in meta["doc_packs"]]
    filled = []
    try:
        for d, doc in enumerate(chunk):
            pack = doc_packs[d]
            suffix = doc.ops[entry.n_ops[d]:]
            node_rows, chains, edit_rows = {}, {}, []
            fill_tree_doc_messages(pack, values, node_rows, chains,
                                   edit_rows, suffix)
            filled.append((node_rows, chains, edit_rows))
    except ValueError:
        # An edit shape this fill does not know degrades to a full pack
        # (which raises the same error if the edit is malformed), never
        # a crash only when warm.  Interner appends already made are
        # unreferenced and harmless.
        return None
    old_t = entry.t_rows
    if any(len(p.containers) > C for p in doc_packs) \
            or any(len(p.node_ids) > N for p in doc_packs) \
            or any(old_t[d] + len(rows) > T
                   for d, (_n, _c, rows) in enumerate(filled)):
        return None  # container bucket (unsized by the estimate) grew
    old_n = np.asarray(meta["n_nodes"])
    for d, (node_rows, _chains, _rows) in enumerate(filled):
        if node_rows and min(node_rows) < int(old_n[d]):
            # A suffix spec re-interned an EXISTING node id (nothing
            # validates client-minted ids): the rewrite lands BELOW the
            # cached row watermark, which the resident splice (rows at
            # or past the watermark only) could never mirror.  A full
            # repack keeps every tier byte-exact.
            return None

    # Commit: copy the cached planes (the entry must stay intact) and
    # scatter ONLY the new rows through the shared scatter.
    st = {f: np.copy(getattr(entry.state, f)) for f in TreeState._fields}
    ed = {f: np.copy(getattr(entry.ops, f)) for f in TreeEdits._fields}
    old_cont = np.asarray(meta["n_cont"])
    for d, (node_rows, chains, edit_rows) in enumerate(filled):
        scatter_tree_doc_rows(st, ed, d, node_rows, chains, edit_rows,
                              doc_packs[d].containers.values,
                              t_base=int(old_t[d]),
                              cont_start=int(old_cont[d]))
    new_meta = dict(
        meta,
        docs=list(chunk),
        doc_packs=doc_packs,
        value_json=value_table(values),
        n_nodes=np.asarray([len(p.node_ids) for p in doc_packs],
                           np.int32),
        n_cont=np.asarray([len(p.containers) for p in doc_packs],
                          np.int32),
        t_rows=np.asarray(
            [int(old_t[d]) + len(rows)
             for d, (_n, _c, rows) in enumerate(filled)], np.int32),
    )
    return TreeState(**st), TreeEdits(**ed), new_meta


def _tree_entry_rows(chunk, meta):
    return [int(x) for x in np.asarray(meta["t_rows"])]


def _tree_entry_nbytes(state, edits, meta) -> int:
    # The retained HOST meta rides the entry too: the shared value
    # interner plus each document's id/container interners and purge
    # bookkeeping (flat per-item estimates, as the reference's: the LRU
    # budget tracks real memory, not just the int32 planes).
    host = len(meta["values"]) * 8
    for p in meta["doc_packs"]:
        host += (len(p.node_ids) + len(p.containers)) * 64
        host += (len(p.removal_time) + len(p.node_types)) * 32
    return int(sum(np.asarray(x).nbytes for x in edits)
               + sum(np.asarray(x).nbytes for x in state) + host)


# ---------------------------------------------------------------------------
# Tier 2.5: the tree device-ops (three splice axes)
# ---------------------------------------------------------------------------


#: the ``[D, N]`` node-axis planes of :class:`TreeState` — the second
#: splice group (suffix inserts materialize new node rows) — and the
#: ``[D, C]`` container-axis planes, the third
_TreeNodePlanes = collections.namedtuple("_TreeNodePlanes", NODE_FIELDS)
_TreeContPlanes = collections.namedtuple("_TreeContPlanes", CONT_FIELDS)


def _group(tuple_type, tree):
    return tuple_type(*(getattr(tree, f) for f in tuple_type._fields))


class TreeDeviceOps:
    """The tree family's tier-2.5 hooks.  Every plane is int32 (no
    narrow encodings, so ``migrate`` is a no-op and a moved signature is
    a real bucket change), the aux planes are the per-document used-row
    counts the digest masks by, and a suffix splice writes THREE row
    axes in place: edit rows, plus the node and container state rows the
    suffix's inserts materialized."""

    @staticmethod
    def bypass(docs) -> bool:
        return any(TREE_FAMILY.bypass(d) for d in docs)

    @staticmethod
    def sig(state, edits) -> tuple:
        return tuple_sig(state, edits)

    @staticmethod
    def aux(meta):
        return TREE_FAMILY.aux(meta, True)

    @staticmethod
    def t_rows(host_edits) -> np.ndarray:
        return np.count_nonzero(
            np.asarray(host_edits.kind), axis=1).astype(np.int32)

    @staticmethod
    def entry_aux(meta):
        """Host row-count snapshot the NEXT splice diffs against: the
        family's aux, as ``aux`` uploads it."""
        return TREE_FAMILY.aux(meta, True)

    def migrate(self, cache, tokens, entry, sig, docs) -> None:
        return  # int32-only planes: no encoding flip exists

    def splice(self, cache: DevicePackCache, entry, docs, state: TreeState,
               edits: TreeEdits, meta: dict) -> Optional[int]:
        """Upload only the suffix rows of the three axes and splice them
        into the resident planes in place; returns the uploaded bytes
        (the reference's count), or None when the extension does not
        apply (the caller uploads in full)."""
        t_new = self.t_rows(edits)
        t_old = np.asarray(entry.t_rows, np.int32)
        n_new, c_new = self.aux(meta)
        n_old, c_old = entry.aux
        if np.any(t_new < t_old) or np.any(n_new < n_old) \
                or np.any(c_new < c_old):
            return None
        # Every host gather before the first splice: a bail after one
        # would leave the entry half spliced.
        ed_rows, _ = gather_suffix_rows(TreeEdits, edits, t_old, t_new)
        if ed_rows is None:
            return None  # suffix ~ whole buffer: full upload is cheaper
        node_rows = cont_rows = None
        if np.any(n_new > n_old):
            node_rows, _ = gather_suffix_rows(
                _TreeNodePlanes, _group(_TreeNodePlanes, state),
                n_old, n_new)
            if node_rows is None:
                return None
        if np.any(c_new > c_old):
            cont_rows, _ = gather_suffix_rows(
                _TreeContPlanes, _group(_TreeContPlanes, state),
                c_old, c_new)
            if cont_rows is None:
                return None
        uploaded, splices = 0, []
        for group, rows, old, new in (
                (TreeEdits, ed_rows, t_old, t_new),
                (_TreeNodePlanes, node_rows, n_old, n_new),
                (_TreeContPlanes, cont_rows, c_old, c_new)):
            if rows is None:
                continue
            uploaded += sum(v.nbytes for v in rows.values()) \
                + 2 * new.nbytes
            resident = entry.ops if group is TreeEdits \
                else per_part(lambda st, g=group: _group(g, st),
                              entry.state)
            splices.append((resident, group, rows, old, new - old))
        cache.splice_groups(splices)  # the axes in one launch (a part)
        # The digest masks by the NEW counts: refresh the resident aux
        # planes (a tiny upload, counted).
        entry.base = cache.put_tree((n_new, c_new))
        uploaded += 2 * n_new.nbytes
        # Advance the splice watermark: the NEXT splice gathers only rows
        # past THIS one.
        entry.t_rows = t_new
        return int(uploaded)


# ---------------------------------------------------------------------------
# The family instance + public entry points
# ---------------------------------------------------------------------------


TREE_FAMILY = KernelFamily(
    name="tree",
    known_fallback=known_tree_fallback,
    fallback_summary=oracle_fallback_summary,
    pack=pack_tree_batch,
    bypass=lambda d: d.records is not None,
    entry_rows=_tree_entry_rows,
    entry_nbytes=_tree_entry_nbytes,
    extend=_extend_tree,
    order=lambda batch, schedule: list(range(len(batch))),
    narrow=_tree_narrow,
    aux=_tree_aux,
    dispatch=_tree_dispatch,
    split_digest=_split_tree_digest,
    chunk_tag=lambda meta: None,
    fetch=export_to_numpy,
    gather_rows=gather_export_rows,
    extract=lambda meta, arr, st: summaries_from_tree_export(
        meta, arr, stats=st, counts=st),
    per_doc_meta=("n_nodes", "n_cont", "t_rows"),
    slice_pack=slice_tree_pack,
    make_pad=lambda: TreeDocInput(doc_id="\x00pad", ops=[]),
    pad_token=_mt_pad_token,
    dispatch_sharded=_tree_dispatch_sharded,
)


def tree_pack_cache(max_bytes: int = 192 << 20) -> PackCache:
    """A tier-2 pack cache bound to the tree family."""
    return PackCache(max_bytes, family=TREE_FAMILY)


def tree_device_cache(max_bytes: int = 192 << 20,
                      device="cuda") -> DevicePackCache:
    """A tier-2.5 device-resident cache bound to the tree family, on
    ``device`` (the card by default)."""
    return DevicePackCache(max_bytes, device=device,
                           device_ops=TreeDeviceOps())


def pipelined_tree_replay(docs: Sequence[TreeDocInput], **kwargs):
    """Bulk SharedTree catch-up through the generic pipeline and its
    tiers: ``pipelined_family_replay`` over :data:`TREE_FAMILY` (the
    reference's signature; ``device`` defaults to the card).
    Byte-identical to ``replay_tree_batch`` and the ``dds/tree.py``
    oracle with every tier on, off, or freshly invalidated."""
    return pipelined_family_replay(TREE_FAMILY, docs, **kwargs)
