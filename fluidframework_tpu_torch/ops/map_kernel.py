"""SharedMap last-writer-wins catch-up replay in PyTorch.

Counterpart of ``fluidframework_tpu/ops/map_kernel.py``.  The host half
(``MapDocInput``, ``pack_map_batch``, ``summaries_from_lww``) is a copy
of the reference's: the same interners, buckets, padding and key order.
The device half is the reference's ``_map_lww_kernel``, three segment
reductions over the flat batch of every document's set / delete / clear
rows:

    max_seq[g]    = max op seq of key g            (per (doc, key))
    last_clear[d] = max clear seq of document d
    win_set[g], win_val[g] = max of is_set / val_idx over the winner rows
                    (op_seq == max_seq[key_gid]; other rows count as -1)
    present[g]    = win_set[g] == 1 & max_seq[g] > last_clear[key_doc[g]]

- ``map_lww_reference`` — the plain PyTorch version (``scatter_reduce_``
  with ``"amax"`` from ``INT32_MIN``, as ``jax.ops.segment_max`` leaves an
  empty segment);
- ``ops.map_lww_cuda.lww`` — the hand-written CUDA kernel (CUDA tensors)
  or the plain version (CPU tensors);
- ``replay_map_batch`` — the entry point: pack, upload, reduce, download,
  summaries.

Sequence numbers are unique, so "the op with the max seq" is exact and the
result does not depend on the order of the reductions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .interning import Interner, next_bucket
from .mergetree_kernel import resolve_device

_NEG = np.int32(np.iinfo(np.int32).min)
INT32_MIN = int(_NEG)


@dataclass
class MapDocInput:
    """One document's catch-up work item."""

    doc_id: str
    ops: Sequence[SequencedMessage]  # map-kernel op contents, ascending seq
    base: Optional[Dict[str, Any]] = None  # data loaded from the summary


@dataclass
class _PackedBatch:
    key_gid: np.ndarray     # [N] global (doc, key) id for set/delete ops
    op_seq: np.ndarray      # [N]
    is_set: np.ndarray      # [N] 1=set, 0=delete
    val_idx: np.ndarray     # [N] interned value id (sets only)
    key_doc: np.ndarray     # [G] doc index per global key id
    clear_doc: np.ndarray   # [M] doc index per clear op
    clear_seq: np.ndarray   # [M]
    num_keys: int
    num_docs: int
    keys: List[tuple] = field(default_factory=list)   # gid -> (doc_idx, key str)
    values: Interner = field(default_factory=Interner)
    doc_ids: List[str] = field(default_factory=list)


class LWWInputs(NamedTuple):
    """The reduction's int32 inputs, as tensors (``lww_inputs``)."""

    key_gid: Any    # [N]
    op_seq: Any     # [N]
    is_set: Any     # [N]
    val_idx: Any    # [N]
    key_doc: Any    # [G]
    clear_doc: Any  # [M]
    clear_seq: Any  # [M]


def pack_map_batch(docs: Sequence[MapDocInput],
                   bucket_floor: int = 64) -> _PackedBatch:
    """Flatten a multi-document op log into device arrays (host side).

    ``bucket_floor`` sets the minimum flat-array bucket; mesh-sharded
    callers pass the mesh size so the op axis always splits evenly."""
    keys = Interner()
    values = Interner()
    key_gid, op_seq, is_set, val_idx = [], [], [], []
    clear_doc, clear_seq = [], []

    def add_set(doc_idx: int, key: str, seq: int, value: Any) -> None:
        key_gid.append(keys.intern((doc_idx, key)))
        op_seq.append(seq)
        is_set.append(1)
        val_idx.append(values.intern(value))

    for doc_idx, doc in enumerate(docs):
        if doc.base:
            for key, value in doc.base.items():
                add_set(doc_idx, key, 0, value)
        for msg in doc.ops:
            if msg.type is not MessageType.OP:
                continue
            op = msg.contents
            kind = op["kind"]
            if kind == "set":
                add_set(doc_idx, op["key"], msg.seq, op["value"])
            elif kind == "delete":
                key_gid.append(keys.intern((doc_idx, op["key"])))
                op_seq.append(msg.seq)
                is_set.append(0)
                val_idx.append(-1)
            elif kind == "clear":
                clear_doc.append(doc_idx)
                clear_seq.append(msg.seq)
            else:
                raise ValueError(f"unknown map op kind {kind!r}")

    floor = max(64, bucket_floor)

    def bucket(count: int) -> int:
        size = next_bucket(max(count, 1), floor=floor)
        if bucket_floor > 1 and size % bucket_floor:
            # Non-power-of-two mesh sizes (e.g. 5 devices) don't divide the
            # pow2 ladder — round up so the flat axis always shards evenly.
            size += bucket_floor - size % bucket_floor
        return size

    n = bucket(len(op_seq))
    m = bucket(len(clear_seq))
    g = bucket(len(keys))

    def pad(lst, size, fill):
        arr = np.full(size, fill, dtype=np.int32)
        arr[: len(lst)] = np.asarray(lst, dtype=np.int32) if lst else []
        return arr

    key_doc = pad([doc for doc, _ in keys.values], g, 0)
    return _PackedBatch(
        key_gid=pad(key_gid, n, g - 1 if len(keys) < g else 0),
        op_seq=pad(op_seq, n, int(_NEG)),
        is_set=pad(is_set, n, 0),
        val_idx=pad(val_idx, n, -1),
        key_doc=key_doc,
        clear_doc=pad(clear_doc, m, 0),
        clear_seq=pad(clear_seq, m, int(_NEG)),
        num_keys=g,
        num_docs=len(docs),
        keys=list(keys.values),
        values=values,
        doc_ids=[d.doc_id for d in docs],
    )


def lww_inputs(batch, device) -> LWWInputs:
    """The seven int32 arrays of a packed batch (read by attribute name)
    as tensors on ``device``."""
    return LWWInputs(*(torch.from_numpy(np.ascontiguousarray(
        getattr(batch, f), dtype=np.int32)).to(device)
        for f in LWWInputs._fields))


def _segment_max(values: torch.Tensor, ids: torch.Tensor,
                 segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment holds ``INT32_MIN`` and a
    row whose id lies outside ``[0, segments)`` is dropped."""
    out = torch.full((segments,), INT32_MIN, dtype=torch.int32,
                     device=values.device)
    keep = (ids >= 0) & (ids < segments)
    return out.scatter_reduce_(0, ids[keep].long(), values[keep], "amax",
                               include_self=True)


def _take_clamped(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` under XLA's gather rule: a negative index counts
    from the end, then every index is clamped into the array."""
    n = values.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return values[idx]


def map_lww_reference(inputs: LWWInputs, num_docs: int):
    """The plain PyTorch version of the reduction, on whatever device the
    tensors lie: ``(present [G] bool, win_val [G] int32)``, bit for bit the
    reference's ``_map_lww_kernel`` (padding entries included)."""
    G = inputs.key_doc.shape[0]
    max_seq = _segment_max(inputs.op_seq, inputs.key_gid, G)
    last_clear = _segment_max(inputs.clear_seq, inputs.clear_doc, num_docs)
    winner = inputs.op_seq == _take_clamped(max_seq, inputs.key_gid)
    neg = torch.full_like(inputs.is_set, -1)
    win_set = _segment_max(torch.where(winner, inputs.is_set, neg),
                           inputs.key_gid, G)
    win_val = _segment_max(torch.where(winner, inputs.val_idx, neg),
                           inputs.key_gid, G)
    present = (win_set == 1) & (max_seq > _take_clamped(last_clear,
                                                        inputs.key_doc))
    return present, win_val


def replay_map_batch(docs: Sequence[MapDocInput],
                     stats: Optional[dict] = None,
                     device="cuda") -> List[SummaryTree]:
    """Full pipeline: pack → LWW reduction on ``device`` → canonical
    summaries.

    Returns one SummaryTree per input doc whose bytes equal
    ``SharedMap.summarize()`` after the oracle applies the same ops.
    The LWW reduction has no oracle-fallback cases, so ``stats`` counts
    every doc as a device doc.  On a CUDA device the reduction is the
    hand-written kernel (``map_lww_cuda.lww``); on ``"cpu"`` its plain
    version.  No documents give no summaries (and no launch).
    """
    from .map_lww_cuda import lww

    dev = resolve_device(device)
    if stats is not None:
        stats["device_docs"] = stats.get("device_docs", 0) + len(docs)
    if not docs:
        return []
    batch = pack_map_batch(docs)
    present, win_val = lww(lww_inputs(batch, dev), batch.num_docs)
    return summaries_from_lww(batch, present.cpu(), win_val.cpu())


def oracle_map_summary(doc: MapDocInput) -> SummaryTree:
    """The CPU oracle's summary of a document: ``SharedMap`` loaded with
    the base data, then the tail processed in order."""
    from ..dds.map import SharedMap

    replica = SharedMap(doc.doc_id)
    if doc.base:
        base = SummaryTree()
        base.add_blob("header", canonical_json({"data": doc.base}))
        replica.load(base)
    for msg in doc.ops:
        replica.process(msg, local=False)
    return replica.summarize()


def summaries_from_lww(batch: _PackedBatch, present, win_val
                       ) -> List[SummaryTree]:
    """LWW reduction results → canonical per-doc summaries."""
    present = np.asarray(present)
    win_val = np.asarray(win_val)
    data_per_doc: List[Dict[str, Any]] = [
        dict() for _ in range(batch.num_docs)
    ]
    for gid, (doc_idx, key) in enumerate(batch.keys):
        if present[gid]:
            data_per_doc[doc_idx][key] = batch.values.lookup(int(win_val[gid]))
    out = []
    for data in data_per_doc:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json({"data": data}))
        out.append(tree)
    return out
