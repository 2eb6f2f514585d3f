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
  pool, extraction (widen + C++ bodies) in another; ALL device
  interaction — upload, dispatch, starting the d2h copy, the waits —
  stays on the calling thread (the reference's single-device-thread
  contract);
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
call, so its ``upload`` reads 0 without the device-resident tier).

The catch-up cache tiers (``pack_cache``, ``delta_cache``,
``device_cache``, ``pin_resident``) are not ported yet (ROADMAP queue 1
item 3): passing them raises ``NotImplementedError``.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from time import perf_counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..convert import tensors_to
from .batching import partition_replay
from .family import KernelFamily
from .mergetree_kernel import (
    MergeTreeDocInput,
    export_to_numpy,
    known_oracle_fallback,
    narrow_ops_for_upload,
    narrow_state_for_upload,
    oracle_fallback_summary,
    pack_mergetree_batch,
    replay_export,
    resolve_device,
    split_export_digest,
    summaries_from_export,
)

#: THE stage schema, identical for every family (the byte counters ride as
#: ints next to the busy seconds)
STAGE_KEYS = ("pack", "upload", "dispatch", "device_wait", "download",
              "extract")


def seed_stage(stage: Optional[dict]) -> None:
    """Pre-seed the full stage schema so every fold reports the SAME keys
    (a leg that never ran reads 0, instead of being absent)."""
    if stage is None:
        return
    for key in STAGE_KEYS:
        stage.setdefault(key, 0.0)
    stage.setdefault("h2d_bytes", 0)
    stage.setdefault("d2h_bytes", 0)


def _bump(stage: Optional[dict], key: str, t0: float) -> None:
    if stage is not None:
        stage[key] = stage.get(key, 0.0) + (perf_counter() - t0)


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
    """A dispatched export: its leaves on the device, an event recorded on
    the compute stream right after the dispatch, and (once started) the
    d2h copy into pinned host buffers on a dedicated copy stream.

    The port's counterpart of the reference's duck-typed device handles
    and its ``_block_until_ready`` / ``_start_host_copy``:
    ``block_until_ready()`` waits for the fold + export without copying
    (the honest boundary between ``device_wait`` and ``download``),
    ``copy_to_host_async()`` starts the copy, ``to_numpy()`` waits for it
    and returns numpy views (a leaf, or a tuple of leaves).  On the CPU
    there is nothing to wait for or copy."""

    def __init__(self, export, copy_stream=None, slots=None) -> None:
        self._tuple = isinstance(export, tuple)
        self._leaves = export if self._tuple else (export,)
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


# ---------------------------------------------------------------------------
# The family-generic pipelined fold
# ---------------------------------------------------------------------------


def _refuse_cache_tiers(pack_cache, delta_cache, device_cache,
                        pin_resident) -> None:
    for name, value in (("pack_cache", pack_cache),
                        ("delta_cache", delta_cache),
                        ("device_cache", device_cache),
                        ("pin_resident", pin_resident or None)):
        if value is not None:
            raise NotImplementedError(
                f"{name}: the catch-up cache tiers are not ported yet "
                f"(ROADMAP queue 1 item 3)")


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
    pack_cache=None,
    delta_cache=None,
    device_cache=None,
    pin_resident: bool = False,
    device="cuda",
):
    """Canonical summaries for ``docs`` in the given order, through the
    chunked pipeline for any registered kernel family.

    ``stats`` accumulates ``device_docs``/``fallback_docs``; ``stage`` (if
    given) accumulates busy seconds under ``STAGE_KEYS`` and the integer
    byte counters ``h2d_bytes``/``d2h_bytes``; ``packed_out`` (if given)
    collects ``(state, ops, meta, tag)`` per chunk in schedule order, the
    host arrays as uploaded (narrowed).  ``device`` defaults to the card;
    ``device="cpu"`` runs the plain versions."""
    _refuse_cache_tiers(pack_cache, delta_cache, device_cache, pin_resident)
    dev = resolve_device(device)
    # Seed HERE, not in the fold: a batch that routes entirely to
    # fallback never reaches _pipelined_fold, and the schema must hold
    # for it too.
    seed_stage(stage)

    def fold(batch):
        return _pipelined_fold(
            family, batch, chunk_docs, pack_threads, extract_threads,
            fetch_depth, schedule, stats, stage, packed_out, dev)

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
    pack_cache=None,
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


def _pipelined_fold(family, batch, chunk_docs, pack_threads,
                    extract_threads, fetch_depth, schedule, stats, stage,
                    packed_out, device):
    order = family.order(batch, schedule)
    sched = [batch[i] for i in order]
    starts = list(range(0, len(sched), chunk_docs))
    on_card = device.type == "cuda"
    # Chunks holding a pinned slot: up to fetch_depth + 1 between dispatch
    # and fetch, and extract_threads being extracted, when the next takes
    # one.
    slots = _HostSlots(fetch_depth + extract_threads + 3) if on_card \
        else None
    copy_stream = torch.cuda.Stream(device=device) if on_card else None

    def pack_one(lo):
        t0 = perf_counter()
        chunk = sched[lo:lo + chunk_docs]
        state, ops, meta = family.pack(chunk)
        state, ops = family.narrow(chunk, state, ops, meta)
        return state, ops, meta, perf_counter() - t0

    def extract_one(meta, arr):
        t0 = perf_counter()
        st: dict = {}
        res = family.extract(meta, arr, st)
        return res, st, perf_counter() - t0

    out: List = []

    def collect(entry) -> None:
        fut, slot = entry
        res, st, dt = fut.result()
        if slot is not None:
            slots.release(slot)
        out.extend(res)
        if stage is not None:
            stage["extract"] = stage.get("extract", 0.0) + dt
        if stats is not None:
            for k, v in st.items():
                stats[k] = stats.get(k, 0) + v

    pack_futs: collections.deque = collections.deque()
    ex_futs: collections.deque = collections.deque()
    inflight: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=pack_threads) as pack_pool, \
            ThreadPoolExecutor(max_workers=extract_threads) as ex_pool:
        try:
            next_i = 0
            while next_i < len(starts) and len(pack_futs) < pack_threads + 1:
                pack_futs.append(pack_pool.submit(pack_one, starts[next_i]))
                next_i += 1

            def fetch_one(meta, core) -> None:
                # Wait for the DEVICE first (fold + export), so "download"
                # times the copy alone.
                t0 = perf_counter()
                core.block_until_ready()
                _bump(stage, "device_wait", t0)
                t0 = perf_counter()
                arr = family.fetch(core)
                _bump(stage, "download", t0)
                _count_d2h(stage, _nbytes(arr))
                ex_futs.append((ex_pool.submit(extract_one, meta, arr),
                                core.slot))
                if len(ex_futs) >= extract_threads + 1:
                    collect(ex_futs.popleft())

            while pack_futs:
                fut = pack_futs.popleft()
                state, ops, meta, dt = fut.result()
                if next_i < len(starts):
                    pack_futs.append(
                        pack_pool.submit(pack_one, starts[next_i]))
                    next_i += 1
                if stage is not None:
                    stage["pack"] = stage.get("pack", 0.0) + dt
                _count_h2d(stage, _np_nbytes(state) + _np_nbytes(ops))
                t0 = perf_counter()
                state_d = tensors_to(state, device)
                ops_d = tensors_to(ops, device)
                aux_d = torch.from_numpy(family.aux(meta, False)).to(device)
                _bump(stage, "upload", t0)
                t0 = perf_counter()
                ex = family.dispatch(state_d, ops_d, meta, False, aux_d)
                core, _dig = family.split_digest(ex, False)
                core = DeviceExport(core, copy_stream, slots)
                core.copy_to_host_async()
                _bump(stage, "dispatch", t0)
                if packed_out is not None:
                    packed_out.append((state, ops, meta,
                                       family.chunk_tag(meta)))
                inflight.append((meta, core))
                if len(inflight) > fetch_depth:
                    fetch_one(*inflight.popleft())
            while inflight:
                fetch_one(*inflight.popleft())
            while ex_futs:
                collect(ex_futs.popleft())
        finally:
            for f in pack_futs:
                f.cancel()
            for f, _slot in ex_futs:
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


MERGETREE_FAMILY = KernelFamily(
    name="mergetree",
    known_fallback=known_oracle_fallback,
    fallback_summary=oracle_fallback_summary,
    pack=pack_mergetree_batch,
    order=_mt_order,
    narrow=_mt_narrow,
    aux=_mt_aux,
    dispatch=_mt_dispatch,
    split_digest=split_export_digest,
    chunk_tag=_chunk_S,
    fetch=export_to_numpy,
    extract=lambda meta, arr, st: summaries_from_export(meta, arr,
                                                        stats=st),
)
