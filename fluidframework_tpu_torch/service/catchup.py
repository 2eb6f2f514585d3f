"""Bulk catch-up: fold many documents' op tails into fresh summaries.

The port's copy of ``fluidframework_tpu/service/catchup.py``, on the
card: every replay call and the tier-2.5 caches run on the service's one
``device`` (``"cuda"`` unless the caller passes ``device="cpu"``), or,
with a doc mesh (``mesh=doc_mesh(...)``, or ``"auto"`` with the
``Catchup.Mesh`` gate on and more than one card visible), through the
doc-sharded fold of ``parallel/shard.py`` over the mesh's device list;
the bulk fold's trace is a ``torch.profiler`` trace.

The north-star service path (BASELINE.json; SURVEY.md §3.2): the reference
serves catch-up by handing the client a summary plus the scriptorium op
tail, and *every client* replays that tail itself.  Here the service does
the replay centrally, in bulk, on the device: op tails for thousands of
documents are packed into ragged tensors and folded by each family's
kernel on the card, producing summaries byte-identical to the CPU
oracle — so loading clients start from a fresh summary and replay nothing.

Device routing covers every kernel-backed channel type — string, map,
matrix, and tree channels (cold AND warm starts; a warm channel's summary
re-enters its kernel as base state), including mixed-type documents.
Channels of types with no device kernel (cell, counter, directory,
consensus) fold host-side per channel inside an otherwise-device document;
only container-level disqualifiers (runtime ops, GC state, blobs) fall all
the way back to the CPU container-runtime path.  The split/scatter is the
shared :func:`partition_replay` bookkeeping.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.batching import partition_replay
from ..ops.mergetree_kernel import MergeTreeDocInput, resolve_device
from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from ..runtime.container import ContainerRuntime
from ..runtime.op_pipeline import decode_stream
from ..runtime.registry import ChannelRegistry, default_registry
from . import gates
from .orderer import LocalOrderingService


@contextlib.contextmanager
def torch_profiler_trace(log_dir: str, device):
    """``torch.profiler`` trace of one bulk fold (host activity, and the
    card's kernels and copies when ``device`` is CUDA), written into
    ``log_dir`` as a Chrome trace (``*.pt.trace.json``) when the fold
    ends; import is deferred so the profiler never loads on the untraced
    path."""
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tp.profile(activities=activities,
                    on_trace_ready=tp.tensorboard_trace_handler(log_dir)):
        yield


STRING_TYPE = "sequence-tpu"
MAP_TYPE = "map-tpu"
MATRIX_TYPE = "matrix-tpu"
TREE_TYPE = "tree-tpu"
#: types with a device kernel; every other registered type folds host-side
#: per channel (still inside a device-routed document).
KERNEL_TYPES = (STRING_TYPE, MAP_TYPE, MATRIX_TYPE, TREE_TYPE)

import weakref

#: registry -> {type_name: empty digest}; weak keys so a dropped registry
#: frees its entries and a recycled address can never serve stale digests.
_EMPTY_DIGESTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _gc_state_empty(summary: SummaryTree) -> bool:
    """Prior summary carries no gc stamps/sweeps and no blobs."""
    try:
        gc = json.loads(summary.blob_bytes(".gc"))
        if gc.get("unreferenced") or gc.get("swept") \
                or gc.get("unreferencedBlobs"):
            return False
    except KeyError:
        pass
    try:
        blobs = summary.get(".blobs")
        if isinstance(blobs, SummaryTree) and blobs.children:
            return False
    except KeyError:
        pass
    return True


def _empty_digest(registry: ChannelRegistry, type_name: str) -> str:
    """Digest of a fresh, empty channel summary for a type (id-independent:
    no built-in channel summary embeds its id).  Cached per registry OBJECT
    (weakly) — two services with different factories for the same type name
    must not poison each other's cache."""
    per_registry = _EMPTY_DIGESTS.setdefault(registry, {})
    digest = per_registry.get(type_name)
    if digest is None:
        channel = registry.get(type_name).create("-")
        digest = channel.summarize(0).digest()
        per_registry[type_name] = digest
    return digest


@dataclasses.dataclass
class _DocWork:
    doc_id: str
    summary: SummaryTree
    ref_seq: int
    tail: List[SequencedMessage]
    # device plan: [(ds_id, channel_id, type_name, channel_tree_or_None)]
    # or None (CPU fallback); computed once at partition time.
    plan: Optional[List[tuple]] = None
    # decoded (msg, batch) pairs — chunk/compression resolved once
    decoded: Optional[list] = None
    # attribution-enabled document (prior .metadata stamp): the device
    # fold must add the container .attribution table and the string
    # channels' key blobs.
    attribution: bool = False
    # result-cache key this fold will publish under (None = cache off)
    cache_key: Optional[tuple] = None


def flatten_channel_ops(
    decoded: Sequence, ds_id: str, channel_id: str
) -> List[SequencedMessage]:
    """Unwrap decoded grouped batches into the flat per-channel op stream a
    replay kernel folds over.  Sub-ops keep the batch's sequence number —
    the same view the oracle applies them under.  ``decoded`` is the
    (msg, batch) stream from :func:`decode_stream` (chunked/compressed
    batches already resolved)."""
    out = []
    for msg, batch in decoded:
        for sub in batch["ops"]:
            if sub.get("ds") == ds_id and sub.get("channel") == channel_id:
                # Direct construction — dataclasses.replace is ~4.5× the
                # cost and this rewrap runs once per sub-op of every doc
                # on the bulk catch-up path (keywords: robust to field
                # insertion at ~the same cost).
                out.append(SequencedMessage(
                    seq=msg.seq, client_id=msg.client_id,
                    client_seq=msg.client_seq, ref_seq=msg.ref_seq,
                    min_seq=msg.min_seq, type=msg.type,
                    contents=sub["contents"], timestamp=msg.timestamp,
                ))
    return out


class CatchupService:
    """Scriptorium-fed bulk summarizer over (storage, oplog).

    ``catch_up`` calls are serialized process-wide (``_serial``): bulk
    maintenance gains nothing from overlap, the device/cpu counters stay
    consistent per call, and the optional profiler trace (which allows
    one active trace per process) can never nest.  Requests fully
    servable from the seq-anchored result cache bypass ``_serial``
    entirely (they do no device work), so a thundering herd of identical
    catch-ups costs ONE fold: the first caller leads, later callers
    either wait on the in-flight fold (single-flight ``join``) or hit the
    published entry."""

    _serial = threading.RLock()

    #: Longest a cache follower blocks on another thread's in-flight fold
    #: before abandoning the flight and folding itself — a leader that
    #: died without reaching its finally (killed executor thread, OOM)
    #: must not hang followers forever.  Configurable via the
    #: ``Catchup.JoinTimeout`` gate; folds themselves are unaffected.
    JOIN_TIMEOUT = float(gates.default("Catchup.JoinTimeout"))

    def __init__(
        self,
        service: LocalOrderingService,
        registry: Optional[ChannelRegistry] = None,
        mc=None,
        mesh="auto",
        cache="default",
        pack_cache="default",
        delta_cache="default",
        device_cache="default",
        device="cuda",
    ) -> None:
        from ..utils.telemetry import MonitoringContext

        from ..parallel.shard import DocMesh

        if not (mesh is None or isinstance(mesh, DocMesh)
                or (isinstance(mesh, str) and mesh == "auto")):
            raise TypeError(
                f"mesh must be 'auto', None or a parallel.shard.doc_mesh, "
                f"not {mesh!r}")
        #: the one device every replay call and tier-2.5 cache runs on,
        #: resolved once: "cuda" without a card raises here.
        self.device = resolve_device(device)
        self.service = service
        self.registry = registry if registry is not None else default_registry()
        self.mc = (mc or MonitoringContext()).child("catchup")
        # -- two-tier seq-anchored catch-up cache ---------------------------
        # Tier 1: folded results keyed (epoch, doc, base digest, seq
        # range) with single-flight; tier 2: packed-chunk reuse inside
        # the string pipeline.  ``"default"`` builds per-instance caches
        # (gated by Catchup.Cache / Catchup.PackCache = "off"); pass an
        # instance to share across services OVER THE SAME STORE (the
        # server's per-RPC ``invalidate_epoch`` treats any other store's
        # epoch as a dead generation), or None to disable.
        from ..ops.pipeline import PackCache
        from .catchup_cache import CatchupResultCache, DeltaExportCache

        def _gated(value, gate_key, bytes_key, ctor):
            # Defaults come from the gates registry — the single source
            # the FL-DUR-GATE drift check pins call sites against.
            if value != "default":
                return value
            if not gates.is_on(self.mc.config, gate_key):
                return None
            return ctor(gates.get_int(self.mc.config, bytes_key))

        self.cache = _gated(cache, "Catchup.Cache", "Catchup.CacheBytes",
                            CatchupResultCache)
        self._pack_cache = _gated(pack_cache, "Catchup.PackCache",
                                  "Catchup.PackCacheBytes",
                                  PackCache)
        # Tier 0: digest-gated delta download — summaries stay
        # device-resident; only changed documents' export rows cross the
        # d2h link on a warm catch-up.  Gate Catchup.DeltaDownload
        # (default ON) / Catchup.DeltaCacheBytes.
        self.delta_cache = _gated(delta_cache, "Catchup.DeltaDownload",
                                   "Catchup.DeltaCacheBytes",
                                   DeltaExportCache)
        # Tier 2.5: device-resident pack buffers — the upload
        # mirror of tier 0.  Packed chunk arrays stay in device memory
        # keyed by the chunk's token tuple: an exact warm hit dispatches
        # with ZERO h2d pack bytes, a grown tail uploads only its suffix
        # rows through a donated in-place splice.  Gate
        # Catchup.DeviceResident (default ON) / Catchup.DeviceCacheBytes.
        from ..ops.device_cache import DevicePackCache

        # Keywords only: the port's argument order differs from the
        # reference's (a positional device_ops would bind elsewhere).
        self.device_cache = _gated(
            device_cache, "Catchup.DeviceResident",
            "Catchup.DeviceCacheBytes",
            lambda n: DevicePackCache(max_bytes=n, device=self.device))
        # The SECOND kernel family: tree channels ride the
        # same four-tier pipeline.  Tier 0/1 are family-agnostic and
        # SHARED (entries key by channel-scoped token / doc);
        # tiers 2/2.5 hold family-typed arrays, so the tree route gets
        # its own instances behind the SAME gates — an operator turning
        # a tier off turns it off for every family.
        from ..ops.tree_pipeline import tree_device_cache, tree_pack_cache

        # Each family gets its OWN budget of the configured size (the
        # bytes keys bound a tier per family, not summed across them —
        # an operator tuning Catchup.DeviceCacheBytes down bounds the
        # tree planes exactly like the merge-tree ones).
        self.tree_pack_cache = (
            tree_pack_cache(
                gates.get_int(self.mc.config, "Catchup.PackCacheBytes"))
            if isinstance(self._pack_cache, PackCache) else None)
        self.tree_device_cache = (
            tree_device_cache(
                max_bytes=gates.get_int(self.mc.config,
                                        "Catchup.DeviceCacheBytes"),
                device=self.device)
            if isinstance(self.device_cache, DevicePackCache) else None)
        #: kernel channels that fell back to the oracle path
        #: (hostChannels alone could not distinguish a non-kernel channel
        #: from a kernel channel that fell back).
        self.fallback_channels = 0  # guarded-by: _serial
        # Tolerant parse, explicit-None default: a configured 0 means
        # "never wait on a leader, always fold" and must not fall back
        # to the default.
        self.join_timeout = gates.get_float(
            self.mc.config, "Catchup.JoinTimeout",
            fallback=self.JOIN_TIMEOUT)
        #: busy-seconds per pipeline stage (pack/upload/dispatch/
        #: device_wait/download/extract, plus the h2d_bytes/d2h_bytes
        #: integer counters) and device/fallback doc counts, accumulated
        #: across this instance's folds — schema-identical on the
        #: single-device and mesh paths — the warm-vs-cold perf gate
        #: asserts a full cache hit leaves ``pipeline_stage["pack"]``
        #: untouched.
        self.pipeline_stage: dict = {}  # guarded-by: _serial
        self.pipeline_stats: dict = {}  # guarded-by: _serial
        self.device_docs = 0  # guarded-by: _serial
        self.cpu_docs = 0  # guarded-by: _serial
        self.host_channels = 0  # guarded-by: _serial (host-side channel folds)
        #: whether the CURRENT fold pass pins its folded device chunks
        #: into the tier-2.5 resident-state tier (streaming fold only).
        self._pin_resident = False  # guarded-by: _serial
        #: the doc mesh of the bulk fold: ``"auto"`` = resolved lazily at
        #: the first device fold (``_resolve_mesh``), ``None`` = the
        #: service's one device, a ``DocMesh`` = that device list.
        self._mesh = mesh  # guarded-by: _serial
        self._mesh_resolved = mesh != "auto"  # guarded-by: _serial

    def invalidate_epoch(self, epoch: str) -> None:
        """ONE epoch sweep over every epoch-keyed cache tier this
        service holds — tier 1 (results), tier 0 (delta export), and
        BOTH families' tier-2.5 resident buffers (the server's per-RPC
        sweep calls this so a new family can never be forgotten).  The
        tier-2 pack caches need no sweep: their tokens carry the epoch
        as component 0, so dead-generation windows simply never match
        and age out of the LRU."""
        if self.cache is not None:
            self.cache.invalidate_epoch(epoch)
        if self.delta_cache is not None:
            self.delta_cache.invalidate_epoch(epoch)
        if self.device_cache is not None:
            self.device_cache.invalidate_epoch(epoch)
        if self.tree_device_cache is not None:
            self.tree_device_cache.invalidate_epoch(epoch)

    def _resolve_mesh(self):  # holds-lock: _serial
        """Lazy mesh detection (init stays cheap): ``"auto"`` builds a doc
        mesh over every visible card when the ``Catchup.Mesh`` gate is
        on, the service's device is CUDA and more than one card is
        visible; otherwise it means the one device.  Callers hold
        ``_serial`` (fold path only)."""
        if not self._mesh_resolved:
            self._mesh_resolved = True
            self._mesh = None
            if gates.is_on(self.mc.config, "Catchup.Mesh") \
                    and self.device.type == "cuda" \
                    and torch.cuda.device_count() > 1:
                from ..parallel.shard import doc_mesh

                self._mesh = doc_mesh()
        return self._mesh

    # -- public API ------------------------------------------------------------

    def catch_up_cached(
        self,
        doc_ids: Optional[Sequence[str]] = None,
        upload: bool = True,
        join_timeout: Optional[float] = None,
        stream_lag: Optional[int] = None,
        stream_docs: Optional[list] = None,
    ) -> Tuple[Dict[str, Tuple[str, int]], bool]:
        """The tier-0/1 WARM pass alone: ``(results, complete)`` where
        ``complete`` means every requested document was served without
        any device work — from the result cache, a single-flight join
        on another caller's in-flight fold, or the no-new-ops fast path
        — and the caller can skip the fold lane entirely.  This is the
        server's admission priority lane: warm readers must
        never queue behind cold folds, and a herd joining one in-flight
        fold costs the leader's ONE admission slot.  ``join_timeout``
        bounds the single-flight wait (defaults to the service's
        ``Catchup.JoinTimeout``); the server passes a SHORT bound so a
        wedged leader turns joiners into fold-lane requests — where
        admission sheds with pacing — instead of parking them on
        executor threads.  ``({}, False)`` when the result cache is
        disabled.

        ``stream_lag`` (set by the server when a streaming
        fold is attached) widens the no-new-ops fast path into the
        STREAMING-HEAD lane: a document whose durable head is within
        ``stream_lag`` ops of its newest summary serves that summary at
        its ref_seq — the client gap-repairs the bounded tail from the
        op log, exactly the reference's summary+tail contract — instead
        of falling to the fold lane.  The bound is the fold cadence, so
        with the streaming fold healthy EVERY doc qualifies and the
        warm lane hit rate goes to ~1.0.  Docs served laggy are
        appended to ``stream_docs`` (when given) so the server can
        label the lane."""
        if self.cache is None:
            return {}, False
        return self._serve_cached(doc_ids, upload,
                                  join_timeout=join_timeout,
                                  stream_lag=stream_lag,
                                  stream_docs=stream_docs)

    def catch_up(
        self,
        doc_ids: Optional[Sequence[str]] = None,
        upload: bool = True,
        stats: Optional[dict] = None,
        prefetched: Optional[Dict[str, Tuple[str, int]]] = None,
        pin_resident: bool = False,
    ) -> Dict[str, Tuple[str, int]]:
        """Fold each document's tail; returns {doc_id: (handle, seq)}.
        Documents with no new ops keep their current summary handle.
        ``stats`` (optional dict) receives this call's own
        ``deviceDocs``/``cpuDocs``/``hostChannels`` deltas, computed under
        the serialization lock so concurrent callers' documents never leak
        into each other's numbers.  ``prefetched`` carries results a
        caller's OWN :meth:`catch_up_cached` pass already served (the
        server's warm lane): the internal cached pass is skipped so those
        documents' metadata scans — and their cache hit counts — never
        run twice.  ``pin_resident`` (the streaming fold) pins the folded
        chunks' device buffers into the tier-2.5 resident-state tier so
        the NEXT micro-batch splices onto them instead of re-uploading.

        With the ``Catchup.ProfileDir`` config gate set (or
        ``FLUID_TPU_CATCHUP_PROFILEDIR``), each bulk fold is wrapped in a
        ``torch.profiler`` trace written there — the per-replay-batch hook
        of the telemetry design (SURVEY.md §5 tracing)."""
        from ..utils.telemetry import PerformanceEvent

        # None = no warm pass ran yet (run ours); a dict — even an empty
        # one — means the CALLER's warm pass already scanned, and
        # re-scanning here would duplicate the metadata/tail reads and
        # double-count cache hits.
        skip_warm = prefetched is not None
        prefetched = dict(prefetched or {})
        if self.cache is not None and not skip_warm:
            served, complete = self._serve_cached(doc_ids, upload)
            if complete:
                # Pure cache serve: no fold ran, all deltas are zero.
                if stats is not None:
                    stats.update(deviceDocs=0, cpuDocs=0, hostChannels=0,
                                 fallbackChannels=0)
                # stats() is the LOCKED snapshot — reading the counter
                # dict directly would race concurrent leaders bumping it
                # under the cache lock (fluidrace cannot see cross-object
                # guarding, but the discipline still applies).
                self.mc.logger.send({
                    "eventName": "cacheServe", **self.cache.stats(),
                    "docs": len(served),
                })
                return served
            # Partially cached: carry the already-served docs into the
            # fold pass so their metadata scan (latest + tail + digest)
            # and hit counting never run twice.
            prefetched = served
        profile_dir = gates.raw(self.mc.config, "Catchup.ProfileDir")
        with CatchupService._serial:
            self._pin_resident = pin_resident
            tracer = (
                torch_profiler_trace(str(profile_dir), self.device)
                if profile_dir else contextlib.nullcontext()
            )
            device_before, cpu_before = self.device_docs, self.cpu_docs
            host_before = self.host_channels
            fb_before = self.fallback_channels
            with tracer, PerformanceEvent.timed_exec(
                    self.mc.logger, "bulkCatchup") as perf:
                results = self._catch_up(doc_ids, upload, prefetched)
                deltas = dict(
                    deviceDocs=self.device_docs - device_before,
                    cpuDocs=self.cpu_docs - cpu_before,
                    hostChannels=self.host_channels - host_before,
                    # Kernel channels that fell back to the oracle this
                    # call — distinguishable from hostChannels (channel
                    # types with no kernel at all).
                    fallbackChannels=self.fallback_channels - fb_before,
                )
                perf["extra"].update(docs=len(results), **deltas)
            if stats is not None:
                stats.update(deltas)
            return results

    def _cache_key_at(self, doc_id: str, base_handle: str, ref_seq: int,
                      head_seq: int) -> tuple:
        """Seq-anchored identity of one fold's full input: the store
        generation pins the namespace, the base summary HANDLE (the
        commit's tree digest — never re-hashed here) pins the summary
        bytes, and (ref_seq, head seq) pins the tail bytes — the op log
        is append-only, so the range IS the content."""
        return (self.service.storage.epoch, doc_id, base_handle,
                ref_seq, head_seq)

    def _cache_key(self, doc_id: str, base_handle: str, ref_seq: int,
                   tail: Sequence[SequencedMessage]) -> tuple:
        """:meth:`_cache_key_at` over a materialized tail (seqs are
        contiguous, so the last message's seq IS the durable head)."""
        return self._cache_key_at(doc_id, base_handle, ref_seq,
                                  tail[-1].seq)

    def _finish_result(self, doc_id: str, fold, seq: int,
                       upload: bool) -> Tuple[str, int]:
        """``fold`` is a CachedFold (tree + handle digested once at
        publish) — a cache hit never re-walks the tree."""
        if upload:
            # Idempotent publish (atomic check-and-upload under the store
            # lock): N cache-served followers of one fold chain ONE
            # commit onto the document's history, not N duplicates.
            return self.service.storage.upload_absent(
                doc_id, fold.tree, seq, handle=fold.handle), seq
        return fold.handle, seq

    def _serve_cached(self, doc_ids, upload: bool,
                      join_timeout: Optional[float] = None,
                      stream_lag: Optional[int] = None,
                      stream_docs: Optional[list] = None):
        """As much of the request as tier 1 can serve: ``(results,
        complete)`` where ``complete`` means every document was served
        and the caller can skip the fold path entirely.  Runs WITHOUT
        the serialization lock: a request for an in-flight key waits on
        that fold (single-flight) instead of queueing behind the device.
        Stops at the first miss — the fold pass re-reads the remaining
        docs under the lock anyway, so scanning past the miss would be
        pure duplicated work.  Deliberately O(1) per document on the
        storage side: the cache key needs only the durable HEAD seq
        (appends are contiguous, so the head IS the last tail seq), so
        a request that ends up SHED never materialized a single op —
        the pre-admission warm probe must not cost what admission
        exists to bound."""
        if join_timeout is None:
            join_timeout = self.join_timeout
        results: Dict[str, Tuple[str, int]] = {}
        for doc_id in (doc_ids if doc_ids is not None
                       else self.service.doc_ids()):
            summary, ref_seq, handle = \
                self.service.storage.latest_with_handle(doc_id)
            if summary is None:
                continue
            head = self.service.oplog.head(doc_id)
            if head <= ref_seq:
                results[doc_id] = (handle, ref_seq)
                continue
            if stream_lag is not None and head - ref_seq <= stream_lag:
                # Streaming-head serve: the summary trails the durable
                # head by at most the fold cadence — hand it out at its
                # ref_seq and let the client replay the bounded tail
                # (summary + tail, the reference contract).  No fold, no
                # admission, no device work.
                results[doc_id] = (handle, ref_seq)
                if stream_docs is not None:
                    stream_docs.append(doc_id)
                continue
            fold = self.cache.join(
                self._cache_key_at(doc_id, handle, ref_seq, head),
                timeout=join_timeout,
                # Only a wait that exhausted the service's full
                # crashed-leader bound may reap the flight; a caller's
                # deliberately shorter wait (the warm priority lane)
                # just stops waiting.
                reap_on_timeout=join_timeout >= self.join_timeout,
            )
            if fold is None:
                # Nothing cached/in flight — or the bounded wait expired
                # on a leader that crashed without reaching its
                # finally-abandon (join() already removed the dead
                # flight and woke its other waiters).  Either way the
                # fold path re-claims the key: begin() leads.
                return results, False  # at least one real fold needed
            results[doc_id] = self._finish_result(
                doc_id, fold, head, upload)
        return results, True

    def _catch_up(  # holds-lock: _serial
        self,
        doc_ids: Optional[Sequence[str]] = None,
        upload: bool = True,
        prefetched: Optional[Dict[str, Tuple[str, int]]] = None,
    ) -> Dict[str, Tuple[str, int]]:
        works: List[_DocWork] = []
        results: Dict[str, Tuple[str, int]] = dict(prefetched or {})
        leading: set = set()
        try:
            for doc_id in (doc_ids if doc_ids is not None
                           else self.service.doc_ids()):
                if results.get(doc_id) is not None:
                    continue  # served by the pre-lock cache pass
                summary, ref_seq, handle = \
                    self.service.storage.latest_with_handle(doc_id)
                if summary is None:
                    continue  # never attached: nothing to summarize from
                tail = self.service.oplog.get(doc_id, from_seq=ref_seq)
                if not tail:
                    results[doc_id] = (handle, ref_seq)
                    continue
                key = None
                if self.cache is not None:
                    key = self._cache_key(doc_id, handle, ref_seq, tail)
                    status, fold = self.cache.begin(key)
                    if status == "hit":
                        results[doc_id] = self._finish_result(
                            doc_id, fold, tail[-1].seq, upload)
                        continue
                    leading.add(key)
                work = _DocWork(doc_id, summary, ref_seq, tail)
                work.cache_key = key
                work.decoded = list(decode_stream(tail))
                work.plan = self._device_plan(work)
                works.append(work)

            trees = partition_replay(
                works,
                known_fallback=lambda w: w.plan is None,
                fallback_fn=self._cpu_fold,
                batch_fn=self._device_fold,
            )
            from .catchup_cache import CachedFold

            for work, tree in zip(works, trees):
                if work.cache_key is not None:
                    # Publish BEFORE the upload so single-flight waiters
                    # unblock as early as possible; finish() hands back
                    # the one digest it computed.
                    fold = self.cache.finish(work.cache_key, tree)
                    leading.discard(work.cache_key)
                else:
                    fold = CachedFold(tree, tree.digest())
                results[work.doc_id] = self._finish_result(
                    work.doc_id, fold, work.tail[-1].seq, upload)
            return results
        finally:
            # A failed fold must never strand single-flight waiters.
            if self.cache is not None:
                for key in sorted(leading):
                    self.cache.abandon(key)

    # -- CPU path --------------------------------------------------------------

    def _cpu_fold(self, work: _DocWork) -> SummaryTree:  # holds-lock: _serial
        self.cpu_docs += 1
        runtime = ContainerRuntime(self.registry)
        runtime.load(work.summary)
        for msg in work.tail:
            runtime.process(msg)
        return runtime.summarize()

    # -- device path -----------------------------------------------------------

    def _device_plan(self, work: _DocWork):
        """Device-eligible shape: only container-level state must be
        trivially foldable (no runtime ops, empty GC/blob state).  Every
        registered channel type participates — kernel types fold on device
        (cold or warm; a warm channel's summary re-enters its kernel as
        base state), others fold host-side per channel.  Returns
        [(ds_id, channel_id, type_name, channel_tree_or_None)] where None
        marks a cold (empty prior summary) channel; None = CPU path."""
        try:
            ds_root = work.summary.get(".datastores")
        except KeyError:
            return None
        # GC/blob state must be trivially foldable host-side.
        if not _gc_state_empty(work.summary):
            return None
        try:
            meta = json.loads(work.summary.blob_bytes(".metadata"))
        except KeyError:
            meta = {}
        attribution = bool(meta.get("attribution"))
        for _msg, batch in work.decoded:
            if any("runtime" in sub for sub in batch["ops"]):
                return None  # blob/ds/channel attaches, sweeps: CPU path
        plan = []
        for ds_id, subtree in ds_root.children.items():
            if not isinstance(subtree, SummaryTree):
                return None
            try:
                attrs = json.loads(subtree.blob_bytes(".attributes"))
            except KeyError:
                return None
            if not attrs.get("rooted", True):
                return None  # GC-collectible datastore: CPU path
            channels = attrs.get("channels")
            if channels is None:
                return None  # unrecognized attributes shape: CPU path
            for channel_id, type_name in channels.items():
                try:
                    self.registry.get(type_name)
                except KeyError:
                    return None  # unknown type: CPU path decides
                channel_tree = subtree.children[channel_id]
                if channel_tree.digest() == _empty_digest(
                        self.registry, type_name):
                    channel_tree = None  # cold fold
                plan.append((ds_id, channel_id, type_name, channel_tree))
        if plan:
            work.attribution = attribution
        return plan or None

    @staticmethod
    def _string_base_kwargs(channel_tree: Optional[SummaryTree]) -> dict:
        if channel_tree is None:
            return {}
        header = json.loads(channel_tree.blob_bytes("header"))
        records = json.loads(channel_tree.blob_bytes("body"))
        if "attribution" in channel_tree.children:
            # Warm base carrying pre-clamp keys: the ONE shared splitter
            # (SharedString.load uses it too), so the re-summarize
            # regenerates identical body AND keys.
            from ..dds.merge_tree import MergeTreeOracle

            MergeTreeOracle.split_records_by_attribution_keys(
                records, json.loads(channel_tree.blob_bytes("attribution"))
            )
        try:
            intervals = json.loads(channel_tree.blob_bytes("intervals"))
        except KeyError:
            intervals = None
        return {
            "base_records": records,
            "base_seq": header["seq"],
            "base_msn": header["minSeq"],
            "base_intervals": intervals,
        }

    def _host_channel_fold(self, type_name: str, channel_id: str,
                           channel_tree: Optional[SummaryTree],
                           ops: List[SequencedMessage], work: _DocWork,
                           final_msn: int) -> SummaryTree:
        """Fold one non-kernel channel host-side, byte-identical to what the
        container runtime would produce: its op stream interleaved with the
        tail's JOIN/LEAVE (consensus channels re-queue a departed client's
        held items via ``observe_protocol``) and per-message window
        advances."""
        factory = self.registry.get(type_name)
        if channel_tree is None:
            channel = factory.create(channel_id)
        else:
            channel = factory.load(channel_id, channel_tree)
        by_seq: Dict[int, List[SequencedMessage]] = {}
        for m in ops:
            by_seq.setdefault(m.seq, []).append(m)
        observe = getattr(channel, "observe_protocol", None)
        advance = getattr(channel, "advance", None)
        for msg in work.tail:
            if msg.type in (MessageType.JOIN, MessageType.LEAVE) \
                    and observe is not None:
                observe(msg)
            for m in by_seq.get(msg.seq, []):
                channel.process(m, local=False)
            if advance is not None:
                advance(msg.seq, msg.min_seq)
        return channel.summarize(final_msn)

    def _device_fold(self, works: List[_DocWork]) -> List[SummaryTree]:
        # holds-lock: _serial
        """Batch every (doc, channel) pair into its kernel's batch (one
        device call per kernel type); fold non-kernel channels host-side;
        reassemble full container summary trees, byte-identical to
        ``ContainerRuntime.summarize()``."""
        from ..ops.map_kernel import MapDocInput
        from ..ops.matrix_kernel import MatrixDocInput
        from ..ops.tree_kernel import TreeDocInput

        # Collect per-kernel inputs; (work_idx, plan_idx) → result slot.
        string_in: List[MergeTreeDocInput] = []
        map_in: List[MapDocInput] = []
        matrix_in: List[MatrixDocInput] = []
        tree_in: List[TreeDocInput] = []
        slots: Dict[Tuple[int, int], Tuple[str, int]] = {}
        host_trees: Dict[Tuple[int, int], SummaryTree] = {}
        epoch = self.service.storage.epoch
        for wi, work in enumerate(works):
            self.device_docs += 1
            final_seq = work.tail[-1].seq
            final_msn = max(m.min_seq for m in work.tail)
            for pi, (ds_id, channel_id, type_name, channel_tree) in \
                    enumerate(work.plan):
                cid = f"{work.doc_id}/{ds_id}/{channel_id}"
                ops = flatten_channel_ops(work.decoded, ds_id, channel_id)

                def channel_token(tree=channel_tree, cid=cid):
                    # THE append-only cache identity (tiers 0/2/2.5)
                    # every kernel family packs under: the channel's op
                    # stream extends append-only under a fixed (epoch,
                    # base summary, ref_seq) anchor.  ONE derivation
                    # point — two hand-synced copies could silently give
                    # one family a weaker key — called lazily: only the
                    # pipelined families consume it, and the digest is a
                    # full Merkle walk the other channels must not pay.
                    return (epoch, cid, work.ref_seq,
                            tree.digest() if tree is not None else "")

                if type_name not in KERNEL_TYPES:
                    self.host_channels += 1
                    host_trees[wi, pi] = self._host_channel_fold(
                        type_name, channel_id, channel_tree, ops, work,
                        final_msn,
                    )
                elif type_name == STRING_TYPE:
                    slots[wi, pi] = (STRING_TYPE, len(string_in))
                    string_in.append(MergeTreeDocInput(
                        doc_id=cid, ops=ops, final_seq=final_seq,
                        final_msn=final_msn,
                        attribution=work.attribution,
                        cache_token=channel_token(),
                        **self._string_base_kwargs(channel_tree),
                    ))
                elif type_name == MAP_TYPE:
                    base = None
                    if channel_tree is not None:
                        base = json.loads(
                            channel_tree.blob_bytes("header"))["data"]
                    slots[wi, pi] = (MAP_TYPE, len(map_in))
                    map_in.append(MapDocInput(doc_id=cid, ops=ops, base=base))
                elif type_name == MATRIX_TYPE:
                    slots[wi, pi] = (MATRIX_TYPE, len(matrix_in))
                    matrix_in.append(MatrixDocInput(
                        doc_id=cid, ops=ops, base_summary=channel_tree,
                        final_seq=final_seq, final_msn=final_msn,
                    ))
                else:
                    assert type_name == TREE_TYPE
                    slots[wi, pi] = (TREE_TYPE, len(tree_in))
                    tree_in.append(TreeDocInput(
                        doc_id=cid, ops=ops, base_summary=channel_tree,
                        final_seq=final_seq, final_msn=final_msn,
                        attribution=work.attribution,
                        cache_token=channel_token(),
                    ))
        import functools

        mesh = self._resolve_mesh()
        if mesh is not None:
            # Doc-sharded service fold: the same byte-identical summaries,
            # the document axis split over the mesh's device list
            # (parallel/shard.py), serving the one-device pipeline's tier
            # stack and stage schema for the string and tree routes (tier
            # 2.5 placed on the mesh); map and matrix take no tiers, as
            # in the reference.
            from ..parallel.shard import (
                replay_map_sharded,
                replay_matrix_sharded,
                replay_mergetree_sharded,
                replay_tree_sharded,
            )

            replay = {
                STRING_TYPE: functools.partial(
                    replay_mergetree_sharded, mesh=mesh,
                    stats=self.pipeline_stats,
                    stage=self.pipeline_stage,
                    pack_cache=self._pack_cache,
                    delta_cache=self.delta_cache,
                    device_cache=self.device_cache),
                MAP_TYPE: functools.partial(
                    replay_map_sharded, mesh=mesh,
                    stats=self.pipeline_stats),
                MATRIX_TYPE: functools.partial(
                    replay_matrix_sharded, mesh=mesh,
                    stats=self.pipeline_stats),
                TREE_TYPE: functools.partial(
                    replay_tree_sharded, mesh=mesh,
                    stats=self.pipeline_stats,
                    stage=self.pipeline_stage,
                    pack_cache=self.tree_pack_cache,
                    delta_cache=self.delta_cache,
                    device_cache=self.tree_device_cache),
            }
        else:
            from ..ops.map_kernel import replay_map_batch
            from ..ops.matrix_pipeline import pipelined_matrix_replay
            from ..ops.pipeline import pipelined_mergetree_replay
            from ..ops.tree_pipeline import pipelined_tree_replay

            # String, tree and matrix channels (the three kernel families
            # of the generic pipeline) ride the chunked,
            # single-device-thread family pipeline — the same code path the
            # library entry measures; the map batch folds in one dispatch.
            # Stage busy seconds + doc counts accumulate on this instance
            # (the warm-vs-cold gates read them; the matrix channel, which
            # no gate reads, counts documents only), and packed windows
            # reuse through the per-family tier-2 pack caches.
            replay = {
                STRING_TYPE: functools.partial(
                    pipelined_mergetree_replay,
                    stats=self.pipeline_stats,
                    stage=self.pipeline_stage,
                    pack_cache=self._pack_cache,
                    delta_cache=self.delta_cache,
                    device_cache=self.device_cache,
                    pin_resident=self._pin_resident,
                    device=self.device,
                ),
                MAP_TYPE: functools.partial(
                    replay_map_batch, stats=self.pipeline_stats,
                    device=self.device),
                MATRIX_TYPE: functools.partial(
                    pipelined_matrix_replay, stats=self.pipeline_stats,
                    device=self.device),
                TREE_TYPE: functools.partial(
                    pipelined_tree_replay,
                    stats=self.pipeline_stats,
                    stage=self.pipeline_stage,
                    pack_cache=self.tree_pack_cache,
                    delta_cache=self.delta_cache,
                    device_cache=self.tree_device_cache,
                    pin_resident=self._pin_resident,
                    device=self.device,
                ),
            }
        fb_before = self.pipeline_stats.get("fallback_docs", 0)
        results = {
            STRING_TYPE: replay[STRING_TYPE](string_in),
            MAP_TYPE: replay[MAP_TYPE](map_in) if map_in else [],
            MATRIX_TYPE: replay[MATRIX_TYPE](matrix_in) if matrix_in else [],
            TREE_TYPE: replay[TREE_TYPE](tree_in) if tree_in else [],
        }
        # Kernel channels that fell back to their oracle (pre-pack
        # routing + post-fold overflow alike bump fallback_docs at the
        # one shared counting point) — the hostChannels disambiguator.
        self.fallback_channels += (
            self.pipeline_stats.get("fallback_docs", 0) - fb_before)

        out: List[SummaryTree] = []
        for wi, work in enumerate(works):
            final_seq = work.tail[-1].seq
            final_msn = max(m.min_seq for m in work.tail)
            tree = SummaryTree()
            tree.add_blob(
                ".metadata",
                canonical_json(
                    ContainerRuntime.container_metadata(
                        final_seq, final_msn,
                        attribution=work.attribution,
                    )
                ),
            )
            tree.add_blob(
                ".protocol", canonical_json(self._fold_protocol(work))
            )
            tree.add_blob(
                ".idCompressor",
                canonical_json(self._fold_id_compressor(work)),
            )
            if work.attribution:
                tree.add_blob(
                    ".attribution",
                    canonical_json(self._fold_attribution(work)),
                )
            # Eligibility guaranteed nothing becomes unreferenced and no
            # blobs exist: the folded gc/blob state is the empty state.
            from ..runtime.gc import GarbageCollector

            tree.add_blob(".gc",
                          canonical_json(GarbageCollector.empty_state()))
            tree.add_tree(".blobs")
            ds_tree = tree.add_tree(".datastores")
            by_ds: Dict[str, List[Tuple[str, str, int]]] = {}
            for pi, (ds_id, channel_id, type_name, _base) in \
                    enumerate(work.plan):
                by_ds.setdefault(ds_id, []).append(
                    (channel_id, type_name, pi)
                )
            for ds_id in sorted(by_ds):
                sub = SummaryTree()
                channel_types = {}
                for channel_id, type_name, pi in sorted(by_ds[ds_id]):
                    if (wi, pi) in host_trees:
                        sub.children[channel_id] = host_trees[wi, pi]
                    else:
                        kind, idx = slots[wi, pi]
                        sub.children[channel_id] = results[kind][idx]
                    channel_types[channel_id] = type_name
                sub.add_blob(".attributes", canonical_json(
                    {"channels": channel_types, "rooted": True}
                ))
                ds_tree.children[ds_id] = sub
            out.append(tree)
        return out

    def _fold_attribution(self, work: _DocWork) -> dict:
        """Replicate the runtime's attribution recording over the tail on
        top of the prior summary's table (container.py: observe AFTER
        chunk reassembly — only the final chunk's seq is ever stamped —
        and only when contents resolved non-None)."""
        from ..runtime.attributor import Attributor
        from ..runtime.op_pipeline import ChunkReassembler, maybe_decompress

        try:
            prior = json.loads(work.summary.blob_bytes(".attribution"))
        except KeyError:
            prior = None
        attr = Attributor.deserialize(prior)
        chunks = ChunkReassembler()
        for msg in work.tail:
            contents = msg.contents
            if msg.type is MessageType.OP and isinstance(contents, dict):
                if contents.get("type") == "chunk":
                    contents = chunks.feed(msg.client_id, contents)
                else:
                    contents = maybe_decompress(contents)
            elif msg.type is MessageType.LEAVE:
                # The runtime drops a departed client's partial chunk
                # train (container.py LEAVE handling); a later same-id
                # chunk must not complete it here either, or the device
                # and CPU folds would stamp different tables.
                chunks.drop(msg.contents["clientId"])
            if contents is not None:
                attr.observe(msg)
        return attr.serialize()

    def _fold_id_compressor(self, work: _DocWork) -> dict:
        """Replicate the runtime's sequenced id-range finalization for the
        host-composed summary (byte-parity with the CPU fold)."""
        from ..runtime.id_compressor import IdCompressor

        try:
            prior = json.loads(work.summary.blob_bytes(".idCompressor"))
            comp = IdCompressor.deserialize(prior)
        except KeyError:
            comp = IdCompressor()
        for _msg, batch in work.decoded:
            if "idRange" in batch:
                comp.finalize_range(batch["idRange"])
        return comp.serialize()

    def _fold_protocol(self, work: _DocWork) -> dict:
        """Replay the tail over the prior protocol state: quorum membership
        (JOIN/LEAVE) and propose/accept (PROPOSAL + MSN advancement) — the
        exact fold ContainerRuntime.process performs."""
        from ..protocol.quorum import QuorumProposals

        protocol = json.loads(work.summary.blob_bytes(".protocol"))
        order: List[str] = list(protocol["quorum"])
        proposals = QuorumProposals.deserialize(protocol.get("proposals"))
        for msg in work.tail:
            if msg.type is MessageType.JOIN:
                cid = msg.contents["clientId"]
                if cid not in order:
                    order.append(cid)
            elif msg.type is MessageType.LEAVE:
                cid = msg.contents["clientId"]
                if cid in order:
                    order.remove(cid)
            proposals.observe(msg)
        return {"proposals": proposals.serialize(), "quorum": order}
