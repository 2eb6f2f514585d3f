"""Container runtime: datastore hosting, op batching, inbound processing.

Capability-equivalent of the reference's ``ContainerRuntime`` + ``Outbox``
+ ``BatchManager`` (SURVEY.md §2.1 container-runtime, §3.1 hot path;
upstream paths UNVERIFIED — empty reference mount):

- routes channel ops out through a **grouped-batch outbox**: ops accumulate
  and flush as ONE sequenced message carrying the batch (atomic delivery,
  one network round-trip per flush — the reference's grouped batching);
  each sub-op keeps its own client_seq so channel ack FIFOs match 1:1;
- processes inbound messages from an explicit queue (``drain()``), keeping
  optimistic-state windows testable — delivery timing is the caller's
  (DeltaManager's) concern, total order is the sequencer's;
- fans the (seq, min_seq) window out to every channel (zamboni plumbing);
- assembles the container summary tree (per-datastore subtrees + metadata)
  and loads from it.

The connection surface is deliberately thin — ``connect()`` takes anything
with ``submit(RawOperation)`` / ``subscribe(fn)`` (the in-proc Sequencer, a
LocalOrderer, or a driver's delta connection).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
from typing import Deque, Dict, List, Optional

import base64

from ..protocol.messages import MessageType, RawOperation, SequencedMessage
from ..protocol.quorum import QuorumProposals
from ..protocol.summary import SummaryTree, canonical_json
from .attributor import Attributor
from .blobs import BlobManager
from .datastore import FluidDataStoreRuntime
from .gc import GarbageCollector, GCOptions
from .id_compressor import IdCompressor
from .op_pipeline import (
    BATCH_WIRE_VERSION,
    ChunkReassembler,
    check_batch_version,
    encode_batch,
    maybe_decompress,
)
from .registry import ChannelRegistry, default_registry


@dataclasses.dataclass
class ContainerRuntimeOptions:
    """Typed runtime options (the reference's IContainerRuntimeOptions
    capability: compression, chunking, GC switches)."""

    #: compress batches whose canonical encoding reaches this many bytes
    compression_threshold: int = 64 * 1024
    #: split encoded batches into chunks below this many bytes
    chunk_size: int = 768 * 1024
    gc: GCOptions = dataclasses.field(default_factory=GCOptions)
    #: op attribution (SURVEY §1 layer 8, upstream enableRuntimeAttribution):
    #: a DOCUMENT-level choice stamped into .metadata at creation so every
    #: replica agrees — mixed on/off replicas would diverge on summary
    #: bytes.  Loading adopts the document's stamp over this option.
    attribution: bool = False


class OrderedClientElection:
    """Oldest connected client wins (the reference's election rule).
    Membership is driven by the sequenced JOIN/LEAVE stream, so every
    client computes the same winner at the same fold position."""

    def __init__(self) -> None:
        self._order: List[str] = []

    def observe(self, msg: SequencedMessage) -> None:
        if msg.type is MessageType.JOIN:
            cid = msg.contents["clientId"]
            if cid not in self._order:
                self._order.append(cid)
        elif msg.type is MessageType.LEAVE:
            cid = msg.contents["clientId"]
            if cid in self._order:
                self._order.remove(cid)

    @property
    def elected(self) -> Optional[str]:
        return self._order[0] if self._order else None

    @property
    def quorum(self) -> List[str]:
        return list(self._order)


class ContainerRuntime:
    """The per-client runtime instance."""

    def __init__(self, registry: Optional[ChannelRegistry] = None,
                 options: Optional[ContainerRuntimeOptions] = None) -> None:
        self.registry = registry if registry is not None else default_registry()
        self.options = options or ContainerRuntimeOptions()
        self.datastores: Dict[str, FluidDataStoreRuntime] = {}
        self.client_id: Optional[str] = None
        self._service = None
        self.ref_seq = 0          # last processed seq
        self.min_seq = 0
        self._client_seq = 0      # runtime-level op counter (sub-op acks)
        self._client_ids: set = set()  # all ids this runtime has used
        # Rehydrate adoption (the reference's PendingStateManager): wire
        # copies of a crashed session's ops are OUR acks, but they carry
        # that session's client ids and clientSeqs — this map translates
        # (old client id, old clientSeq) to the clientSeq the re-applied
        # op got in THIS runtime, so channel ack FIFOs match.
        self._adopted_ids: set = set()
        self._adopted_acks: Dict[tuple, int] = {}
        self._inbound: Deque[SequencedMessage] = collections.deque()
        self._outbox: List[dict] = []
        self._batching = 0
        self.election = OrderedClientElection()  # quorum, join-ordered
        # Propose/accept protocol state (code details etc.): pending until
        # the MSN passes the proposal seq, then committed — identically on
        # every replica (protocol/quorum.py).
        self.quorum_proposals = QuorumProposals()
        self.message_observers: List = []  # fn(msg) after each message
        # Distributed id compression: locals mint free; creation ranges
        # ride outbound batches and finalize identically on every client.
        self.id_compressor = IdCompressor()
        # Op attribution (SURVEY §1 layer 8): seq -> (user, timestamp),
        # summarized columnar, resolved from DDS reads via seq stamps.
        # Enabled per-DOCUMENT (options at create; the .metadata stamp on
        # load) — see ContainerRuntimeOptions.attribution.
        self.attribution_enabled = self.options.attribution
        self.attributor = Attributor()
        self.blob_manager = BlobManager(self)
        self.gc = GarbageCollector(self, self.options.gc)
        self._chunks = ChunkReassembler()
        # Encoded wire messages not yet accepted by the service: a failed
        # send resumes HERE (same bytes, same client_seqs) so partially-
        # delivered chunk trains and consumed idRanges are never re-encoded.
        # Entries are (raw_op, first_gen): first_gen is the idRange start a
        # batch's lead message carries (None otherwise) so a discarded
        # unsent batch can roll its range back into the compressor.
        self._pending_wire: List[tuple] = []
        # Runtime meta-ops (dsAttach/channelAttach/blobAttach/gcSweep)
        # awaiting their sequenced echo — resubmitted on reconnect like
        # channel ops (they'd otherwise be lost with the cleared outbox).
        self._pending_runtime: Dict[int, dict] = {}

    # -- datastores ------------------------------------------------------------

    def create_datastore(self, datastore_id: str,
                         rooted: bool = True) -> FluidDataStoreRuntime:
        """``rooted=False`` datastores survive only while some rooted
        datastore's channels hold a ``fluidHandle`` to them (GC sweeps the
        rest)."""
        if datastore_id in self.datastores:
            raise ValueError(f"datastore {datastore_id!r} already exists")
        ds = FluidDataStoreRuntime(datastore_id, self.registry, rooted=rooted)
        ds._attach(self)
        self.datastores[datastore_id] = ds
        if self.is_attached and self.client_id is not None:
            # Live creation: announce so every replica materializes it.
            self._submit_runtime_op({
                "runtime": "dsAttach",
                "ds": datastore_id,
                "rooted": rooted,
            })
        return ds

    def get_datastore(self, datastore_id: str) -> FluidDataStoreRuntime:
        return self.datastores[datastore_id]

    # -- connection ------------------------------------------------------------

    def connect(self, service, client_id: str) -> None:
        """Attach to an ordering service: anything with
        ``submit(RawOperation)`` and ``subscribe(fn)``.

        Subscribe-then-join: the live subscription starts first, the
        service's durable log backfills everything after our current
        sequence point (catch-up), and only then is the JOIN announced —
        so this client observes its own JOIN and every quorum event in
        order.  A runtime that ``load()``ed a summary first backfills just
        the tail."""
        self._service = service
        self.client_id = client_id
        self._client_ids.add(client_id)
        service.subscribe(self._inbound.append)
        log = getattr(service, "log", None)
        if log is not None:
            for msg in log:
                if msg.seq > self.ref_seq:
                    self._inbound.append(msg)
        if hasattr(service, "connect"):
            service.connect(client_id)
        for ds in self.datastores.values():
            ds._attach(self)

    @property
    def is_attached(self) -> bool:
        return self._service is not None

    # -- outbound: the outbox --------------------------------------------------

    def _submit_op(self, envelope: dict, ref_seq=None) -> int:
        """Called by datastores for each channel op; returns the sub-op
        client_seq the channel records for its ack FIFO.  Each sub-op
        carries the view (refSeq) it was authored against — resubmitted
        ops pin their original view so position contents stay correct."""
        self._client_seq += 1
        client_seq = self._client_seq  # flush below may advance the counter
        self._outbox.append(
            {"clientSeq": client_seq,
             "refSeq": self.ref_seq if ref_seq is None else ref_seq,
             **envelope}
        )
        if not self._batching:
            self.flush()
        return client_seq

    @contextlib.contextmanager
    def order_sequentially(self):
        """Batch every op submitted inside into one grouped message —
        atomic remote delivery (the reference's orderSequentially)."""
        self._batching += 1
        try:
            yield
        finally:
            self._batching -= 1
            if not self._batching:
                self.flush()

    def flush(self) -> None:
        if self._service is None:
            return
        # A connection-aware service (DeltaManager) holds the outbox while
        # offline; ops ride out on the post-reconnect flush instead.
        if not getattr(self._service, "can_send", True):
            return
        # Resume any wire messages a previous failed flush left behind —
        # identical bytes, so receivers' chunk reassembly stays coherent
        # and already-taken idRanges are preserved.
        self._drain_wire()
        if not self._outbox:
            return
        batch, self._outbox = self._outbox, []
        contents = {"type": "groupedBatch", "v": BATCH_WIRE_VERSION,
                    "ops": batch}
        id_range = self.id_compressor.take_next_creation_range()
        if id_range is not None:
            contents["idRange"] = id_range
        for i, wire_contents in enumerate(
                encode_batch(contents, self.options.compression_threshold,
                             self.options.chunk_size)):
            if i == 0:
                client_seq = batch[0]["clientSeq"]
                first_gen = id_range["firstGen"] if id_range else None
            else:
                # Extra chunk messages ride fresh runtime client_seqs
                # (the sequencer dedups per message).
                self._client_seq += 1
                client_seq = self._client_seq
                first_gen = None
            self._pending_wire.append((
                RawOperation(
                    client_id=self.client_id,
                    client_seq=client_seq,
                    ref_seq=self.ref_seq,
                    type=MessageType.OP,
                    contents=wire_contents,
                ),
                first_gen,
            ))
        self._drain_wire()

    def _drain_wire(self) -> None:
        while self._pending_wire:
            try:
                self._service.submit(self._pending_wire[0][0])
            except (ConnectionError, TimeoutError, OSError):
                # Transient transport failure: the encoded messages stay
                # queued (identical bytes, same client_seqs) and the next
                # flush resumes the send — the submitter's pending-op
                # bookkeeping must not unwind for a retryable error.
                return
            self._pending_wire.pop(0)  # only after the send was accepted

    def discard_outbound(self) -> None:
        """Drop the held outbox and unsent wire messages (reconnect /
        rehydrate — resubmit re-issues everything), rolling any idRanges
        the discarded batches consumed back into the compressor so the
        next flush re-attaches those locals."""
        gens = [g for _op, g in self._pending_wire if g is not None]
        if gens:
            self.id_compressor.rollback_ranges(min(gens))
        self._pending_wire.clear()
        self._outbox.clear()

    def perform_gc_sweep(self) -> List[str]:
        """Submit a sequenced sweep for datastores whose unreferenced grace
        has expired.  Deletion happens when the op folds — at the same
        position on every replica (summarize() itself never mutates).
        Returns the ids proposed for sweeping."""
        ready = self.gc.sweep_ready(self.ref_seq)
        if ready and self._service is not None:
            self._submit_runtime_op({"runtime": "gcSweep", "ids": ready})
        return ready

    def _submit_runtime_op(self, envelope: dict) -> None:
        """Runtime meta-op: rides the outbox like channel ops, tracked for
        resubmit-on-reconnect until its sequenced echo arrives."""
        self._client_seq += 1
        self._outbox.append({"clientSeq": self._client_seq, **envelope})
        self._pending_runtime[self._client_seq] = envelope
        if not self._batching:
            self.flush()

    def resubmit_pending_runtime_ops(self) -> None:
        """Reconnect: re-issue unacked meta-ops in original order (before
        channel resubmits — attaches must precede their channels' ops).
        Receivers treat every meta-op idempotently, so a duplicate from a
        sequenced-but-unacked original is harmless."""
        pending = sorted(self._pending_runtime.items())
        self._pending_runtime.clear()
        for _old_seq, envelope in pending:
            self._submit_runtime_op(envelope)

    def _submit_channel_attach(self, ds_id: str, channel_id: str,
                               type_name: str) -> None:
        self._submit_runtime_op({
            "runtime": "channelAttach",
            "ds": ds_id,
            "channel": channel_id,
            "channelType": type_name,
        })

    def _submit_blob_attach(self, sha: str, content: bytes) -> None:
        """Replicate an attachment blob (BlobManager upload path)."""
        if self._service is None:
            return  # detached: the blob rides the attach summary
        self._submit_runtime_op({
            "runtime": "blobAttach",
            "sha": sha,
            "data": base64.b64encode(content).decode("ascii"),
        })

    # -- inbound ---------------------------------------------------------------

    @property
    def inbound_count(self) -> int:
        return len(self._inbound)

    def drain(self, count: Optional[int] = None) -> int:
        """Process queued inbound messages in order; returns how many."""
        n = 0
        while self._inbound and (count is None or n < count):
            self.process(self._inbound.popleft())
            n += 1
        return n

    def adopt_stashed_session(self, old_ids, aliases: Dict[tuple, int]
                              ) -> None:
        """Adopt a crashed session's identities: messages from ``old_ids``
        become local, and ``aliases`` ((old client id, old clientSeq) ->
        this runtime's clientSeq) routes their channel acks to the
        re-applied ops.  ``aliases`` is held BY REFERENCE — the rehydrate
        replay fills it incrementally while draining the tail, so copies
        would miss entries."""
        self._adopted_ids.update(old_ids)
        self._client_ids.update(old_ids)
        if self._adopted_acks:
            # Repeated adoption: fold the existing entries INTO the new
            # live dict and track that one — updating the old dict would
            # snapshot `aliases` and miss entries the replay adds later.
            aliases.update(self._adopted_acks)
        self._adopted_acks = aliases

    def process(self, msg: SequencedMessage) -> None:
        if msg.seq <= self.ref_seq:
            return  # tail overlapping a loaded summary / duplicate delivery
        self.ref_seq = max(self.ref_seq, msg.seq)
        self.min_seq = max(self.min_seq, msg.min_seq)
        self.election.observe(msg)
        self.quorum_proposals.observe(msg)
        contents = msg.contents
        if msg.type is MessageType.OP and isinstance(contents, dict):
            if contents.get("type") == "chunk":
                # Partial chunks still advance the window; the batch
                # processes at the FINAL chunk's sequence number.
                contents = self._chunks.feed(msg.client_id, contents)
            else:
                contents = maybe_decompress(contents)
        # Attribute AFTER chunk reassembly: only the final chunk's seq is
        # ever stamped on DDS state — recording partial-chunk seqs would
        # store rows nothing can resolve, in every future summary.
        if self.attribution_enabled and contents is not None:
            self.attributor.observe(msg)
        if msg.type is MessageType.OP and isinstance(contents, dict) \
                and contents.get("type") == "groupedBatch":
            check_batch_version(contents)
            if "idRange" in contents:
                self.id_compressor.finalize_range(contents["idRange"])
            local = msg.client_id in self._client_ids
            for sub in contents["ops"]:
                if local and "runtime" in sub:
                    self._pending_runtime.pop(sub["clientSeq"], None)
                if sub.get("runtime") == "blobAttach":
                    self.blob_manager.process_attach(sub["sha"], sub["data"])
                    continue
                if sub.get("runtime") == "gcSweep":
                    self.gc.apply_sweep(sub["ids"])
                    continue
                if sub.get("runtime") == "dsAttach":
                    existing = self.datastores.get(sub["ds"])
                    if existing is None:
                        ds = FluidDataStoreRuntime(
                            sub["ds"], self.registry,
                            rooted=sub.get("rooted", True),
                        )
                        ds._attach(self)
                        self.datastores[sub["ds"]] = ds
                    elif existing.rooted != sub.get("rooted", True):
                        # Two clients created the same id with different
                        # GC rootedness: an app-level id collision — fail
                        # loudly rather than letting GC diverge.
                        raise RuntimeError(
                            f"conflicting dsAttach for {sub['ds']!r}: "
                            f"rooted={existing.rooted} vs "
                            f"{sub.get('rooted', True)}"
                        )
                    continue
                if sub.get("runtime") == "channelAttach":
                    ds = self.datastores.get(sub["ds"])
                    if ds is not None:
                        ds._materialize_remote_channel(
                            sub["channelType"], sub["channel"]
                        )
                    continue
                ds = self.datastores.get(sub["ds"])
                if ds is not None:
                    sub_cs = sub["clientSeq"]
                    sub_local = local
                    if msg.client_id in self._adopted_ids:
                        translated = self._adopted_acks.get(
                            (msg.client_id, sub_cs)
                        )
                        if translated is None:
                            # Adopted-session op with no re-applied
                            # counterpart (shouldn't occur for channel
                            # ops): apply as remote rather than tripping
                            # an ack FIFO it was never entered into.
                            sub_local = False
                        else:
                            sub_cs = translated
                    ds.process(
                        dataclasses.replace(
                            msg,
                            client_seq=sub_cs,
                            ref_seq=sub.get("refSeq", msg.ref_seq),
                        ),
                        sub, sub_local,
                    )
        elif msg.type in (MessageType.JOIN, MessageType.LEAVE):
            # Consensus-style channels react to quorum membership (held
            # items / task assignments of a departed client re-queue).
            if msg.type is MessageType.LEAVE:
                self._chunks.drop(msg.contents["clientId"])
            for ds in self.datastores.values():
                for channel in ds.channels.values():
                    observe = getattr(channel, "observe_protocol", None)
                    if observe is not None:
                        observe(msg)
        self._advance_all(msg.seq, msg.min_seq)
        for fn in list(self.message_observers):
            fn(msg)

    def _advance_all(self, seq: int, min_seq: int) -> None:
        for ds in self.datastores.values():
            ds.advance(seq, min_seq)

    # -- reconnect -------------------------------------------------------------

    def reconnect(self, service, client_id: str) -> None:
        """Catch-up-then-resubmit: the caller must first deliver (via the
        new service subscription or a log replay into ``process``) every
        message up to the head — acks for previously-sequenced pending ops
        land during that catch-up — then this resubmits the remainder."""
        self.connect(service, client_id)
        self.drain()
        for ds in self.datastores.values():
            ds.resubmit_pending()
        self.flush()

    # -- quorum proposals ------------------------------------------------------

    def propose(self, key: str, value) -> None:
        """Submit a quorum proposal (code details etc.).  It sequences like
        any op, stays pending until the MSN passes its seq, then commits on
        every replica (``quorum_proposals.get(key)``).  An unsequenced
        proposal dropped by a reconnect is NOT resubmitted — proposals are
        idempotent to re-propose, and the reference likewise rejects
        in-flight proposals on connection loss.

        client_seq ordering: the outbox flushes FIRST so held channel ops
        take their (lower) client_seqs before the proposal — a proposal
        jumping the queue would advance the sequencer's dedup floor and
        silently drop the later batch flush.  For the same reason proposing
        inside ``order_sequentially`` or while unable to send refuses."""
        if self._service is None or self.client_id is None:
            raise RuntimeError("propose requires a connected container")
        if self._batching:
            raise RuntimeError("cannot propose inside order_sequentially")
        if not getattr(self._service, "can_send", True):
            raise ConnectionError(
                "cannot propose while disconnected or read-only"
            )
        self.flush()
        self._client_seq += 1
        raw = RawOperation(
            client_id=self.client_id,
            client_seq=self._client_seq,
            ref_seq=self.ref_seq,
            type=MessageType.PROPOSAL,
            contents={"key": key, "value": value},
        )
        self._pending_wire.append((raw, None))
        self._drain_wire()

    # -- summaries -------------------------------------------------------------

    #: Container summary FORMAT version: readers accept at-or-below
    #: (absent = 1) and refuse newer — see load().
    SUMMARY_FORMAT_VERSION = 1

    @staticmethod
    def container_metadata(seq: int, min_seq: int,
                           attribution: bool = False) -> dict:
        """The .metadata blob content — ONE construction point shared with
        the catch-up service (their root digests must stay identical)."""
        meta = {"seq": seq, "minSeq": min_seq,
                "format": ContainerRuntime.SUMMARY_FORMAT_VERSION}
        if attribution:
            meta["attribution"] = True  # absent = off (legacy bytes stable)
        return meta

    def summarize(self) -> SummaryTree:
        tree = SummaryTree()
        meta = self.container_metadata(self.ref_seq, self.min_seq,
                                       attribution=self.attribution_enabled)
        tree.add_blob(".metadata", canonical_json(meta))
        # Protocol state: quorum membership + propose/accept state (new
        # pre-summary JOINs — the log below the summary is collectible).
        tree.add_blob(
            ".protocol", canonical_json({
                "proposals": self.quorum_proposals.serialize(),
                "quorum": self.election.quorum,
            })
        )
        tree.add_blob(
            ".idCompressor", canonical_json(self.id_compressor.serialize())
        )
        if self.attribution_enabled:
            tree.add_blob(
                ".attribution", canonical_json(self.attributor.serialize())
            )
        ds_summaries = {
            ds_id: self.datastores[ds_id].summarize(self.min_seq)
            for ds_id in sorted(self.datastores)
        }
        # GC stamping over sequenced state at the summary point: identical
        # for any replica summarizing at the same seq with the same
        # inherited gc state (single-writer summarizer model).  Sweeping is
        # NOT done here — see perform_gc_sweep().
        gc_state = self.gc.run(ds_summaries, self.ref_seq)
        tree.add_blob(".gc", canonical_json(gc_state))
        tree.children[".blobs"] = self.blob_manager.summarize(
            self.gc.surviving_blob_shas(self.ref_seq)
        )
        ds_tree = tree.add_tree(".datastores")
        for ds_id in sorted(ds_summaries):
            ds_tree.children[ds_id] = ds_summaries[ds_id]
        return tree

    def load(self, summary: SummaryTree) -> int:
        """Load from a summary; returns the summary's sequence point (the
        caller replays the op tail after it)."""
        meta = json.loads(summary.blob_bytes(".metadata"))
        fmt = meta.get("format", 1)  # absent = the pre-version format
        if fmt > self.SUMMARY_FORMAT_VERSION:
            raise ValueError(
                f"summary format {fmt} is newer than supported "
                f"{self.SUMMARY_FORMAT_VERSION}"
            )
        self.ref_seq = meta["seq"]
        self.min_seq = meta["minSeq"]
        protocol = json.loads(summary.blob_bytes(".protocol"))
        self.election._order = list(protocol["quorum"])
        # Missing key = an N-1 summary written before proposals existed.
        self.quorum_proposals = QuorumProposals.deserialize(
            protocol.get("proposals")
        )
        if ".idCompressor" in summary.children:
            self.id_compressor = IdCompressor.deserialize(
                json.loads(summary.blob_bytes(".idCompressor"))
            )
        # The DOCUMENT decides attribution (metadata stamp beats local
        # options — mixed on/off replicas would diverge on summary bytes).
        # Missing blob = a pre-attribution or attribution-off summary:
        # start empty (reads on older content return None, never lie).
        self.attribution_enabled = bool(meta.get("attribution", False))
        self.attributor = Attributor.deserialize(
            json.loads(summary.blob_bytes(".attribution"))
            if ".attribution" in summary.children else None
        )
        if ".gc" in summary.children:
            self.gc.load_state(json.loads(summary.blob_bytes(".gc")))
        if ".blobs" in summary.children:
            self.blob_manager.load(summary.get(".blobs"))
        self.datastores = {}
        ds_root = summary.get(".datastores")
        for ds_id, subtree in sorted(ds_root.children.items()):
            ds = FluidDataStoreRuntime(ds_id, self.registry)
            ds._attach(self)
            ds.load(subtree)
            self.datastores[ds_id] = ds
        return meta["seq"]
