"""Loader and Container — document lifecycle above the driver layer.

Capability-equivalent of the reference's ``Loader.resolve()`` /
``Container`` (SURVEY.md §2.1 container-loader, §3.2 load+catch-up path):

- **create**: build initial state, upload the attach summary, connect;
- **load**: latest summary → catch-up replay of the op tail from delta
  storage → live connection → connected (THE north-star client path);
- **audience**: who is in the collaboration, folded from join/leave;
- **pending state**: ``close_and_get_pending_state()`` captures unacked
  local ops; ``Loader.resolve(..., pending_state=...)`` rehydrates them
  (the reference's stashed-ops offline/crash-resume flow).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..protocol.messages import MessageType, SequencedMessage
from ..runtime.container import ContainerRuntime
from ..runtime.op_pipeline import decode_stream as _decode_stream
from ..runtime.registry import ChannelRegistry
from ..utils.telemetry import MonitoringContext, PerformanceEvent
from .delta_manager import ConnectionState, DeltaManager


class Audience:
    """Connected-client roster, folded from the sequenced join/leave stream
    (the reference's IAudience)."""

    def __init__(self) -> None:
        self._members: Dict[str, dict] = {}

    def observe(self, msg: SequencedMessage) -> None:
        if msg.type is MessageType.JOIN:
            cid = msg.contents["clientId"]
            self._members[cid] = {"clientId": cid, "joinedSeq": msg.seq}
        elif msg.type is MessageType.LEAVE:
            self._members.pop(msg.contents["clientId"], None)

    @property
    def members(self) -> List[str]:
        return sorted(self._members)

    def get(self, client_id: str) -> Optional[dict]:
        return self._members.get(client_id)


class Container:
    """One loaded document: runtime + delta manager + audience."""

    def __init__(
        self,
        doc_id: str,
        runtime: ContainerRuntime,
        delta_manager: DeltaManager,
    ) -> None:
        self.doc_id = doc_id
        self.runtime = runtime
        self.delta_manager = delta_manager
        self.audience = Audience()
        self.catchup_ops = 0  # ops replayed from delta storage at load
        # Members whose JOIN predates the loaded summary are only visible
        # in the summary's quorum — seed from it (joinedSeq unknowable).
        for cid in runtime.election.quorum:
            self.audience._members[cid] = {"clientId": cid,
                                           "joinedSeq": None}
        # Observe through the runtime so every processed message — backfill
        # and live alike — folds into the audience.
        runtime.message_observers.append(self.audience.observe)
        self.closed = False

    # -- state -----------------------------------------------------------------

    @property
    def connection_state(self) -> ConnectionState:
        return self.delta_manager.state

    @property
    def connected(self) -> bool:
        return self.delta_manager.state is ConnectionState.CONNECTED

    @property
    def client_id(self) -> Optional[str]:
        return self.delta_manager.client_id

    # -- op pumping ------------------------------------------------------------

    def drain(self) -> int:
        """Process everything queued inbound (tests/hosts drive delivery
        explicitly; a live host would pump this from its event loop).

        A staleView op-nack (queued wire bytes referencing a view below the
        collaboration window) is repaired here by reconnecting: the
        reconnect discards the stale encodings and rebases pending ops to
        a fresh view — resending identical bytes would livelock.

        A shard fence is repaired the same way, WITHOUT host polling: the
        DeltaManager flagged ``fence_required`` when a submit hit the
        dead shard, and ``reconnect()`` re-resolves the recovered owner
        through the manager's factory resolver and replays the held
        outbound ops (discard + resubmit) itself."""
        n = self.runtime.drain()
        if self.delta_manager.rebase_required:
            self.delta_manager.rebase_required = False
            self.reconnect()
            n += self.runtime.drain()
        if self.delta_manager.fence_required:
            self.reconnect()
            n += self.runtime.drain()
        return n

    # -- connection lifecycle --------------------------------------------------

    def disconnect(self) -> None:
        self.delta_manager.disconnect()

    def reconnect(self, client_id: Optional[str] = None,
                  document_service=None) -> None:
        """Reconnect and resubmit pending ops (catch-up first so acks for
        already-sequenced pending ops land, then resubmit the rest)."""
        self.delta_manager.reconnect(client_id, document_service)
        self.runtime.client_id = self.delta_manager.client_id
        self.runtime._client_ids.add(self.delta_manager.client_id)
        self.drain()
        self.discard_outbound()
        self.resubmit_pending()
        self.runtime.flush()

    def discard_outbound(self) -> None:
        """Drop the offline-held outbox and any half-sent wire messages:
        resubmit_pending re-issues every unacked op with fresh client_seqs
        under the new connection (keeping both would double-send; the old
        connection's partial chunk trains die with its LEAVE).  Unsent
        idRanges roll back into the compressor for re-attachment."""
        self.runtime.discard_outbound()

    def resubmit_pending(self, force_rebase: bool = False) -> None:
        """Re-issue every unacked op.  Meta-ops (ds/channel/blob attaches)
        first: their channels' ops must land on materialized targets."""
        self.runtime.resubmit_pending_runtime_ops()
        for ds in self.runtime.datastores.values():
            ds.resubmit_pending(force_rebase=force_rebase)

    def close(self) -> None:
        # Idempotent (fluidleak FL-LEAK-DOUBLE-CLOSE): close() is called
        # directly by hosts AND by close_and_get_pending_state(); the
        # second call must not re-run the disconnect protocol.
        if self.closed:
            return
        # Flag only after the disconnect protocol succeeds: an RpcError
        # mid-close must leave close() retryable (delta_manager.close is
        # re-entrant via its state check), not strand the subscription.
        self.delta_manager.close()
        self.closed = True

    # -- pending local state (stashed ops) -------------------------------------

    def get_pending_ops(self) -> List[dict]:
        """Unacked local channel ops in submission order.  Each op records
        the ``refSeq`` it was authored against: rehydrate re-applies it at
        exactly that point of the tail replay, because remote ops sequenced
        between authoring and the stash (e.g. removes shrinking a string)
        make stash-point positions unresolvable (load-harness-found)."""
        own_ids = sorted(
            self.runtime._client_ids - self.runtime._adopted_ids
        )
        pending = []
        for ds_id, ds in self.runtime.datastores.items():
            for channel_id, channel in ds.channels.items():
                for client_seq, contents, _meta, ref in channel._pending:
                    pending.append({
                        "clientSeq": client_seq,
                        "refSeq": ref,
                        # Every wire identity this op may sequence under:
                        # this session's own connection ids.  (Adopted
                        # prior-generation identities need no aliases
                        # here: transports submit synchronously, so a
                        # prior generation's copy either sequenced before
                        # our own rehydrate drained — acked then — or
                        # never will.  An async transport would need
                        # resubmit-time alias threading.)
                        "aliases": [[cid, client_seq] for cid in own_ids],
                        "ds": ds_id,
                        "channel": channel_id,
                        "contents": contents,
                    })
        pending.sort(key=lambda p: p["clientSeq"])
        return pending

    def close_and_get_pending_state(self) -> dict:
        """Capture everything needed to resume this session offline: the
        processed sequence point, unacked local ops, and the client ids
        they were submitted under (rehydrate uses those to drop stashed
        ops that *did* get sequenced — we just never saw the ack).
        Summary and op tail are re-fetched from the (durable) service at
        rehydrate time."""
        state = {
            "docId": self.doc_id,
            "refSeq": self.runtime.ref_seq,
            "clientIds": sorted(self.runtime._client_ids),
            "pending": self.get_pending_ops(),
        }
        self.close()
        return state


class Loader:
    """Resolves documents through a driver factory into Containers."""

    def __init__(self, factory,
                 registry: Optional[ChannelRegistry] = None,
                 mc: Optional[MonitoringContext] = None,
                 runtime_options=None,
                 clock: Optional[Callable[[], float]] = None,
                 retry=None) -> None:
        self.factory = factory
        self.registry = registry
        self.runtime_options = runtime_options
        self.mc = (mc or MonitoringContext()).child("loader")
        # Injected time source for every DeltaManager this loader wires
        # (None = wall clock).  Replay harnesses pass a virtual clock so
        # nack retryAfter holds resolve identically on every run.
        self.clock = clock
        #: RetryPolicy threaded into every DeltaManager (None = no
        #: inline retries; the runtime's flush-requeue contract still
        #: applies).  Backoff rides ``clock.sleep`` when the injected
        #: clock provides one (VirtualClock), so replay stays exact.
        self.retry = retry

    def _delta_manager(self, doc_id: str, service) -> DeltaManager:
        """One place wires every DeltaManager: the clock, the retry
        policy, and the fence resolver (re-resolving through the factory
        reaches the router's CURRENT owner — the self-healing reconnect
        after a shard failover)."""
        return DeltaManager(
            service, clock=self.clock,
            resolver=lambda: self.factory.resolve(doc_id),
            retry=self.retry,
        )

    def _new_runtime(self) -> ContainerRuntime:
        return ContainerRuntime(self.registry, options=self.runtime_options)

    # -- create (attach flow) --------------------------------------------------

    def create(
        self,
        doc_id: str,
        client_id: str,
        build: Callable[[ContainerRuntime], Any],
    ) -> Container:
        """Create a new document: ``build(runtime)`` seeds datastores and
        channels detached; their state rides the initial (attach) summary."""
        runtime = self._new_runtime()
        build(runtime)
        service = self.factory.create_document(
            doc_id, runtime.summarize(), ref_seq=0
        )
        return self._wire(doc_id, runtime, service, client_id)

    # -- load (catch-up flow) --------------------------------------------------

    def resolve(
        self,
        doc_id: str,
        client_id: Optional[str] = None,
        pending_state: Optional[dict] = None,
        stale_pending: str = "rebase",
    ) -> Container:
        """Load a document: summary + catch-up replay + live connection.
        ``client_id=None`` loads read-only-detached (e.g. replay driver).
        ``pending_state`` rehydrates a previous session's unacked ops.
        ``stale_pending``: when the stash's view has fallen below the
        collaboration window its ops cannot ship with their original view —
        ``"rebase"`` (default) regenerates them against the current view,
        ``"raise"`` surfaces StaleOpError (host decides), ``"drop"``
        discards the stashed ops and loads clean."""
        if pending_state is not None and client_id is None:
            raise ValueError("rehydrating pending state requires a live "
                             "client_id (stashed ops must be resubmitted)")
        with PerformanceEvent.timed_exec(
                self.mc.logger, "containerLoad", docId=doc_id) as perf:
            container = self._resolve(doc_id, client_id, pending_state,
                                      stale_pending)
            perf["extra"]["catchupOps"] = container.catchup_ops
        return container

    def _resolve(
        self,
        doc_id: str,
        client_id: Optional[str],
        pending_state: Optional[dict],
        stale_pending: str = "rebase",
    ) -> Container:
        if stale_pending not in ("rebase", "drop", "raise"):
            raise ValueError(
                f"stale_pending must be 'rebase', 'drop', or 'raise', "
                f"got {stale_pending!r}"
            )
        service = self.factory.resolve(doc_id)
        runtime = self._new_runtime()

        # Rehydrating: the summary must not be newer than ANY replayed op's
        # authoring view — each op re-applies at exactly its own refSeq
        # during the tail replay (remote ops sequenced between authoring
        # and the stash can shrink/shift position-carrying contents).  The
        # replay set is the stash's pending ops PLUS the crashed session's
        # own ops sequenced above the load point (their optimistic text
        # was part of later ops' views), so the load point is a fixpoint:
        # lowering it can expose own sequenced ops with still-earlier
        # authoring refs.
        stash_ref = pending_state["refSeq"] if pending_state else None
        load_ref = stash_ref
        if pending_state is not None:
            refs = [p["refSeq"] for p in pending_state["pending"]
                    if p.get("refSeq") is not None]
            if refs:
                load_ref = min([stash_ref] + refs)
        old_ids = set(pending_state.get("clientIds", [])) \
            if pending_state else set()
        summary = None
        converged = False
        # Loop to fixpoint: each refetch strictly lowers load_ref over a
        # finite tail, so termination is structural — no iteration cap
        # (a cap made legitimately deep convergent stashes fail).
        while not converged:
            summary, summary_seq = service.storage.latest(
                at_or_below=load_ref
            )
            if summary is None:
                raise KeyError(f"document {doc_id!r} has no summary "
                               f"(never attached)")
            tail = service.delta_storage.get(from_seq=summary_seq)
            if load_ref is None or not old_ids:
                converged = True
                break
            while True:
                own_refs = [
                    sub.get("refSeq", msg.ref_seq)
                    for msg, batch in _decode_stream(
                        m for m in tail
                        if m.client_id in old_ids
                        and load_ref < m.seq <= stash_ref
                        and m.type is MessageType.OP)
                    for sub in batch["ops"] if "runtime" not in sub
                ]
                lower = min(own_refs, default=load_ref)
                if lower >= load_ref:
                    converged = True
                    break
                load_ref = lower
                if load_ref < summary_seq:
                    break  # need an older summary: refetch
        runtime.load(summary)

        container = Container(doc_id, runtime,
                              self._delta_manager(doc_id, service))

        # Catch-up replay: one fetch of the whole tail, split at the
        # earliest replayed authoring point and at the stash point.  THE
        # hot loop the device catch-up service obsoletes when it keeps
        # summaries fresh.
        pre = [m for m in tail if load_ref is None or m.seq <= load_ref]
        mid = [m for m in tail
               if load_ref is not None and load_ref < m.seq <= stash_ref]
        post_stash = tail[len(pre) + len(mid):]
        for msg in pre:
            runtime.process(msg)
        # The mid tail counts as storage catch-up only where it is actually
        # replayed by _apply_stashed below; on drop/no-stash paths it is
        # delivered by the post-connect live drain instead.
        container.catchup_ops = len(pre)
        container.delta_manager.note_delivered(runtime.ref_seq)

        if pending_state is not None and pending_state["pending"]:
            # Stash staleness: the collaboration window moved past the
            # stash's view while the session was down.  Default ("rebase"):
            # proceed — the resubmit below regenerates each op against the
            # current view (per-DDS, segment-identity-exact for sequences).
            head_msn = max((m.min_seq for m in post_stash),
                           default=runtime.min_seq)
            if pending_state["refSeq"] < head_msn:
                # Only ops that will actually be re-applied gate the load:
                # stashed ops already in the durable tail are deduped away
                # and never need a rebase.
                sequenced = self._already_sequenced(pending_state,
                                                    post_stash)
                old_ids = pending_state.get("clientIds", [])

                def _cannot_rebase(p) -> bool:
                    ds = runtime.datastores.get(p["ds"])
                    ch = ds.channels.get(p["channel"]) if ds else None
                    # A channel attaching in the mid tail isn't
                    # materialized yet; its ops replay normally.
                    return ch is not None and not ch.can_rebase

                cannot = sorted({
                    p["channel"] for p in pending_state["pending"]
                    if not any((cid, p["clientSeq"]) in sequenced
                               for cid in old_ids)
                    and _cannot_rebase(p)
                }) if stale_pending == "rebase" else []
                if stale_pending == "drop":
                    pending_state = None
                elif stale_pending == "raise" or cannot:
                    from ..dds.shared_object import StaleOpError

                    why = (f"channels {cannot} cannot rebase their pending "
                           f"ops; " if cannot else "")
                    raise StaleOpError(
                        f"{doc_id}: stashed pending state (refSeq "
                        f"{pending_state['refSeq']}) is below the "
                        f"collaboration window ({head_msn}); {why}pass "
                        f"stale_pending='drop' to load without it"
                        + ("" if cannot else " or 'rebase' to regenerate "
                           "against the current view")
                    )

        if client_id is not None:
            # Connect first (channels need a live submit path), then re-apply
            # stashed ops INTERLEAVED with the tail between their authoring
            # points — each op resolves against exactly the view it was
            # created on (earlier stashed ops re-applied on top as pending).
            container.runtime.connect(container.delta_manager, client_id)
            if pending_state is not None:
                # Hold the auto-flush so the stashed re-submissions buffer in
                # the outbox instead of hitting the wire: they are pinned to
                # views that may lie below the live collaboration window.
                # Discard the buffered batch, adopt the crashed session's
                # client ids (ops of ours that DID sequence arrive in the
                # post-stash tail as OUR acks — nacks are synchronous at
                # submit, so the sequenced subset is always a clientSeq
                # prefix and the ack FIFOs stay ordered), catch up to head,
                # and resubmit what remains pending — ops go out pinned to
                # an in-window view, regenerated (rebased) where the
                # original view is stale.
                aliases: dict = {}
                runtime.adopt_stashed_session(
                    pending_state.get("clientIds", []), aliases
                )
                runtime._batching += 1
                try:
                    self._apply_stashed(runtime, pending_state, mid,
                                        post_stash, stash_ref, aliases)
                finally:
                    runtime._batching -= 1
                container.catchup_ops += len(mid)
                container.delta_manager.note_delivered(runtime.ref_seq)
                container.discard_outbound()
                container.drain()
                # This session's id differs from the crashed one's, so
                # old-view-pinned resubmission would lie about own-op
                # visibility: always regenerate against the current view.
                container.resubmit_pending(force_rebase=True)
            container.drain()
            container.runtime.flush()
        return container

    # -- internals -------------------------------------------------------------

    @staticmethod
    def _already_sequenced(pending_state: dict,
                           post_stash_tail: List[SequencedMessage]):
        """(old client id, clientSeq) pairs from the stash that appear in
        the durable tail — ops that DID reach the sequencer; the session
        just crashed before processing the ack.  The tail is decoded
        through the full op pipeline (grouped, compressed, AND chunked
        batches), or over-threshold batches would hide sequenced ops and
        cause a double-apply."""
        from ..runtime.op_pipeline import decode_stream

        old_ids = set(pending_state.get("clientIds", []))
        sequenced = set()
        for msg, batch in decode_stream(
                m for m in post_stash_tail
                if m.client_id in old_ids and m.type is MessageType.OP):
            for sub in batch["ops"]:
                sequenced.add((msg.client_id, sub["clientSeq"]))
        return sequenced

    def _apply_stashed(self, runtime: ContainerRuntime, pending_state: dict,
                       mid_tail: List[SequencedMessage],
                       post_stash_tail: List[SequencedMessage],
                       stash_ref: int, aliases: Dict[tuple, int]) -> None:
        """Re-apply the crashed session's ops as fresh local mutations
        (optimistic apply + submit) on exactly the state each was created
        against (the reference's PendingStateManager).

        The replay set is the stash's pending ops MERGED with the old
        session's own ops already sequenced in the mid tail — the latter
        were still pending when later ops were authored, so their
        optimistic text is part of those ops' views.  The tail between the
        load point and the stash point is applied incrementally, pausing
        at each op's authoring ``refSeq``; sequenced own copies arriving
        in the drain ack the re-applied ops through the (caller-adopted,
        incrementally filled) ``aliases`` map."""
        from ..runtime.op_pipeline import decode_stream

        old_ids = set(pending_state.get("clientIds", []))
        # Sorted once up front: the loops below run per pending op, and
        # alias-adoption order must not depend on set hash order.
        old_sorted = sorted(old_ids)
        if any(p.get("refSeq") is None for p in pending_state["pending"]):
            # Legacy stash (no per-op authoring points): previous
            # semantics — drop ops the tail will deliver, re-apply the
            # rest at the stash point.  (No aliases: adopted copies apply
            # as remote, exactly as before.)
            sequenced = self._already_sequenced(pending_state,
                                                post_stash_tail)
            for msg in mid_tail:
                runtime.process(msg)
            for p in pending_state["pending"]:
                if any((cid, p["clientSeq"]) in sequenced
                       for cid in old_sorted):
                    continue
                ds = runtime.datastores[p["ds"]]
                ds.channels[p["channel"]].apply_stashed_op(p["contents"])
            return

        def chan(p):
            ds = runtime.datastores.get(p["ds"])
            return ds.channels.get(p["channel"]) if ds is not None else None

        # Channels whose dsAttach/channelAttach echo still rides the mid
        # tail don't exist at the load point: their ops' replay refs FLOOR
        # at the attach seq (no remote channel op can precede the attach,
        # so delaying to it is exact), keeping the main drain loop from
        # overshooting later ops' authoring views.
        attach_floor: Dict[tuple, int] = {}
        for msg, batch in _decode_stream(
            m for m in mid_tail if m.type is MessageType.OP
        ):
            for sub in batch["ops"]:
                if sub.get("runtime") == "dsAttach":
                    attach_floor[(sub["ds"], None)] = msg.seq
                elif sub.get("runtime") == "channelAttach":
                    attach_floor[(sub["ds"], sub["channel"])] = msg.seq

        def replay_ref(p):
            # Channels that cannot rebase keep the documented stash-point
            # reinterpretation — re-applying at the fresh stash view is
            # their recovery semantics and keeps their resubmission off
            # the rebase path.  (All built-in DDSes, including the matrix
            # since its handle-based rebase landed, are rebasable and take
            # the exact per-op path.)
            c = chan(p)
            base = p["refSeq"] if c is None or c.can_rebase else stash_ref
            return max(
                base,
                attach_floor.get((p["ds"], None), 0),
                attach_floor.get((p["ds"], p["channel"]), 0),
            )

        own_mid: List[dict] = []
        for msg, batch in decode_stream(
            m for m in mid_tail
            if m.client_id in old_ids and m.type is MessageType.OP
        ):
            for sub in batch["ops"]:
                if "runtime" in sub:
                    continue
                entry = {
                    "clientSeq": sub["clientSeq"],
                    "refSeq": sub.get("refSeq", msg.ref_seq),
                    "ds": sub["ds"], "channel": sub["channel"],
                    "contents": sub["contents"],
                    "aliases": [[msg.client_id, sub["clientSeq"]]],
                }
                # A non-rebasable channel's own sequenced op would replay
                # AFTER its wire copy drained (it defers to the stash
                # point) — the copy already applied as remote, so
                # re-applying would double-apply.  Skip it.  (A channel
                # not yet materialized attaches in the mid tail: its ops
                # replay normally.)
                c = chan(entry)
                if c is None or c.can_rebase:
                    own_mid.append(entry)
        ops = sorted(own_mid + list(pending_state["pending"]),
                     key=lambda p: (replay_ref(p), p["clientSeq"]))
        i = 0
        for p in ops:
            ref = replay_ref(p)
            while i < len(mid_tail) and mid_tail[i].seq <= ref:
                runtime.process(mid_tail[i])
                i += 1
            channel = chan(p)
            if channel is None:
                raise KeyError(
                    f"stashed op targets unknown channel "
                    f"{p['ds']}/{p['channel']}"
                )
            channel.apply_stashed_op(p["contents"])
            new_cs = channel._pending[-1][0]
            op_aliases = p.get("aliases")
            if op_aliases is None:
                op_aliases = [[c, p["clientSeq"]] for c in old_sorted]
            for cid, cs in op_aliases:
                aliases[(cid, cs)] = new_cs
        while i < len(mid_tail):
            runtime.process(mid_tail[i])
            i += 1

    def _wire(self, doc_id: str, runtime: ContainerRuntime, service,
              client_id: str) -> Container:
        container = Container(doc_id, runtime,
                              self._delta_manager(doc_id, service))
        container.delta_manager.note_delivered(runtime.ref_seq)
        container.runtime.connect(container.delta_manager, client_id)
        container.drain()
        container.runtime.flush()
        return container
