"""The network front door: a TCP ordering server over LocalOrderingService.

The port's copy of ``fluidframework_tpu/service/server.py``.  Its one
change is the device: ``OrderingServer(..., device="cuda")`` checks the
device when it is built (without a CUDA device, ``"cuda"`` raises there,
so a server never starts only to fail its first ``catchup``) and hands it
to the lazily built ``CatchupService``, and through it to the streaming
fold; ``main`` takes ``--device`` (default ``cuda``) where the reference
took ``--platform``.

Capability-equivalent of the reference's Alfred/Nexus socket ingress plus
Tinylicious's standalone single-process server (SURVEY.md §2.3): clients
in OTHER processes speak a length-prefixed JSON frame protocol over
localhost/LAN TCP to create documents, connect, submit ops, receive the
sequenced broadcast, exchange signals, read delta ranges, and read/write
summaries.

Frame protocol (version-stamped; little deliberately, since the payloads
are the same dicts the in-proc path uses):

    [4-byte big-endian length][json bytes]

    request:   {"v": 1, "id": N, "method": str, "params": {...}}
    response:  {"v": 1, "re": N, "ok": true, "result": ...}
               {"v": 1, "re": N, "ok": false, "error": str}
    event:     {"v": 1, "event": "op"|"signal", "doc": str, ...}

Broadcast ordering guarantee: `subscribe_doc`'s response is written to the
socket before any subsequent op event for that document (asyncio per-
connection FIFO), and the deltas snapshot a client then requests rides the
same socket — so the client sees (response, snapshot, live tail) with any
overlap deduplicated client-side by the DeltaManager's delivery watermark.

Run standalone (the Tinylicious shape):

    python -m fluidframework_tpu_torch.service.server --port 7070 \
        [--dir path] [--shards N] [--device cuda|cpu]
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional, Set, Tuple

from ..ops.mergetree_kernel import resolve_device
from ..protocol.messages import (DocRelocatedError, NackError,
                                 ShardFencedError)
from ..protocol.summary import tree_from_obj, tree_to_obj
from ..protocol.wire import (LEN as _LEN, MAX_FRAME, WIRE_VERSION,
                             decode_raw_operation,
                             encode_sequenced_message, frame_bytes)
from . import gates
from .broadcaster import Broadcaster
from .orderer import LocalOrderingService


class EpochMismatch(Exception):
    """A storage request pinned to a DIFFERENT storage generation (odsp
    EpochTracker capability): the client's cached snapshots/deltas came
    from a store that no longer exists — fail loudly, never mix."""

    def __init__(self, client_epoch: str, server_epoch: str) -> None:
        super().__init__(
            f"storage epoch mismatch: client pinned {client_epoch!r}, "
            f"server is {server_epoch!r} (the store was recreated; cached "
            f"state is from a dead generation)"
        )
        self.server_epoch = server_epoch


#: fold-cost EMA seed (seconds): the controller's pacing estimate before
#: any lease has released.  Module-level so a harness that mirrors the
#: EMA from its own observations (the storm verdict's cost_ema
#: cross-check, testing/scenarios.py) shares the exact seed.
ADMISSION_COST_INIT = 0.25


class AdmissionController:
    """Adaptive admission for the catch-up fold lane.

    A fixed-size semaphore with a hardcoded ``retry_after`` paces a
    storm blindly.  This controller derives both the
    shed decision and the pacing from MEASURED load, entirely off an
    injectable clock, so a deterministic harness (VirtualClock) replays
    every admission decision bit-identically:

    - a fold holds a **lease** from admit until release; ``release`` may
      carry a ``hold`` — extra clock time the slot stays occupied after
      the synchronous call returns.  Production releases with hold 0
      (the slot frees when the fold thread finishes); the swarm storm
      harness models fold DURATION in virtual time this way, which is
      what lets a single-threaded deterministic driver produce real
      overlapping-fold admission pressure.
    - ``retry_after`` = measured fold cost (EMA over released leases) ×
      backlog-per-slot, clamped to ``[retry_floor, retry_cap]``: a
      deeper queue paces retries further out, a fast fold tier calls
      the herd back sooner.
    - sustained overload — ``degrade_after`` consecutive overflow
      verdicts with no slot freed between them — flips the verdict from
      ``shed`` to ``degrade``: the server answers with the stored
      summary at an older ref_seq (see ``_degraded_serve``) instead of
      pure refusal.

    **Wire-clock mode** (the storm-verdict replay debt): an
    out-of-proc shard cannot share the harness's VirtualClock object,
    so remote admission used to ride wall time — every verdict landed
    OUTSIDE replay identity.  With ``virtual = True`` the controller
    instead advances on clock values the CALLERS carry on the wire
    (:meth:`observe`, monotone max): a deterministic driver that stamps
    its virtual tick onto each catchup request makes every lease
    expiry, backlog depth, and load-derived ``retry_after`` a pure
    function of the request sequence — bit-identical on replay, process
    boundary or not.
    """

    def __init__(self, max_inflight: int, clock=None,
                 retry_floor: float = 0.05, retry_cap: float = 5.0,
                 degrade_after: int = 2,
                 cost_init: float = ADMISSION_COST_INIT) -> None:
        #: injected clock (seconds); time.monotonic in production,
        #: a VirtualClock in deterministic harnesses.
        self._clock = clock if clock is not None else time.monotonic
        self.max_inflight = max(1, int(max_inflight))
        self.retry_floor = float(retry_floor)
        self.retry_cap = float(retry_cap)
        self.degrade_after = max(0, int(degrade_after))
        self._lock = threading.Lock()
        #: token -> [admitted_at, expires]; expires None = still in
        #: flight (never expires), a float = released-with-hold lease
        #: that keeps occupying its slot until that clock time.
        self._leases: Dict[int, list] = {}  # guarded-by: _lock
        self._next_token = 0  # guarded-by: _lock
        self._cost_ema = float(cost_init)  # guarded-by: _lock
        #: consecutive overflow verdicts since the last admit — the
        #: sustained-overload signal and the queue-depth estimate (each
        #: consecutive shed implies another caller waiting out there).
        self._shed_streak = 0  # guarded-by: _lock
        #: wire-clock mode: time advances only via observe() — see the
        #: class doc.  Flipped post-ctor (a deployment flag, not config).
        self.virtual = False
        self._vnow = 0.0  # guarded-by: _lock

    def observe(self, vnow: float) -> None:
        """Wire-clock input: a caller reported ITS clock.  Monotone max
        — requests may arrive reordered across connections, and time
        never runs backwards."""
        vnow = float(vnow)
        with self._lock:
            if vnow > self._vnow:
                self._vnow = vnow

    def _now_locked(self) -> float:
        # holds-lock: _lock
        return self._vnow if self.virtual else self._clock()

    def _purge_locked(self, now: float) -> None:
        expired = [token for token, lease in self._leases.items()
                   if lease[1] is not None and lease[1] <= now]
        for token in expired:
            self._leases.pop(token)

    def admit(self) -> Tuple[str, object]:
        """One admission decision: ``("admit", token)`` — the caller
        runs its fold and MUST ``release(token)`` (try/finally) — or
        ``("shed" | "degrade", retry_after)`` under overload."""
        with self._lock:
            now = self._now_locked()
            self._purge_locked(now)
            if len(self._leases) >= self.max_inflight:
                self._shed_streak += 1
                backlog = len(self._leases) + self._shed_streak
                retry_after = min(self.retry_cap, max(
                    self.retry_floor,
                    self._cost_ema * backlog / self.max_inflight))
                verdict = ("degrade"
                           if self._shed_streak > self.degrade_after
                           else "shed")
                return verdict, retry_after
            token = self._next_token
            self._next_token += 1
            self._leases[token] = [now, None]
            self._shed_streak = 0
            return "admit", token

    def release(self, token: int, hold: float = 0.0) -> None:
        """Fold done: record its measured cost (clock delta + ``hold``)
        in the EMA the pacing derives from; with ``hold`` > 0 the lease
        keeps its slot until ``now + hold`` (purged lazily by later
        admits), else the slot frees immediately."""
        with self._lock:
            now = self._now_locked()
            lease = self._leases.get(token)
            if lease is None:
                return
            cost = max(0.0, now - lease[0]) + max(0.0, hold)
            if cost > 0.0:
                self._cost_ema = 0.5 * self._cost_ema + 0.5 * cost
            if hold > 0.0:
                lease[1] = now + hold
            else:
                self._leases.pop(token)

    def snapshot(self) -> dict:
        """Self-contained pacing record: everything a remote harness
        needs to RE-DERIVE a shed verdict's retry_after (the clamp
        bounds included), so out-of-proc storm pacing can be audited
        against the snapshot the nack carried."""
        with self._lock:
            return {
                "inflight": len(self._leases),
                "max_inflight": self.max_inflight,
                "cost_ema": round(self._cost_ema, 6),
                "shed_streak": self._shed_streak,
                "retry_floor": self.retry_floor,
                "retry_cap": self.retry_cap,
            }


#: Methods offloaded to executor threads.  Shared-state discipline: lazy
#: endpoint/orderer creation and the handle-grant map are guarded by
#: ``service.state_lock``; oplog READS during an offloaded fold rely on the
#: append-only contract (ranged reads see a prefix that never mutates —
#: a concurrent append only extends beyond the requested range).
OFFLOADED_METHODS = frozenset({"catchup", "upload_summary"})


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError):
        return None
    return json.loads(payload)


class _ClientSession:
    """One TCP connection's server-side state — and the production
    broadcast SINK: sequenced frames arrive already encoded from the
    shared :class:`Broadcaster` (one serialization per message for every
    subscriber on the server), this class only meters and writes them."""

    def __init__(self, server: "OrderingServer",
                 writer: asyncio.StreamWriter) -> None:
        self.server = server
        self.writer = writer
        self.subscribed_docs: Set[str] = set()
        self.signal_docs: Set[str] = set()
        self.connected_clients: Dict[str, str] = {}  # client_id -> doc_id
        self._tapped_by_wire: Dict[str, str] = {}  # out_doc -> internal doc
        self.tenant: Optional[str] = None  # set by a successful "auth"
        self._closed = False
        # Broadcast-frame accounting: bytes accepted by write_frame but
        # not yet handed to the transport (the cross-thread hop).  The
        # transport's own buffer is added at admission time, so the
        # budget covers the whole path to the socket.
        self._pending_lock = threading.Lock()
        self._pending_bytes = 0  # guarded-by: _pending_lock

    #: Disconnect a session whose unread RESPONSE backlog exceeds this
    #: (broadcast frames never ride this path anymore — they are metered
    #: by ``write_frame`` and demoted at ``server.broadcast_high_water``;
    #: this hard cap only guards the request/response and notification
    #: writes, which are client-paced).
    WRITE_HIGH_WATER = 32 << 20

    def send(self, obj: dict) -> None:
        """Thread-safe-ish frame write: always scheduled on the loop."""
        self.server.loop.call_soon_threadsafe(self._write, obj)

    def _write(self, obj: dict) -> None:
        if self.writer.is_closing():
            return
        transport = self.writer.transport
        if transport is not None and \
                transport.get_write_buffer_size() > self.WRITE_HIGH_WATER:
            # Laggard: drop the connection rather than buffer unboundedly.
            self.close()
            self.writer.close()
            return
        self.writer.write(frame_bytes(obj))

    # -- broadcast sink (Broadcaster protocol) ---------------------------------

    def write_frame(self, data: bytes) -> bool:
        """Accept one pre-encoded broadcast frame, or report saturation.
        Admission is metered against transport backlog + in-flight bytes:
        a stalled reader saturates here and gets DEMOTED by the
        broadcaster instead of growing the server's buffers or stalling
        the other subscribers of its documents."""
        if self._closed:
            return True  # connection is tearing down; drop silently
        fault = (self.server.faults.fire("session.write")
                 if self.server.faults is not None else None)
        if fault is not None and fault.kind == "stall":
            # Injected stalled client: report saturation exactly as a
            # full transport buffer would — the broadcaster demotes this
            # session and the client backfills from the durable log.
            return False
        transport = self.writer.transport
        buffered = (transport.get_write_buffer_size()
                    if transport is not None else 0)
        with self._pending_lock:
            if (buffered + self._pending_bytes + len(data)
                    > self.server.broadcast_high_water):
                return False
            self._pending_bytes += len(data)
        self.server.loop.call_soon_threadsafe(self._write_bytes, data)
        return True

    def _write_bytes(self, data: bytes) -> None:
        with self._pending_lock:
            self._pending_bytes -= len(data)
        if self.writer.is_closing():
            return
        self.writer.write(data)

    def write_signal(self, data: bytes, signal: dict) -> bool:
        """Signal frames share the encoded bytes across sessions; the
        per-client TARGET filter is the only per-session work left."""
        target = signal.get("targetClientId")
        if target is not None and target not in self.connected_clients:
            return True  # not addressed to this session — filtered, not lagging
        return self.write_frame(data)

    def on_demoted(self, out_doc: str, head_seq: int) -> None:
        """Broadcaster removed this session (buffer budget exceeded):
        tell the client once — it backfills the missed range from the
        durable op log (``deltas``) and re-subscribes when it catches
        up.  The notification rides the response path (small frame)."""
        doc_id = self._tapped_by_wire.get(out_doc)
        if doc_id is not None:
            self.subscribed_docs.discard(doc_id)
        self.send({"v": WIRE_VERSION, "event": "demoted", "doc": out_doc,
                   "head": head_seq})

    def on_fence(self, out_doc: str, epoch: str, head_seq: int) -> None:
        """Shard failover: the storage generation changed and this doc's
        broadcast now rides the recovered owner.  Push the new epoch so
        pinned clients unpin/drop caches proactively instead of tripping
        over epochMismatch on their next request."""
        self.send({"v": WIRE_VERSION, "event": "fence", "doc": out_doc,
                   "epoch": epoch, "head": head_seq})

    # -- broadcast taps --------------------------------------------------------

    def tap(self, doc_id: str, wire_doc: Optional[str] = None) -> None:
        if doc_id in self.subscribed_docs:
            return
        endpoint = self.server.service.endpoint(doc_id)
        out_doc = wire_doc if wire_doc is not None else doc_id
        self.server.broadcaster.attach(doc_id, endpoint, self,
                                       out_doc=out_doc)
        self.subscribed_docs.add(doc_id)
        self._tapped_by_wire[out_doc] = doc_id

    def close(self) -> None:
        # Idempotent (fluidleak FL-LEAK-DOUBLE-CLOSE): the laggard-drop
        # path (_write) closes mid-connection and _handle's finally
        # closes again on unwind; the second call must not re-run the
        # unsubscribe/disconnect sweep against re-registered state.
        if self._closed:
            return
        self._closed = True
        self.server.broadcaster.detach_all(self)
        self.subscribed_docs.clear()
        self._tapped_by_wire.clear()
        for client_id, doc_id in list(self.connected_clients.items()):
            try:
                self.server.service.endpoint(doc_id).disconnect(client_id)
            except KeyError:
                pass
        self.connected_clients.clear()


class OrderingServer:
    """Asyncio TCP server exposing a LocalOrderingService to the network."""

    def __init__(self, service: Optional[LocalOrderingService] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tenants: Optional[Dict[str, str]] = None,
                 broadcast_high_water: int = 8 << 20,
                 catchup_max_inflight: int = 4,
                 faults=None, clock=None, mc=None,
                 device="cuda") -> None:
        #: the one device every catch-up fold of this server runs on
        #: (the lazy CatchupService and the streaming fold share it),
        #: checked here: "cuda" without a card raises at construction.
        self.device = resolve_device(device)
        #: any object with the LocalOrderingService surface — including
        #: ShardedOrderingService (the front door dispatches by its
        #: router transparently: every access goes through endpoint()).
        self.service = service if service is not None else \
            LocalOrderingService()
        self.host = host
        self.port = port
        #: tenant id -> shared secret (the Riddler capability).  When set,
        #: every connection must "auth" first; document ids are namespaced
        #: per tenant so tenants cannot see each other's documents.
        self.tenants = tenants
        #: serialize-once broadcast fan-out: sessions are sinks, one
        #: encode per sequenced message regardless of subscriber count.
        self.broadcaster = Broadcaster()
        #: per-session broadcast buffer budget; a session exceeding it is
        #: demoted to catch-up-from-oplog instead of stalling the shard.
        self.broadcast_high_water = int(broadcast_high_water)
        if hasattr(self.service, "add_fence_listener"):
            # Sharded tier: on failover, move live broadcast channels to
            # the recovered owners and push fence events to subscribers.
            self.service.add_fence_listener(self._on_shard_fence)

        #: faultline hook for the ``session.write`` stall site
        #: (testing/faults.py); None in production.
        self.faults = faults
        #: extension point (fluidproc): method name -> fn(session, params),
        #: consulted BEFORE the built-in table so a shard host can add its
        #: control-plane RPC (freeze/export/import/adopt/stats) — or
        #: override a built-in — without forking the dispatch loop.
        self.extra_methods: Dict[str, callable] = {}
        #: instance copy of OFFLOADED_METHODS so subclasses can offload
        #: their own slow routes.
        self.offloaded_methods = set(OFFLOADED_METHODS)
        #: drain mode (SIGTERM): mutating/new work is refused with a
        #: typed retryable ``shuttingDown`` nack while in-flight work
        #: finishes and the durable log is sealed.  Methods listed in
        #: ``drain_exempt`` still answer (supervision probes).
        self.draining = False
        self.drain_exempt = {"ping", "stats", "shard_info"}
        #: in-flight EXECUTOR dispatches (offloaded methods only; inline
        #: dispatches run on the event loop, which the drain sequence
        #: shares, so they can never be mid-flight when it runs).
        self._inflight_lock = threading.Lock()
        self._inflight = 0  # guarded-by: _inflight_lock
        from ..utils.telemetry import LockedCounterSet, MonitoringContext

        #: logger + feature gates (Catchup.* / Server.* keys below); the
        #: lazy CatchupService inherits it so its own cache gates read
        #: the same config.
        self.mc = mc if mc is not None else MonitoringContext()
        cfg = self.mc.config

        #: injected clock for every admission/pacing decision —
        #: time.monotonic in production, a VirtualClock (whose reads and
        #: ``sleep`` advance virtual time) in deterministic harnesses.
        self.clock = clock if clock is not None else time.monotonic
        #: admission control for the catchup RPC: device folds are the
        #: most expensive op the server runs — beyond this many in
        #: flight, new requests are SHED with an "overloaded" nack
        #: whose retry_after is derived from measured fold cost and
        #: queue depth (clients catch up from the durable op log
        #: instead), or — under SUSTAINED overload — served DEGRADED
        #: from the stored summary at an older ref_seq.
        self.catchup_max_inflight = gates.get_int(
            cfg, "Catchup.MaxInflight",
            fallback=int(catchup_max_inflight))
        self.admission_control = AdmissionController(
            self.catchup_max_inflight, clock=self.clock,
            retry_floor=gates.get_float(cfg, "Catchup.ShedRetryFloor"),
            retry_cap=gates.get_float(cfg, "Catchup.ShedRetryCap"),
            degrade_after=gates.get_int(cfg, "Catchup.DegradeAfter"))
        #: Catchup.DegradedServe gate (default ON): under sustained
        #: overload serve the tier-1 stored summary at an older ref_seq
        #: — the client replays the durable tail via normal gap repair —
        #: instead of pure shedding.
        self.degraded_serve = gates.is_on(cfg, "Catchup.DegradedServe")
        #: retry_after on the ``shuttingDown`` drain nack
        #: (Server.DrainRetryAfter gate; was a hardcoded 0.5).
        self.drain_retry_after = gates.get_float(cfg, "Server.DrainRetryAfter")
        #: bound on the warm lane's single-flight join
        #: (Catchup.WarmJoinTimeout): a wedged leader must turn joiners
        #: into FOLD-LANE requests — where admission sheds with pacing —
        #: after seconds, not park them on executor threads for the full
        #: crashed-leader JoinTimeout (60 s).
        self.warm_join_timeout = gates.get_float(cfg,
                                                 "Catchup.WarmJoinTimeout")
        #: modeled fold duration: extra clock seconds an admission lease
        #: stays occupied AFTER the synchronous fold returns.  0 in
        #: production; the deterministic storm harness sets it so
        #: sequentially-driven folds overlap in virtual time.
        self.catchup_hold_seconds = 0.0
        #: the overload surface: ``catchup.requests`` counts fold-lane
        #: entries and balances exactly — requests = admitted + shed +
        #: degraded; ``catchup.warm`` counts priority-lane serves that
        #: never entered the fold lane at all.
        self.admission = LockedCounterSet(
            "catchup.requests", "catchup.admitted", "catchup.shed",
            "catchup.degraded", "catchup.degraded_docs", "catchup.warm",
            "catchup.stream")
        #: streaming fold: when the ``Catchup.Stream`` gate is
        #: on, a sequencer-attached :class:`~.streamfold.StreamFoldService`
        #: folds committed micro-batches continuously (pinned device
        #: state, summary-anchored oplog truncation) and catch-up serves
        #: the STREAMING HEAD lane — summaries at most one cadence behind
        #: the durable head, no fold, no admission.
        self.stream_enabled = gates.is_on(cfg, "Catchup.Stream")
        self.stream_cadence = gates.get_int(cfg, "Catchup.StreamCadence")
        self.stream_retention = gates.get_int(cfg, "Catchup.StreamRetention")
        self.streamfold = None  # guarded-by: _catchup_init (lazy)
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.base_events.Server] = None
        # lazy CatchupService (the "catchup" method); executor threads
        # race the init.
        self._catchup = None  # guarded-by: _catchup_init
        self._catchup_init = threading.Lock()

    def _on_shard_fence(self, shard_id: str, doc_ids, epoch: str) -> None:
        """A shard died: every affected document with live subscribers is
        recovered NOW (endpoint() on the new owner replays the durable
        log) and its broadcast channel re-attached; sessions get a fence
        event carrying the new storage epoch.  Documents WITHOUT live
        channels are skipped — they recover lazily on next touch, so a
        shard full of idle documents fails over in O(live subscriptions),
        not O(documents × log replay)."""
        live = set(self.broadcaster.docs_with_channels())
        for doc_id in doc_ids:
            if doc_id not in live:
                continue
            try:
                endpoint = self.service.endpoint(doc_id)
            except KeyError:
                continue  # summary-only doc; recovered lazily on next use
            self.broadcaster.refence(doc_id, endpoint, epoch)

    # -- tenancy scoping -------------------------------------------------------

    def _grant_tree(self, tree, tenant: Optional[str]) -> None:
        """Grant the tenant read access to EVERY node digest of a summary
        (incremental uploads reference arbitrary subtree handles)."""
        if tenant is None:
            return
        memo: dict = {}
        digests: list = []

        def walk(node):
            from ..protocol.summary import SummaryTree

            digests.append(node.digest(memo) if isinstance(node, SummaryTree)
                           else node.digest())
            if isinstance(node, SummaryTree):
                for child in node.children.values():
                    walk(child)

        # Hash OUTSIDE the lock (digest() is pure over immutable nodes);
        # the lock covers only the dict updates — executor threads
        # (OFFLOADED_METHODS) mutate the grant map concurrently with
        # event-loop dispatches.
        walk(tree)
        grants = self.service.handle_tenants
        with self.service.state_lock:
            for digest in digests:
                grants.setdefault(digest, set()).add(tenant)

    def _check_epoch(self, params: dict) -> None:
        client_epoch = params.get("epoch")
        server_epoch = self.service.storage.epoch
        if client_epoch is not None and client_epoch != server_epoch:
            raise EpochMismatch(client_epoch, server_epoch)

    def _check_readable(self, handle: str, tenant: Optional[str]) -> None:
        if self.tenants is None:
            return
        with self.service.state_lock:
            granted = tenant in self.service.handle_tenants.get(handle, ())
        if not granted:
            raise PermissionError("unknown handle for this tenant")

    def _check_incremental_refs(self, obj, tenant: Optional[str]) -> None:
        """Every {"h": ...} node an incremental upload references must be
        readable by the uploader — resolving unowned handles would
        materialize another tenant's snapshot into this tenant's doc."""
        if self.tenants is None or not isinstance(obj, dict):
            return
        if "h" in obj:
            self._check_readable(obj["h"], tenant)
        for child in (obj.get("t") or {}).values():
            self._check_incremental_refs(child, tenant)

    # -- request dispatch ------------------------------------------------------

    def _dispatch(self, session: _ClientSession, method: str,
                  params: dict):
        service = self.service
        if method == "auth":
            if self.tenants is None:
                return True  # open server: auth is a no-op
            tenant = params.get("tenant")
            if self.tenants.get(tenant) != params.get("secret"):
                raise PermissionError("invalid tenant credentials")
            session.tenant = tenant
            return True
        if method == "ping":
            return "pong"
        if self.draining and method not in self.drain_exempt:
            # Typed retryable refusal: clients hold their encoded ops and
            # retry after the restart (NackError semantics); nothing new
            # may touch the log once the drain sequence armed the seal.
            raise NackError(
                "server is draining for shutdown; retry after restart",
                retry_after=self.drain_retry_after, code="shuttingDown")
        extra = self.extra_methods.get(method)
        if extra is not None:
            return extra(session, params)
        if method == "stats":
            return self._stats()
        # Generation check for EVERY doc/storage method in one place —
        # deltas, submits, and catchup included, not just the summary RPCs
        # (op-stream generation mixing must fail loudly too).
        self._check_epoch(params)
        client_doc = params.get("doc")
        if self.tenants is not None:
            if session.tenant is None:
                raise PermissionError("authenticate first")
            # Namespace every document id under the tenant: tenants can
            # never address each other's documents.
            if "doc" in params:
                params = dict(params, doc=f"{session.tenant}/{params['doc']}")
        if method == "create_document":
            service.create_document(params["doc"])
            if "summary" in params:
                tree = tree_from_obj(params["summary"])
                service.storage.upload(
                    params["doc"], tree, params.get("ref_seq", 0),
                )
                self._grant_tree(tree, session.tenant)
            return True
        if method == "has_document":
            return service.has_document(params["doc"])
        if method == "subscribe_doc":
            # Broadcast frames carry the CLIENT-visible doc id (tenant
            # namespacing is server-internal).
            session.tap(params["doc"], wire_doc=client_doc)
            return service.endpoint(params["doc"]).head_seq
        if method == "connect":
            endpoint = service.endpoint(params["doc"])
            endpoint.connect(params["client"], params.get("session"))
            session.connected_clients[params["client"]] = params["doc"]
            return True
        if method == "disconnect":
            service.endpoint(params["doc"]).disconnect(params["client"])
            session.connected_clients.pop(params["client"], None)
            return True
        if method == "submit":
            msg = service.endpoint(params["doc"]).submit(
                decode_raw_operation(params["op"])
            )
            if self.stream_enabled:
                # Streaming cadence: the commit watcher recorded the new
                # head; fold it once the unfolded span reaches the
                # cadence.  Synchronous and cadence-gated — almost every
                # call is a no-op dict check, and a due round folds one
                # micro-batch, not a cold tail.
                streamfold = self._ensure_streamfold()
                if streamfold is not None:
                    streamfold.poll()
            return encode_sequenced_message(msg) if msg is not None else None
        if method == "stream_poll":
            # Control-plane poke for the streaming fold (tests, the
            # swarm tick, operators): one poll round now; force=True
            # folds every pending doc regardless of cadence.
            streamfold = self._ensure_streamfold()
            if streamfold is None:
                return None
            folded = streamfold.poll(force=bool(params.get("force")))
            return {"folded": {d: [h, s] for d, (h, s) in folded.items()},
                    "stats": streamfold.stats()}
        if method == "update_ref_seq":
            service.endpoint(params["doc"]).update_ref_seq(
                params["client"], params["ref_seq"]
            )
            return True
        if method == "deltas":
            msgs = service.endpoint(params["doc"]).deltas(
                params.get("from_seq", 0), params.get("to_seq")
            )
            return [encode_sequenced_message(m) for m in msgs]
        if method == "head":
            return service.endpoint(params["doc"]).head_seq
        if method == "signal":
            service.endpoint(params["doc"]).submit_signal(
                params["client"], params.get("content"),
                params.get("target"),
            )
            return True
        if method == "catchup":
            return self._catchup_entry(session, params)
        if method == "latest_summary":
            epoch = service.storage.epoch
            tree, ref_seq = service.storage.latest(
                params["doc"], at_or_below=params.get("at_or_below")
            )
            if tree is None:
                # Still carry the epoch: a CREATING client must adopt the
                # generation before its first upload, or its caches go
                # unpinned and the EpochTracker protection is inactive
                # for the writer path.
                return {"handle": None, "ref_seq": 0, "epoch": epoch}
            handle = tree.digest()
            self._grant_tree(tree, session.tenant)
            if handle in (params.get("have") or []):
                # Client-side snapshot cache hit: the body never crosses
                # the wire (odsp-driver caching capability).
                return {"handle": handle, "ref_seq": ref_seq,
                        "epoch": epoch}
            return {"handle": handle, "summary": tree_to_obj(tree),
                    "ref_seq": ref_seq, "epoch": epoch}
        if method == "upload_summary":
            # Incremental upload: {"h": ...} nodes resolve against the
            # server store (unchanged subtrees never cross the wire) —
            # but only handles this tenant may read (a foreign handle
            # would materialize another tenant's snapshot).
            self._check_incremental_refs(params["summary"], session.tenant)
            handle = service.storage.upload_obj(
                params["doc"], params["summary"], params["ref_seq"],
            )
            self._grant_tree(service.storage.read(handle), session.tenant)
            return {"handle": handle, "epoch": service.storage.epoch}
        if method == "read_summary":
            # Handles are content-addressed and global; scope reads to
            # granted tenants or snapshots would leak across tenants.
            self._check_readable(params["handle"], session.tenant)
            node = service.storage.read(params["handle"])
            path = params.get("path")
            if path:
                # Partial snapshot virtualization: fetch one subtree/blob
                # instead of the whole snapshot (odsp capability).
                node = node.get(path)
            from ..protocol.summary import SummaryBlob

            if isinstance(node, SummaryBlob):
                from ..protocol.summary import _encode_blob

                return {"v": 1, **_encode_blob(node)}
            return tree_to_obj(node)
        raise ValueError(f"unknown method {method!r}")

    def _stats(self) -> dict:
        """The ``stats`` RPC: service-level counters every deployment
        shape answers (the fluidproc shard host extends this with
        per-shard identity and log heads)."""
        service = self.service
        docs = service.doc_ids()
        with self._catchup_init:
            streamfold = self.streamfold
        return {
            "docs": len(docs),
            "ops": sum(service.oplog.head(d) for d in docs),
            "epoch": service.storage.epoch,
            "admission": self.admission.snapshot(),
            # live controller state (inflight leases, measured fold-cost
            # EMA, shed streak) next to the monotonic counters
            "admissionControl": self.admission_control.snapshot(),
            # streaming fold health (None while the gate is off): poll/
            # fold/publish counters, truncation totals, summary lag
            # high-water in sequence numbers.
            "stream": (streamfold.stats()
                       if streamfold is not None else None),
        }

    def _track_dispatch(self, session: _ClientSession, method: str,
                        params: dict):
        """Executor-side dispatch wrapper: counts in-flight offloaded
        work so the drain sequence can wait it out before sealing."""
        with self._inflight_lock:
            self._inflight += 1
        try:
            return self._dispatch(session, method, params)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    async def drain_and_seal(self, seal=None, timeout: float = 30.0) -> None:
        """SIGTERM drain: refuse new work (typed ``shuttingDown`` nacks),
        stop accepting connections, wait out in-flight offloaded
        dispatches, then run ``seal`` (the shard host flushes + closes
        its durable log).  Inline dispatches — submits and their group
        commits — run to completion on this same event loop before the
        signal callback that starts this coroutine can execute, so a
        SIGTERM landing mid-group-commit drains the in-flight batch by
        construction; the seal's flush then makes its bytes durable.

        Open client connections are not waited for (since Python 3.12
        ``Server.wait_closed()`` waits until every client hangs up, which
        a connected client never has to do): they stay answered with
        ``shuttingDown`` until the process exits."""
        self.draining = True
        if self._server is not None:
            self._server.close()  # stop accepting; clients stay open
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            with self._inflight_lock:
                idle = self._inflight == 0
            if idle:
                break
            await asyncio.sleep(0.02)
        if seal is not None:
            seal()

    def _ensure_catchup(self):
        from .catchup import CatchupService

        with self._catchup_init:
            if self._catchup is None:
                self._catchup = CatchupService(self.service, mc=self.mc,
                                               device=self.device)
            # Hand the instance out of the critical section as a
            # local: every later use reads the local, not the guarded
            # attribute (fluidrace FL-RACE-GUARD — the instance is
            # immutable-once-set, the attribute slot is not).
            return self._catchup

    def _ensure_streamfold(self):
        """Lazy streaming-fold service (gate: ``Catchup.Stream``).
        Returns None when streaming is off."""
        if not self.stream_enabled:
            return None
        catchup = self._ensure_catchup()
        with self._catchup_init:
            if self.streamfold is None:
                from .streamfold import StreamFoldService

                self.streamfold = StreamFoldService(
                    self.service, catchup,
                    cadence_ops=self.stream_cadence,
                    retention_floor=self.stream_retention,
                    faults=self.faults,
                ).attach()
            return self.streamfold

    def enable_streaming(self, cadence_ops: Optional[int] = None,
                         retention_floor: Optional[int] = None):
        """Turn the streaming fold on programmatically (tests and the
        swarm harness; production uses the ``Catchup.Stream`` gate).
        Returns the attached :class:`~.streamfold.StreamFoldService`."""
        if cadence_ops is not None:
            self.stream_cadence = int(cadence_ops)
        if retention_floor is not None:
            self.stream_retention = int(retention_floor)
        self.stream_enabled = True
        return self._ensure_streamfold()

    def _catchup_docs(self, session: _ClientSession, params: dict):
        """(resolved doc ids, tenant prefix) for one catchup request."""
        doc_ids = params.get("docs")
        prefix = f"{session.tenant}/" if self.tenants is not None else ""
        if doc_ids is not None:
            doc_ids = [f"{prefix}{d}" for d in doc_ids]
        else:
            doc_ids = [d for d in self.service.doc_ids()
                       if d.startswith(prefix)]
        return doc_ids, prefix

    def _catchup_entry(self, session: _ClientSession, params: dict):
        """The ``catchup`` method: admission-orchestrated.

        Lanes, in order:

        1. **warm** — requests fully servable from tiers 0/1 (including
           a single-flight ``join`` on another caller's in-flight fold)
           never touch the device and BYPASS the fold admission
           entirely: a herd of warm readers must not queue behind cold
           folds, and N concurrent catch-ups of one document cost ONE
           admission slot (the leader's).
        2. **fold** — an :class:`AdmissionController` lease per real
           fold; the shed nack's retry_after is load-derived.
        3. **degraded** — under sustained overload, the stored summary
           at an older ref_seq instead of pure shed (the client replays
           the durable tail via normal gap repair); falls back to shed
           when nothing is servable.

        Counter balance (asserted by the storm harness):
        ``catchup.requests == admitted + shed + degraded``, with
        ``catchup.warm`` counting lane-1 serves outside that balance.
        """
        # Wire-clock admission: a deterministic out-of-proc
        # caller stamps its virtual tick onto the request; in virtual
        # mode the controller advances ONLY on these, so every verdict
        # below is a pure function of the request sequence.
        vnow = params.get("vnow")
        if vnow is not None and self.admission_control.virtual:
            self.admission_control.observe(float(vnow))
        catchup = self._ensure_catchup()
        # Epoch-keyed invalidation (EpochTracker parity for the SERVER's
        # own fold caches): entries are keyed by the storage generation
        # so a recreated store can never be served a stale fold —
        # dropping dead-generation entries here just frees the budget
        # (and the HBM tier 2.5 held) immediately.  ONE sweep covers
        # every tier of every kernel family.
        catchup.invalidate_epoch(self.service.storage.epoch)
        doc_ids, prefix = self._catchup_docs(session, params)
        # Streaming head: with the streaming fold attached,
        # a summary within one fold cadence of the durable head is
        # final enough — serve it at its ref_seq (the client replays
        # the bounded tail) instead of folding the last few ops.
        streamfold = self._ensure_streamfold()
        stream_docs: list = []
        stream_lag = (streamfold.cadence_ops
                      if streamfold is not None else None)
        served, complete = catchup.catch_up_cached(
            doc_ids, join_timeout=self.warm_join_timeout,
            stream_lag=stream_lag, stream_docs=stream_docs)
        if complete:
            if stream_docs:
                self.admission.bump("catchup.stream")
                lane = "stream"
            else:
                self.admission.bump("catchup.warm")
                lane = "warm"
            return self._catchup_response(
                session, catchup, prefix, doc_ids, served,
                self._zero_fold_stats(), lane=lane,
                stream=stream_docs)
        self.admission.bump("catchup.requests")
        verdict, grant = self.admission_control.admit()
        if verdict != "admit":
            if verdict == "degrade" and self.degraded_serve:
                degraded = self._degraded_serve(session, catchup, prefix,
                                                doc_ids, served)
                if degraded is not None:
                    self.admission.bump("catchup.degraded")
                    return degraded
            self.admission.bump("catchup.shed")
            raise NackError(
                "catch-up tier overloaded; backfill from deltas "
                "or retry", retry_after=float(grant), code="overloaded",
                admission=self.admission_control.snapshot())
        self.admission.bump("catchup.admitted")
        try:
            # The warm pre-pass's partial serves ride along so the fold
            # never re-scans (or re-counts hits for) those documents.
            return self._catchup_rpc(session, params, catchup=catchup,
                                     doc_ids=doc_ids, prefix=prefix,
                                     prefetched=served,
                                     stream=stream_docs)
        finally:
            self.admission_control.release(
                grant, hold=self.catchup_hold_seconds)

    @staticmethod
    def _zero_fold_stats() -> dict:
        return dict(deviceDocs=0, cpuDocs=0, hostChannels=0,
                    fallbackChannels=0)

    def _hold_fold(self, seconds: float) -> None:
        """``catchup.slow`` actuator: an injected fold delay, advanced
        on the injected clock (virtual under a VirtualClock — the
        admission controller then measures the slow fold's cost
        deterministically; wall sleep in production)."""
        sleep = getattr(self.clock, "sleep", None)
        if sleep is not None:
            sleep(float(seconds))
        else:
            time.sleep(float(seconds))

    def _degraded_serve(self, session: _ClientSession, catchup,
                        prefix: str, doc_ids, warm_served=None):
        """Degraded-mode serving: under SUSTAINED overload,
        answer with each document's newest STORED summary at its
        (older) ref_seq instead of pure-shedding the request.  The
        client loads that summary and replays the durable op tail
        through normal DeltaManager gap repair — freshness is weakened
        (the served ref_seq may trail the head), convergence is not
        (the tail is durable and contiguous; see SEMANTICS.md "Overload
        & degradation").  ``warm_served`` seeds the answer with the
        warm pre-pass's partial results: a document the cache already
        served FRESH must not be re-answered stale (nor re-read).
        Returns None when nothing is servable (no stored summaries at
        all): the caller sheds instead."""
        storage = self.service.storage
        results: Dict[str, tuple] = dict(warm_served or {})
        degraded = []
        for doc_id in doc_ids:
            if doc_id in results:
                continue  # warm pre-pass already served it fresh
            summary, ref_seq, handle = storage.latest_with_handle(doc_id)
            if summary is None:
                continue
            results[doc_id] = (handle, ref_seq)
            if self.service.oplog.head(doc_id) > ref_seq:
                degraded.append(doc_id)
        if not results:
            return None
        self.admission.bump("catchup.degraded_docs", len(degraded))
        self.mc.logger.send({
            "eventName": "catchupDegraded", "docs": len(results),
            "stale": len(degraded)})
        return self._catchup_response(
            session, catchup, prefix, doc_ids, results,
            self._zero_fold_stats(), lane="degraded",
            degraded=degraded)

    def _catchup_rpc(self, session: _ClientSession, params: dict,
                     catchup=None, doc_ids=None, prefix=None,
                     prefetched=None, stream=()):
        """The catchup FOLD body, run under an admission lease.

        The north-star maintenance op in the deployed server shape:
        fold the named documents' op tails (or every document of the
        caller's namespace) into fresh summaries centrally, routing
        kernel-backed channels through the device (service.catchup).
        (_handle runs this method on an executor thread — the fold
        can take seconds and must not stall the event loop.)  The
        ``catchup.fail`` / ``catchup.slow`` faultline seams fire here:
        an injected failure takes the real recovery paths (the
        single-flight finally-abandon, the caller's retry policy, the
        admission release), an injected delay registers in the measured
        fold cost the shed pacing derives from."""
        if catchup is None:  # direct callers (tests, legacy paths)
            catchup = self._ensure_catchup()
            catchup.invalidate_epoch(self.service.storage.epoch)
        if doc_ids is None:
            doc_ids, prefix = self._catchup_docs(session, params)
        if self.faults is not None:
            point = self.faults.fire("catchup.fail")
            if point is not None:
                from ..testing.faults import FaultError

                raise FaultError("catchup.fail", point.kind)
            point = self.faults.fire("catchup.slow")
            if point is not None:
                self._hold_fold(point.arg)
        stats: dict = {}
        results = catchup.catch_up(doc_ids, stats=stats,
                                   prefetched=prefetched)
        return self._catchup_response(session, catchup, prefix, doc_ids,
                                      results, stats, lane="fold",
                                      stream=stream)

    def _catchup_response(self, session: _ClientSession, catchup,
                          prefix: str, doc_ids, results: dict,
                          stats: dict, lane: str, degraded=(),
                          stream=()):
        """ONE response shape for every catchup lane."""
        service = self.service
        out = {}
        for doc_id, (handle, seq) in results.items():
            self._grant_tree(service.storage.read(handle),
                             session.tenant)
            out[doc_id[len(prefix):]] = [handle, seq]
        return {
            "docs": out,
            # Explicitly-requested documents the fold could not serve
            # (unknown id, or nothing to fold from): callers must be
            # able to tell success from a typo.
            "skipped": sorted(
                d[len(prefix):] for d in doc_ids if d not in results
            ),
            # Which lane answered ("warm" | "fold" | "degraded") and —
            # for degraded serves — which documents were answered at a
            # ref_seq older than the durable head (the client's cue
            # that a tail replay is coming via gap repair).
            "lane": lane,
            "degraded": sorted(d[len(prefix):] for d in degraded),
            # Documents answered from the STREAMING HEAD: a summary at
            # most one fold cadence behind the durable head, served at
            # its ref_seq with the client replaying the bounded tail.
            "stream": sorted(d[len(prefix):] for d in stream),
            "deviceDocs": stats.get("deviceDocs", 0),
            "cpuDocs": stats.get("cpuDocs", 0),
            # Per-channel split inside device-routed documents:
            # non-kernel channels folded host-side vs kernel channels
            # that FELL BACK to their oracle (the
            # two were indistinguishable before).
            "hostChannels": stats.get("hostChannels", 0),
            "fallbackChannels": stats.get("fallbackChannels", 0),
            # Cumulative fold-cache health (hits/misses/evictions/
            # waits + bytes) — operators watching a herd of loading
            # clients see the single-flight amortization here.
            "cache": (catchup.cache.stats()
                      if catchup.cache is not None else None),
            # Tier-0 delta-download health: documents whose rows
            # never crossed the d2h link + the bytes that saved.
            "deltaCache": (catchup.delta_cache.stats()
                           if catchup.delta_cache is not None
                           else None),
            # Tier-2.5 resident-upload health: chunks dispatched with
            # zero h2d pack bytes (served), donated suffix splices
            # (spliced), and the upload bytes the tier kept off the link.
            "deviceCache": (catchup.device_cache.stats()
                            if catchup.device_cache is not None
                            else None),
        }

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        session = _ClientSession(self, writer)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                if frame.get("v", 1) > WIRE_VERSION:
                    response = {"v": WIRE_VERSION, "re": frame.get("id"),
                                "ok": False,
                                "error": f"unsupported wire version "
                                         f"{frame.get('v')}"}
                else:
                    try:
                        method = frame.get("method")
                        params = frame.get("params", {})
                        if method in self.offloaded_methods:
                            # Device folds take seconds and storage
                            # mutations hold the commit-chain lock across
                            # disk writes; running either inline would
                            # stall every connection (all tenants) until
                            # the work — or a wedged accelerator —
                            # returns.
                            result = await asyncio.get_running_loop() \
                                .run_in_executor(
                                    None, self._track_dispatch, session,
                                    method, params,
                                )
                        else:
                            result = self._dispatch(session, method, params)
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": True, "result": result}
                    except EpochMismatch as em:
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": False, "error": str(em),
                                    "code": "epochMismatch",
                                    "epoch": em.server_epoch}
                    except DocRelocatedError as dr:
                        # Out-of-process redirect: this shard no longer
                        # owns the document (migrated away / stale
                        # route).  Distinct code so callers re-resolve
                        # the owner instead of treating it as a fence of
                        # a live assignment.
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": False, "error": str(dr),
                                    "code": "wrongShard",
                                    "doc": dr.doc_id}
                    except ShardFencedError as sf:
                        # Mid-failover race: the request reached an
                        # orderer in the instant between its fence and
                        # the router flip.  Typed so drivers retry
                        # through the re-resolved owner instead of
                        # treating it as a generic server error.
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": False, "error": str(sf),
                                    "code": "shardFenced",
                                    "doc": sf.doc_id}
                    except NackError as nack:
                        nack_body = {"retryAfter": nack.retry_after,
                                     "reason": nack.reason,
                                     "code": nack.code}
                        if nack.admission is not None:
                            nack_body["admission"] = nack.admission
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": False, "error": nack.reason,
                                    "nack": nack_body}
                    except Exception as exc:  # surfaced to the client
                        # Typed catch-all (protocol/errors.py "internal",
                        # fatal): a handler fault is a deterministic
                        # rejection — framed with a registered code so it
                        # can never masquerade as transport and be
                        # blindly resent.
                        response = {"v": WIRE_VERSION,
                                    "re": frame.get("id"),
                                    "ok": False, "error": str(exc),
                                    "code": "internal"}
                session._write(response)
                await writer.drain()
        finally:
            session.close()
            writer.close()

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        self.loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    def start_in_thread(self) -> threading.Thread:
        """Run the server on a daemon thread (tests, embedded use);
        returns once the port is bound."""
        started = threading.Event()

        async def _run():
            await self.start()
            started.set()
            async with self._server:
                try:
                    await self._server.serve_forever()
                except asyncio.CancelledError:
                    pass  # server.close() from another thread: normal
                    # shutdown of an embedded server, not an error

        thread = threading.Thread(
            target=lambda: asyncio.run(_run()), daemon=True
        )
        thread.start()
        started.wait(timeout=10)
        return thread


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Standalone ordering server (Tinylicious capability)"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument(
        "--dir", default=None,
        help="persist the op log AND summary store under this directory "
             "(documents survive server restarts)",
    )
    parser.add_argument(
        "--shards", type=int, default=0,
        help="run a document-partitioned ordering tier with this many "
             "orderer shards (0 = single orderer); shards share the "
             "durable log/store, so --dir persistence works unchanged",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="the device of the catch-up fold (default 'cuda'; 'cpu' "
             "runs the plain folds on the host).  Checked at start: "
             "without a CUDA device the default refuses to start",
    )
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))

    oplog = storage = None
    if args.dir:
        import os

        from ..drivers.file_driver import FileSummaryStorage
        from .oplog import OpLog

        os.makedirs(args.dir, exist_ok=True)
        oplog = OpLog(path=os.path.join(args.dir, "oplog.ndjson"),
                      autoflush=True)
        storage = FileSummaryStorage(os.path.join(args.dir, "summaries"))
    if args.shards > 0:
        from .sharding import ShardedOrderingService

        service = ShardedOrderingService(
            n_shards=args.shards, oplog=oplog, storage=storage
        )
    else:
        service = LocalOrderingService(oplog=oplog, storage=storage)
    server = OrderingServer(service, host=args.host, port=args.port,
                            device=device)

    async def _run():
        await server.start()
        print(f"ordering server listening on {server.host}:{server.port}",
              flush=True)
        async with server._server:
            await server._server.serve_forever()

    asyncio.run(_run())


if __name__ == "__main__":
    main()
