"""Network driver: binds the loader to an ordering server over TCP.

Capability parity with the reference's routerlicious-driver (SURVEY.md
§2.4): the client side
of the frame protocol in ``service/server.py``.  One socket per factory is
shared by every document; a reader thread routes responses to waiting
callers and enqueues broadcast events, and a dispatcher thread delivers
them to subscribers — so a subscriber callback may issue further blocking
requests (the DeltaManager's gap repair does) without deadlocking the
reader.

Delivery threading: op/signal callbacks fire on the dispatcher thread.
The intended consumer is the Loader's DeltaManager, whose delivery
watermark dedups the overlap between a deltas snapshot and the live tail,
and whose subscribers only append to the runtime's inbound queue (drained
by the application thread).
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
import weakref
from typing import Callable, Dict, List, Optional

from ..protocol import errors as wire_errors
from ..protocol.messages import (DocRelocatedError, NackError, RawOperation,
                                 SequencedMessage, ShardFencedError)
from ..protocol.summary import SummaryTree, tree_from_obj, tree_to_obj
from ..protocol.wire import (LEN as _LEN, WIRE_VERSION,
                             decode_sequenced_message,
                             encode_raw_operation, frame_bytes)


class RpcError(RuntimeError):
    """Server-side error surfaced to the caller.  The PLAIN class means a
    deterministic server rejection (auth failure, unknown method, a
    server-side exception): retrying the same bytes cannot help, so the
    retry layer never touches it — only the transport-shaped subclasses
    below are retried."""


class RpcTransportError(RpcError, ConnectionError):
    """Transport-level failure (send faulted, frame lost): the request
    may never have reached the server — resending the same bytes is the
    correct recovery, and the sequencer's client_seq dedup makes it safe
    even for submits.  A ConnectionError, so the runtime's wire-drain
    keeps encoded ops queued."""


class ConnectionLostError(RpcTransportError):
    """The transport under this client DIED (socket closed, send failed
    at the fd, reader drained the pending map).  Like any transport
    error the queued ops survive, but a blind in-place retry is
    pointless: the host must reconnect first."""


class RpcTimeoutError(RpcError, TimeoutError):
    """No response within the client timeout: the server may be slow or
    the response frame lost.  Retried — the resend either dedups
    (response was lost after sequencing) or lands fresh."""


class EpochMismatchError(RpcError):
    """The server's storage generation changed under us (store recreated):
    every cached snapshot/delta this client holds is from a dead
    generation and must not be mixed with the new one (odsp EpochTracker
    capability).  Callers must reload the document from scratch."""

    def __init__(self, message: str, server_epoch: Optional[str]) -> None:
        super().__init__(message)
        self.server_epoch = server_epoch


class UnknownWireCodeError(RpcError):
    """The peer sent an error code outside the protocol/errors.py
    registry: the two sides disagree about the failure vocabulary
    (version skew, a corrupt frame, a buggy server).  A plain RpcError
    subclass on purpose — pacing or resending against an UNKNOWN
    contract is how retry budgets burn, so this is never retried; the
    host must surface it."""

    def __init__(self, channel: str, code: object) -> None:
        super().__init__(
            f"unregistered wire error code {code!r} on {channel} channel")
        self.channel = channel
        self.code = code


class _RpcClient:
    """Shared framed-JSON socket with response routing + event dispatch.

    ``retry`` (a :class:`~..service.retry.RetryPolicy`) bounds-retries
    the initial connect and every request on transient transport
    failures — safe for submits too, because the sequencer dedups by
    (client_id, client_seq), so a response lost on the wire resends the
    same bytes and gets the duplicate dropped server-side.  Nacks, epoch
    mismatches, and shard fences are NEVER retried here: those belong to
    the DeltaManager/loader layer.  ``faults`` arms the ``rpc.send`` /
    ``rpc.recv`` injection sites (testing/faults.py)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 mc=None, faults=None, retry=None, rng=None) -> None:
        import random as _random

        from ..utils.telemetry import LockedCounterSet, MonitoringContext

        self._faults = faults
        self._retry = retry
        self._retry_rng = rng if rng is not None else _random.Random(0)
        #: retry.* counters (attempts/retries/exhausted) — bench surface
        self.retry_counters = LockedCounterSet()
        if retry is not None:
            self._sock = retry.run(
                lambda: socket.create_connection((host, port), timeout=10),
                operation=f"connect {host}:{port}",
                rng=self._retry_rng,
                retry_on=(OSError,),
                counters=self.retry_counters,
            )
        else:
            self._sock = socket.create_connection((host, port), timeout=10)
        self._sock.settimeout(None)
        self._timeout = timeout
        self._mc = (mc or MonitoringContext()).child("rpc")
        self._write_lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pending: Dict[int, queue.Queue] = {}  # guarded-by: _pending_lock
        self._pending_lock = threading.Lock()
        self._events: queue.Queue = queue.Queue()
        # Subscription state: mutated by caller threads (subscribe/
        # unsubscribe), read by the dispatcher thread per event — its own
        # lock so delivery never contends with the request/response path.
        self._state_lock = threading.Lock()
        self._handlers: Dict[str, List[Callable[[dict], None]]] = {}  # guarded-by: _state_lock
        self._closed = False
        self._sock_closed = False  # guarded-by: _state_lock
        # injected-'delay' one-frame reorder buffer (reader thread +
        # safety timer race for the flush)
        self._held_lock = threading.Lock()
        self._held: Optional[dict] = None  # guarded-by: _held_lock
        #: last exception a telemetry sink raised from the dispatcher
        #: (dispatcher-thread-confined write; read via last_sink_error
        #: for post-mortem — a dead sink must not also hide ITS failure)
        self._last_sink_error: Optional[BaseException] = None
        #: storage generation this CONNECTION is pinned to (odsp
        #: EpochTracker): adopted from the first storage response and then
        #: attached to EVERY doc/storage request — deltas, submits, and
        #: catchup included, not just the summary RPCs, so op-stream
        #: generation mixing fails loudly too.
        self.epoch: Optional[str] = None
        #: invalidation callbacks (one per _RemoteStorage on this socket):
        #: an epochMismatch observed on ANY RPC — deltas, submits,
        #: discovery, storage — drops EVERY instance's caches and the pin,
        #: centrally, before the error propagates.  Held as WEAK method refs
        #: so a long-lived shared connection does not pin every per-doc
        #: storage instance (and its snapshot cache) forever.
        self._epoch_listeners: List["weakref.WeakMethod"] = []  # guarded-by: _state_lock
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True
        )
        self._dispatcher.start()

    # -- wire ------------------------------------------------------------------

    def _read_loop(self) -> None:
        rfile = None
        try:
            # Buffered file interface: exact-size reads without quadratic
            # bytes-concatenation on large frames (big summaries).
            rfile = self._sock.makefile("rb")

            def read_exact(n: int) -> bytes:
                data = rfile.read(n)
                if data is None or len(data) != n:
                    raise ConnectionError("server closed")
                return data

            while True:
                (length,) = _LEN.unpack(read_exact(_LEN.size))
                frame = json.loads(read_exact(length))
                # Event frames carry their doc id — a doc-scoped plan
                # point counts ONLY that document's broadcast frames,
                # which is what makes "drop the 3rd op event of doc X"
                # replayable (response frames count globally).
                fault = (self._faults.fire("rpc.recv",
                                           doc=frame.get("doc"))
                         if self._faults is not None else None)
                if fault is not None:
                    if fault.kind == "disconnect":
                        raise ConnectionError("injected rpc disconnect")
                    if fault.kind == "drop":
                        continue  # lost on the wire: waiters time out /
                        # subscribers gap-repair from durable storage
                    if fault.kind == "duplicate":
                        self._route(frame)  # delivered twice: watermarks
                        # and response-slot idempotence absorb the copy
                    if fault.kind == "delay":
                        # Reorder, never loss: delivered after the next
                        # frame — or by the timer if the connection goes
                        # idle (a delay on the FINAL frame must not turn
                        # into a permanent drop).  Check-and-hold in one
                        # critical section; an occupied buffer delivers
                        # this frame normally.
                        with self._held_lock:
                            holding = self._held is None
                            if holding:
                                self._held = frame
                        if holding:
                            timer = threading.Timer(
                                self.HELD_FLUSH_SECONDS, self._flush_held)
                            timer.daemon = True
                            timer.start()
                            continue
                self._route(frame)
                self._flush_held()
        except (ConnectionError, OSError, ValueError) as exc:
            self._closed = True
            # Fail every waiter so no caller hangs on a dead socket.
            with self._pending_lock:
                pending, self._pending = self._pending, {}
            for slot in pending.values():
                slot.put({"ok": False, "code": "connectionLost",
                          "error": f"connection lost: {exc}"})
            self._events.put(None)
        finally:
            # The buffered reader pins the socket's io refcount; a reader
            # that exits without closing it leaks the buffer for the
            # process lifetime (fluidleak FL-LEAK-ESCAPE).  The socket
            # itself stays owned by close().
            if rfile is not None:
                try:
                    rfile.close()
                except OSError:
                    pass

    #: how long an injected 'delay' holds a frame when NO later frame
    #: arrives to release it (idle connection): reorder semantics with a
    #: bounded worst case, never a permanent drop.
    HELD_FLUSH_SECONDS = 0.25

    def _flush_held(self) -> None:
        """Release the one-frame reorder buffer: called by the reader
        after routing the NEXT frame, and by the safety timer when the
        connection went idle — the None-swap under the lock makes
        exactly one of them deliver it."""
        with self._held_lock:
            frame, self._held = self._held, None
        if frame is not None:
            self._route(frame)

    def _route(self, frame: dict) -> None:
        """Deliver one inbound frame: responses to their waiting slot,
        events to the dispatcher queue.  Duplicate-delivery safe: a
        response whose slot is gone (already answered) is dropped, and
        event consumers dedup by delivery watermark."""
        if "re" in frame:
            with self._pending_lock:
                slot = self._pending.pop(frame["re"], None)
            if slot is not None:
                try:
                    slot.put_nowait(frame)
                except queue.Full:
                    pass  # duplicated response already delivered
        elif "event" in frame:
            self._events.put(frame)

    def _dispatch_loop(self) -> None:
        while True:
            frame = self._events.get()
            if frame is None:
                return
            if frame["event"] == "fence":
                # Shard failover (server push): the storage generation
                # changed.  Unpin + drop every cache on this connection
                # BEFORE delivering to per-doc subscribers — proactive
                # reconnect-through-the-fence, so the next RPC adopts the
                # new epoch instead of tripping over epochMismatch.
                self._invalidate_epoch_state()
            key = f"{frame['event']}:{frame.get('doc', '')}"
            # Snapshot under the lock, deliver outside it: a handler that
            # issues further RPCs (or re-subscribes) must not deadlock or
            # corrupt the dispatch loop (fluidrace: the live list is
            # mutated by on()/off() on caller threads).
            with self._state_lock:
                handlers = list(self._handlers.get(key, ()))
            for fn in handlers:
                try:
                    fn(frame)
                except Exception as exc:
                    # A broken subscriber must not kill delivery — but its
                    # failure must surface, not vanish (fluidleak
                    # FL-LEAK-SWALLOW): hosts that inject a logger see
                    # every dropped delivery with its event key.
                    try:
                        self._mc.logger.send({
                            "eventName": "subscriberError", "event": key,
                            "error": str(exc),
                            "errorType": type(exc).__name__,
                        })
                    except Exception as sink_exc:
                        # A broken SINK must not kill the dispatcher
                        # either (a dead dispatcher silently halts every
                        # delivery on the connection); stash the sink's
                        # failure for post-mortem instead of dying.
                        self._last_sink_error = sink_exc

    @property
    def last_sink_error(self) -> Optional[BaseException]:
        """The most recent exception a telemetry sink raised from the
        dispatcher thread, or None.  Hosts poll this post-mortem: the
        dispatcher armors itself against a broken sink, so this is the
        only place the sink's own failure surfaces."""
        return self._last_sink_error

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        if self._retry is None or self._closed:
            # A dead socket can never heal by resending — fail fast
            # rather than burn the budget against a closed fd.
            return self._request_once(method, params, timeout=timeout)
        return self._retry.run(
            lambda: self._request_once(method, params, timeout=timeout),
            operation=f"rpc {method}",
            rng=self._retry_rng,
            # Only TRANSPORT-shaped failures resend the same bytes
            # (duplicates dedup server-side).  A plain RpcError is a
            # deterministic server rejection — retrying would burn the
            # budget and then mask the real error as a ConnectionError.
            retry_on=(RpcTransportError, RpcTimeoutError, OSError,
                      TimeoutError),
            # These are not transport noise: nack holds belong to the
            # DeltaManager, mismatches/fences to the loader's re-resolve
            # — and a DEAD socket (ConnectionLostError) can never heal by
            # resending in place: fail fast so the host reconnects,
            # instead of sleeping out the budget against a closed fd.
            no_retry=(EpochMismatchError, NackError, ShardFencedError,
                      ConnectionLostError),
            counters=self.retry_counters,
        )

    def _request_once(self, method: str, params: dict,
                      timeout: Optional[float] = None):
        """``timeout`` overrides the client default for THIS request —
        supervision probes (the front door's heartbeat ping) must detect
        a hung shard process in seconds, not the 30 s RPC default."""
        if self._closed:
            raise ConnectionLostError("connection lost")
        fault = (self._faults.fire("rpc.send", doc=params.get("doc"))
                 if self._faults is not None else None)
        if fault is not None:
            if fault.kind == "disconnect":
                self.close()
                raise ConnectionLostError("injected disconnect before send")
            if fault.kind == "fail":
                raise RpcTransportError("injected send failure")
        rid = next(self._ids)
        slot: queue.Queue = queue.Queue(maxsize=1)
        with self._pending_lock:
            self._pending[rid] = slot
        if self._closed:
            # The reader died between the first check and slot
            # registration; its drain may have run already — fail fast
            # instead of waiting out the timeout on a dead socket.
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise ConnectionLostError("connection lost")
        if self.epoch is not None and method not in ("auth", "ping"):
            params = {**params, "epoch": self.epoch}
        frame = frame_bytes(
            {"v": WIRE_VERSION, "id": rid, "method": method,
             "params": params}
        )
        try:
            if fault is not None and fault.kind == "drop":
                pass  # lost on the wire: the slot wait below times out
            else:
                with self._write_lock:
                    self._sock.sendall(frame)
        except OSError as exc:
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise ConnectionLostError(f"send failed: {exc}")
        try:
            frame = slot.get(
                timeout=timeout if timeout is not None else self._timeout)
        except queue.Empty:
            with self._pending_lock:
                self._pending.pop(rid, None)
            raise RpcTimeoutError(f"timeout waiting for {method}")
        if not frame.get("ok"):
            nack = frame.get("nack")
            if nack is not None:
                nack_code = nack.get("code")
                if nack_code not in wire_errors.codes("nack"):
                    # A nack whose pacing class we don't know: silently
                    # defaulting to "throttled" would pace the retry
                    # budget on garbage.  Loud, typed, never retried.
                    self.retry_counters.bump("rpc.unknown_code")
                    self._mc.logger.send({
                        "eventName": "unknownWireCode",
                        "channel": "nack", "code": repr(nack_code),
                    })
                    raise UnknownWireCodeError("nack", nack_code)
                raise NackError(nack.get("reason", "nacked"),
                                retry_after=nack.get("retryAfter", 0.0),
                                code=nack_code,
                                admission=nack.get("admission"))
            if frame.get("code") == "epochMismatch":
                # Dead generation: unpin and drop EVERY cache riding this
                # connection before anyone can retry unpinned against the
                # new generation with stale state still live.
                self._invalidate_epoch_state()
                raise EpochMismatchError(
                    frame.get("error", "storage epoch mismatch"),
                    frame.get("epoch"),
                )
            if frame.get("code") == "shardFenced":
                # Mid-failover race on the server: the router has (or is
                # about to have) a recovered owner — typed so callers can
                # re-resolve/retry instead of failing like a dead server.
                raise ShardFencedError(
                    frame.get("doc", ""),
                    frame.get("error", "shard fenced"),
                )
            if frame.get("code") == "wrongShard":
                # Out-of-process redirect: this server no longer owns the
                # document (live migration, or a stale direct-to-shard
                # route after failover).  Recovery is the fence path —
                # re-resolve the owner through the front door and retry
                # there; a blind in-place resend can never succeed.
                raise DocRelocatedError(
                    frame.get("doc", ""),
                    frame.get("error", "document served by another shard"),
                )
            if frame.get("code") == "connectionLost":
                # The reader died and drained this waiter: transport
                # death, not a server rejection — queued ops survive.
                raise ConnectionLostError(
                    frame.get("error", "connection lost"))
            if frame.get("code") == "internal":
                # Server-side catch-all: a handler fault framed typed.
                # Deterministic rejection — plain RpcError, never
                # retried, never mistaken for transport.
                raise RpcError(
                    frame.get("error", "internal server error"))
            frame_code = frame.get("code")
            if frame_code is not None \
                    and not wire_errors.is_registered(frame_code):
                # The server speaks a code this driver's registry does
                # not: version skew or corruption.  Same loud path as an
                # unknown nack code — never folded into a generic error.
                self.retry_counters.bump("rpc.unknown_code")
                self._mc.logger.send({
                    "eventName": "unknownWireCode",
                    "channel": "frame", "code": repr(frame_code),
                })
                raise UnknownWireCodeError("frame", frame_code)
            raise RpcError(frame.get("error", "unknown server error"))
        return frame.get("result")

    def _invalidate_epoch_state(self) -> None:
        """Unpin the connection's storage generation and invalidate every
        per-doc cache riding it — shared by the epochMismatch error path
        and the proactive server-push fence event.  ONE critical section
        does both the snapshot and the dead-weakref prune (resolving the
        refs pins each live listener for the delivery below), then the
        callbacks run OUTSIDE the lock — a listener that re-registers
        must not self-deadlock on the plain Lock, and anything registered
        during delivery simply appends to the live list untouched."""
        self.epoch = None
        callbacks = []
        with self._state_lock:
            live = []
            for ref in list(self._epoch_listeners):
                invalidate = ref()
                if invalidate is not None:
                    live.append(ref)
                    callbacks.append(invalidate)
            self._epoch_listeners[:] = live
        for invalidate in callbacks:
            invalidate()

    def on(self, event: str, doc_id: str, fn: Callable[[dict], None]) -> None:
        with self._state_lock:
            self._handlers.setdefault(f"{event}:{doc_id}", []).append(fn)

    def off(self, event: str, doc_id: str, fn: Callable[[dict], None]) -> None:
        with self._state_lock:
            handlers = self._handlers.get(f"{event}:{doc_id}", [])
            if fn in handlers:
                handlers.remove(fn)

    def add_epoch_listener(self, ref: "weakref.WeakMethod") -> None:
        """Register an invalidation callback (weak method ref) — under the
        state lock so registration never races the mismatch sweep's
        prune-and-replace."""
        with self._state_lock:
            self._epoch_listeners.append(ref)

    def close(self) -> None:
        self._closed = True
        with self._state_lock:
            # Idempotent (fluidleak FL-LEAK-DOUBLE-CLOSE discipline):
            # close() is reachable from the factory, from error-path
            # callers, and from teardown sweeps — only the first call
            # touches the socket.  `_closed` alone cannot be the guard:
            # a dead reader sets it without ever closing the fd.
            if self._sock_closed:
                return
            self._sock_closed = True
        try:
            # shutdown() (not just close()) wakes the reader thread out
            # of its blocking recv with EOF; close() alone leaves it
            # parked on the dead fd forever — a daemon-thread leak the
            # threaded stress test pins (tests/test_concurrency.py).
            # The reader's exit then enqueues the dispatcher's sentinel,
            # so both driver threads wind down.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _ReconnectingRpc:
    """A live :class:`_RpcClient` plus everything needed to STAND UP ITS
    REPLACEMENT — registered event handlers, tapped documents, the epoch
    pin, epoch-invalidation listeners — so a transport swap (dead door
    socket, relocated document) rebuilds the session without the caller
    losing its subscriptions.  Subclasses decide WHEN to swap and WHERE
    to dial; this base keeps the replay state and exposes the exact
    surface :class:`NetworkConnection` / :class:`_RemoteStorage` consume
    (``request``/``on``/``off``/``add_epoch_listener``/``epoch``/
    ``close``)."""

    def __init__(self, timeout: float = 30.0, mc=None, faults=None,
                 retry=None, rng=None) -> None:
        self._timeout = timeout
        self._mc = mc
        self._faults = faults
        self._retry_policy = retry
        self._rng = rng
        self._client: Optional[_RpcClient] = None
        #: replayed onto every replacement transport
        self._handlers: List[tuple] = []
        self._taps: set = set()
        self._epoch_refs: List["weakref.WeakMethod"] = []
        #: transport swaps taken (test/bench pin: the drill went >= 1)
        self.failovers = 0

    def _dial(self, addr) -> _RpcClient:
        return _RpcClient(addr[0], addr[1], timeout=self._timeout,
                          mc=self._mc, faults=self._faults,
                          retry=self._retry_policy, rng=self._rng)

    def _adopt(self, client: _RpcClient) -> None:
        """Install a replacement transport: carry the epoch pin (the
        storage generation is store-wide, not per-socket), replay event
        handlers and epoch listeners, then re-establish every tap the
        old session held — the server side of a tap died with the old
        socket, so a client that does not re-subscribe goes silently
        deaf (the exact failure the demotion kick exists to prevent)."""
        old = self._client
        if old is not None:
            client.epoch = old.epoch
            try:
                old.close()
            except OSError:
                pass
        self._client = client
        for event, doc_id, fn in list(self._handlers):
            client.on(event, doc_id, fn)
        for ref in self._epoch_refs:
            if ref() is not None:
                client.add_epoch_listener(ref)
        for doc_id in sorted(self._taps):
            client.request("subscribe_doc", {"doc": doc_id})

    # -- the _RpcClient surface ------------------------------------------------

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        raise NotImplementedError

    def _note_tap(self, method: str, params: dict) -> None:
        if method == "subscribe_doc" and params.get("doc"):
            self._taps.add(params["doc"])

    def on(self, event: str, doc_id: str, fn) -> None:
        self._handlers.append((event, doc_id, fn))
        if self._client is not None:
            self._client.on(event, doc_id, fn)

    def off(self, event: str, doc_id: str, fn) -> None:
        entry = (event, doc_id, fn)
        if entry in self._handlers:
            self._handlers.remove(entry)
        if self._client is not None:
            self._client.off(event, doc_id, fn)

    def add_epoch_listener(self, ref: "weakref.WeakMethod") -> None:
        self._epoch_refs.append(ref)
        if self._client is not None:
            self._client.add_epoch_listener(ref)

    @property
    def epoch(self) -> Optional[str]:
        return self._client.epoch if self._client is not None else None

    @epoch.setter
    def epoch(self, value: Optional[str]) -> None:
        if self._client is not None:
            self._client.epoch = value

    def close(self) -> None:
        if self._client is not None:
            self._client.close()


class DoorFailoverRpc(_ReconnectingRpc):
    """The replica-list front-door transport: one live door
    socket, a list of door addresses, and dead-socket rotation.  Only
    :class:`ConnectionLostError` rotates — it is the one failure that
    can never heal in place (the socket under us is GONE, which is
    exactly what a replica SIGKILL looks like from the client).  Typed
    service refusals (nack / fence / wrongShard) and in-place-retryable
    transport noise stay with the active door."""

    def __init__(self, addrs: List[tuple], **kwargs) -> None:
        super().__init__(**kwargs)
        if not addrs:
            raise ValueError("need at least one door address")
        self._addrs = [tuple(a) for a in addrs]
        self._at = 0
        self._connect_initial()

    def _connect_initial(self) -> None:
        last: Optional[BaseException] = None
        for idx, addr in enumerate(self._addrs):
            try:
                self._client = self._dial(addr)
                self._at = idx
                return
            except OSError as exc:
                last = exc
        raise ConnectionLostError(f"no door reachable: {last}")

    def _rotate(self) -> bool:
        for step in range(1, len(self._addrs) + 1):
            idx = (self._at + step) % len(self._addrs)
            try:
                client = self._dial(self._addrs[idx])
            except OSError:
                continue
            self._at = idx
            self._adopt(client)
            self.failovers += 1
            return True
        return False

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        last: Optional[BaseException] = None
        for _attempt in range(len(self._addrs) + 1):
            try:
                result = self._client.request(method, params,
                                              timeout=timeout)
            except ConnectionLostError as exc:
                last = exc
                if not self._rotate():
                    break
                continue
            self._note_tap(method, params)
            return result
        raise last


class DirectShardRpc(_ReconnectingRpc):
    """The direct-to-shard DATA path for one document: the
    front door answers ``locate`` (control plane), the client dials the
    owning shardhost itself, and every doc-scoped RPC — submits, deltas,
    taps, summaries — skips the relay hop entirely.  Placement is a
    LEASE, not a fact: on ``wrongShard`` (live migration), ``fence``
    (failover recovery), or the shard socket dying, the client
    re-resolves through the door and retries against the new owner —
    bounded hops, because a route that never settles is an outage, not
    a redirect loop."""

    MAX_HOPS = 4

    def __init__(self, door, doc_id: str, **kwargs) -> None:
        super().__init__(**kwargs)
        self._door = door
        self.doc_id = doc_id
        self.shard: Optional[str] = None

    def _resolve(self) -> None:
        where = self._door.request("locate", {"doc": self.doc_id})
        addr = (where["host"], where["port"])
        self.shard = where["shard"]
        client = self._dial(addr)
        had = self._client is not None
        self._adopt(client)
        if had:
            self.failovers += 1

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        last: Optional[BaseException] = None
        for _hop in range(self.MAX_HOPS):
            if self._client is None:
                self._resolve()
            try:
                result = self._client.request(method, params,
                                              timeout=timeout)
            except (ShardFencedError, ConnectionLostError) as exc:
                # DocRelocatedError ⊂ ShardFencedError: stale placement.
                # ConnectionLost: the shard process died under us.  Both
                # recover the same way — ask the door who owns the
                # document NOW (its failover machinery re-homes orphans
                # on route resolution) and retry there.
                last = exc
                try:
                    self._resolve()
                except (RpcError, OSError) as resolve_exc:
                    last = resolve_exc
                continue
            self._note_tap(method, params)
            return result
        raise last


class NetworkConnection:
    """The per-document delta connection (DocumentEndpoint surface)."""

    def __init__(self, rpc: _RpcClient, doc_id: str) -> None:
        self._rpc = rpc
        self.doc_id = doc_id
        self._subscribers: List[Callable[[SequencedMessage], None]] = []
        self._signal_subscribers: List[Callable[[dict], None]] = []
        self._tapped = False
        #: diagnostics for hosts/tests: server-pushed backpressure and
        #: failover notifications observed on this document.
        self.demotions_seen = 0
        self.fences_seen = 0
        rpc.on("op", doc_id, self._on_op_event)
        rpc.on("signal", doc_id, self._on_signal_event)
        rpc.on("demoted", doc_id, self._on_demoted_event)
        rpc.on("fence", doc_id, self._on_fence_event)

    def _ensure_tap(self) -> None:
        if not self._tapped:
            self._rpc.request("subscribe_doc", {"doc": self.doc_id})
            self._tapped = True

    def _on_op_event(self, frame: dict) -> None:
        msg = decode_sequenced_message(frame["msg"])
        for fn in list(self._subscribers):
            fn(msg)

    def _on_signal_event(self, frame: dict) -> None:
        for fn in list(self._signal_subscribers):
            fn(frame["signal"])

    def _on_demoted_event(self, frame: dict) -> None:
        """The server demoted this connection's live tap (our buffer was
        the laggard): re-subscribe, then KICK the backfill — deliver the
        current head op through the live path so the DeltaManager's gap
        repair fetches the whole missed range from durable delta storage
        NOW (catch-up-from-oplog).  Without the kick, a document that
        goes quiet after the demoting burst would stay missing the
        dropped span forever (gap repair only fires on a later live
        message).  Subscribers dedup by their delivery watermark, so the
        kick is harmless when nothing was missed.  Runs on the
        dispatcher thread, which may issue blocking requests by design."""
        self.demotions_seen += 1
        try:
            head = self._rpc.request("subscribe_doc", {"doc": self.doc_id})
            head = max(int(head or 0), int(frame.get("head") or 0))
            if head > 0:
                for msg in self.deltas(from_seq=head - 1, to_seq=head):
                    for fn in list(self._subscribers):
                        fn(msg)
        except RpcError:
            # Connection is going away; reconnect handles resubscription.
            self._tapped = False

    def _on_fence_event(self, frame: dict) -> None:
        """Shard failover notification.  The epoch unpin/cache sweep
        already ran centrally in the dispatcher (_invalidate_epoch_state);
        the live broadcast continues from the recovered owner on the
        server side, so the op stream needs no client action — the
        counter is for hosts that want to log/alert."""
        self.fences_seen += 1

    # -- DocumentEndpoint surface ----------------------------------------------

    @property
    def log(self) -> List[SequencedMessage]:
        return self.deltas()

    @property
    def head_seq(self) -> int:
        return self._rpc.request("head", {"doc": self.doc_id})

    def connect(self, client_id: str, session: Optional[str] = None) -> None:
        self._ensure_tap()
        self._rpc.request(
            "connect",
            {"doc": self.doc_id, "client": client_id, "session": session},
        )

    def disconnect(self, client_id: str) -> None:
        self._rpc.request(
            "disconnect", {"doc": self.doc_id, "client": client_id}
        )

    def submit(self, op: RawOperation) -> Optional[SequencedMessage]:
        result = self._rpc.request(
            "submit", {"doc": self.doc_id, "op": encode_raw_operation(op)}
        )
        return decode_sequenced_message(result) if result else None

    def subscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        self._ensure_tap()
        self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[SequencedMessage], None]) -> None:
        if fn in self._subscribers:
            self._subscribers.remove(fn)

    def update_ref_seq(self, client_id: str, ref_seq: int) -> None:
        self._rpc.request(
            "update_ref_seq",
            {"doc": self.doc_id, "client": client_id, "ref_seq": ref_seq},
        )

    def deltas(self, from_seq: int = 0,
               to_seq: Optional[int] = None) -> List[SequencedMessage]:
        msgs = self._rpc.request(
            "deltas",
            {"doc": self.doc_id, "from_seq": from_seq, "to_seq": to_seq},
        )
        return [decode_sequenced_message(m) for m in msgs]

    def submit_signal(self, client_id: str, content,
                      target_client_id: Optional[str] = None) -> None:
        self._ensure_tap()
        self._rpc.request(
            "signal",
            {"doc": self.doc_id, "client": client_id, "content": content,
             "target": target_client_id},
        )

    def subscribe_signals(self, fn: Callable[[dict], None]) -> None:
        self._ensure_tap()
        self._signal_subscribers.append(fn)

    def unsubscribe_signals(self, fn: Callable[[dict], None]) -> None:
        if fn in self._signal_subscribers:
            self._signal_subscribers.remove(fn)


class _RemoteDeltaStorage:
    """Ranged reads of the durable log over the wire."""

    def __init__(self, conn: NetworkConnection) -> None:
        self._conn = conn

    def get(self, from_seq: int = 0,
            to_seq: Optional[int] = None) -> List[SequencedMessage]:
        return self._conn.deltas(from_seq, to_seq)

    def head(self) -> int:
        return self._conn.head_seq


class _RemoteStorage:
    """The summary store over the wire, with a client-side snapshot cache
    (odsp-driver capability): summaries fetched or uploaded are remembered
    by handle, and ``latest`` advertises the cached handles so an unchanged
    snapshot never crosses the wire again."""

    #: retained snapshots per document connection
    CACHE_LIMIT = 8

    def __init__(self, rpc: _RpcClient, doc_id: str) -> None:
        self._rpc = rpc
        self.doc_id = doc_id
        self._last_uploaded: Optional[SummaryTree] = None
        self._snapshot_cache: "dict[str, SummaryTree]" = {}
        rpc.add_epoch_listener(weakref.WeakMethod(self._drop_caches))

    def _drop_caches(self) -> None:
        self._snapshot_cache.clear()
        self._last_uploaded = None

    @property
    def _epoch(self) -> Optional[str]:
        """The pin lives on the shared _RpcClient so EVERY RPC on this
        connection (deltas/submit/catchup too) carries it — a recreated
        store answers epochMismatch instead of silently serving state our
        cached snapshots/deltas cannot be mixed with."""
        return self._rpc.epoch

    @_epoch.setter
    def _epoch(self, value: Optional[str]) -> None:
        self._rpc.epoch = value

    def _remember(self, handle: str, tree: SummaryTree) -> None:
        self._snapshot_cache[handle] = tree
        while len(self._snapshot_cache) > self.CACHE_LIMIT:
            self._snapshot_cache.pop(next(iter(self._snapshot_cache)))

    def latest(self, at_or_below: Optional[int] = None):
        # Epoch mismatch handling is CENTRAL (_RpcClient drops every
        # instance's caches + the pin before raising), so storage methods
        # just let EpochMismatchError propagate loudly.
        result = self._rpc.request(
            "latest_summary",
            {"doc": self.doc_id, "at_or_below": at_or_below,
             "have": list(self._snapshot_cache)},
        )
        if result is None:
            return None, 0
        if self._epoch is None:
            self._epoch = result.get("epoch")
        handle = result.get("handle")
        if handle is None:
            return None, 0  # no summary yet — but the epoch is adopted
        if "summary" in result:
            tree = tree_from_obj(result["summary"])
            if handle:
                self._remember(handle, tree)
        else:
            tree = self._snapshot_cache[handle]  # server said we have it
        return tree, result["ref_seq"]

    def upload(self, tree: SummaryTree, ref_seq: int) -> str:
        """Incremental against the doc's latest server-side summary when we
        have it cached: unchanged subtrees cross the wire as handles."""
        from ..protocol.summary import tree_to_incremental_obj, tree_to_obj

        obj = tree_to_incremental_obj(tree, self._last_uploaded)
        try:
            result = self._rpc.request(
                "upload_summary",
                {"doc": self.doc_id, "summary": obj, "ref_seq": ref_seq},
            )
        except EpochMismatchError:
            raise  # dead generation: NEVER fall back to a full resend
        except RpcError:
            if self._last_uploaded is None:
                raise
            # The server no longer has the base objects (restore/eviction):
            # resend in full and stop assuming the cache.
            self._last_uploaded = None
            result = self._rpc.request(
                "upload_summary",
                {"doc": self.doc_id, "summary": tree_to_obj(tree),
                 "ref_seq": ref_seq},
            )
        handle = result["handle"]
        if self._epoch is None:
            self._epoch = result.get("epoch")  # writer path adopts too
        self._last_uploaded = tree
        self._remember(handle, tree)
        return handle

    def read(self, handle: str):
        cached = self._snapshot_cache.get(handle)
        if cached is not None:
            return cached
        tree = tree_from_obj(self._rpc.request(
            "read_summary", {"handle": handle}
        ))
        self._remember(handle, tree)
        return tree

    def read_partial(self, handle: str, path: str):
        """Partial snapshot fetch: one subtree/blob by path — the odsp
        snapshot-virtualization capability (bounded download for huge
        documents)."""
        return tree_from_obj(self._rpc.request(
            "read_summary", {"handle": handle, "path": path}
        ))


class NetworkDocumentServiceFactory:
    """``IDocumentServiceFactory`` capability over a TCP ordering server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7070,
                 timeout: float = 30.0, tenant: Optional[str] = None,
                 secret: Optional[str] = None, mc=None, faults=None,
                 retry=None, retry_rng=None,
                 replicas: Optional[List[tuple]] = None,
                 direct: bool = False) -> None:
        """``replicas``: additional front-door ``(host,
        port)`` addresses over the same shard fleet — a dead door socket
        fails over to the next reachable one, taps re-established.
        ``direct`` routes every DOC-scoped call straight to the owning
        shardhost (resolved via the door's ``locate``), demoting the
        door to control plane: creation, discovery, placement."""
        self._transport_kw = dict(timeout=timeout, mc=mc, faults=faults,
                                  retry=retry, rng=retry_rng)
        addrs = [(host, port)] + [tuple(a) for a in (replicas or ())]
        if len(addrs) > 1:
            self._rpc = DoorFailoverRpc(addrs, **self._transport_kw)
        else:
            self._rpc = _RpcClient(host, port, timeout=timeout, mc=mc,
                                   faults=faults, retry=retry,
                                   rng=retry_rng)
        self.direct = bool(direct)
        self._direct_rpcs: Dict[str, DirectShardRpc] = {}
        self._connections: Dict[str, NetworkConnection] = {}
        if tenant is not None:
            # Riddler capability: authenticate the connection before any
            # document traffic; the server namespaces docs per tenant.
            try:
                self._rpc.request("auth",
                                  {"tenant": tenant, "secret": secret})
            except BaseException:
                self._rpc.close()  # no factory object escapes to close()
                raise

    def _doc_rpc(self, doc_id: str):
        """The transport DOC-scoped traffic rides: the door itself, or
        (direct mode) a per-document connection to the owning shard."""
        if not self.direct:
            return self._rpc
        rpc = self._direct_rpcs.get(doc_id)
        if rpc is None:
            rpc = DirectShardRpc(self._rpc, doc_id, **self._transport_kw)
            self._direct_rpcs[doc_id] = rpc
        return rpc

    def _connection(self, doc_id: str) -> NetworkConnection:
        conn = self._connections.get(doc_id)
        if conn is None:
            conn = NetworkConnection(self._doc_rpc(doc_id), doc_id)
            self._connections[doc_id] = conn
        return conn

    def create_document(self, doc_id: str, initial_summary: SummaryTree,
                        ref_seq: int = 0):
        self._rpc.request(
            "create_document",
            {"doc": doc_id, "summary": tree_to_obj(initial_summary),
             "ref_seq": ref_seq},
        )
        return self.resolve(doc_id)

    def resolve(self, doc_id: str):
        if not self._rpc.request("has_document", {"doc": doc_id}):
            raise KeyError(f"document {doc_id!r} does not exist")
        from .definitions import DocumentService

        conn = self._connection(doc_id)
        return DocumentService(
            doc_id,
            connection=conn,
            delta_storage=_RemoteDeltaStorage(conn),
            storage=_RemoteStorage(self._doc_rpc(doc_id), doc_id),
        )

    def close(self) -> None:
        # getattr: tests assemble partial factories via __new__ to probe
        # the unauthenticated path — close() still has to work there.
        for rpc in getattr(self, "_direct_rpcs", {}).values():
            try:
                rpc.close()
            except OSError:
                pass
        self._rpc.close()
