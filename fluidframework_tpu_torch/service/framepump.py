"""framepump: the single-threaded selector event loop behind the async
front door.

The out-of-proc tier's recorded scaling wall was the connection layer:
thread-per-connection pinned the front door at ~2x10^3 real sockets (two
threads per client once the lazily-started relay writer joined the
serve thread), while columnar shard ingress handles 10^6 simulated
clients.  This module replaces both threads with ONE event loop that
owns accept, reads, and budget-aware writes for every connection:

- :class:`FrameParser` — incremental length-prefixed frame reassembly
  (the ``[4-byte BE length][json]`` wire shape) over whatever byte
  chunks ``recv`` happens to return;
- :class:`PumpConnection` — per-socket state: the read parser plus a
  non-blocking write side holding the relay contract (bounded
  ``relay`` under a per-client byte budget, budget-exempt queue-jumping
  ``relay_priority`` for control frames) in per-socket buffers instead
  of a writer thread + Condition;
- :class:`FramePump` — the loop: a ``selectors`` selector, the
  listener, a socketpair wakeup so any thread can hand the loop bytes
  to write, and a dirty-set handshake that keeps cross-thread senders
  O(append + maybe one wakeup byte).

Threading contract (this is what FL-RACE-BLOCKING's on-loop extension
enforces): methods marked on-loop run ONLY on the pump thread and must
never block — no RPC, no fold, no ``sendall`` — because one blocking
callback stalls every connection on the loop.  Frame dispatch therefore
happens via a callback that must hand real work to a worker pool and
write the response back cross-thread through :meth:`PumpConnection.
send_obj`.

Priority frames stay frame-aligned by construction: a partially-sent
frame lives in ``_inflight`` (never re-queued), so ``appendleft`` on the
pending deque can never interleave bytes into the middle of a frame.
"""

from __future__ import annotations

import json
import selectors
import socket
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Set

from ..protocol.wire import LEN as _LEN, MAX_FRAME, frame_bytes

#: read chunk per ready socket per loop pass: big enough to drain a
#: bursty client in few syscalls, small enough that one firehose cannot
#: monopolize the pass.
_READ_CHUNK = 256 << 10

#: response-path high water (mirrors the ordering server's
#: WRITE_HIGH_WATER): a client that stops reading while we owe it
#: RESPONSES (not relays — those have their own budget) is broken or
#: hostile; past this we close rather than buffer without bound.
RESPONSE_HIGH_WATER = 32 << 20


class FrameParser:
    """Incremental ``[4-byte BE length][payload]`` reassembly.

    Single-threaded by design (owned by the loop); feed() returns every
    COMPLETE payload the new chunk finished, keeping any tail bytes for
    the next chunk.  Raises ``ValueError`` on an oversized frame — the
    caller drops the connection (the stream is unrecoverable: we cannot
    know where the next frame starts)."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        out: List[bytes] = []
        at = 0
        buf = self._buf
        while True:
            if len(buf) - at < _LEN.size:
                break
            (length,) = _LEN.unpack_from(buf, at)
            if length > MAX_FRAME:
                raise ValueError(f"frame length {length} exceeds "
                                 f"MAX_FRAME {MAX_FRAME}")
            if len(buf) - at < _LEN.size + length:
                break
            start = at + _LEN.size
            out.append(bytes(buf[start:start + length]))
            at = start + length
        if at:
            del buf[:at]
        return out


class PumpConnection:
    """One client socket on the pump: read parser + non-blocking write
    buffers carrying the relay-budget contract.

    Write-side layout (all guarded by ``_wlock``): ``_inflight`` holds
    the partially-sent head frame (a memoryview advanced by each
    ``send``), ``_pending`` the queued whole frames.  ``relay_priority``
    jumps the queue with ``appendleft`` — frame-aligned because the
    in-flight frame is never in the deque.  Only the pump thread ever
    touches the socket; other threads append and ring the pump's
    wakeup."""

    __slots__ = (
        "sock", "parser", "subscribed", "relay_budget", "_pump",
        "_wlock", "_pending", "_inflight", "_inflight_len",
        "_relay_bytes", "_pending_bytes", "closed", "_peer",
    )

    def __init__(self, sock: socket.socket, pump: "FramePump",
                 relay_budget: int = 4 << 20) -> None:
        self.sock = sock
        self.parser = FrameParser()
        #: docs this client subscribed to (front-door bookkeeping; the
        #: door's route lock guards cross-thread mutation, same contract
        #: as the old per-session serve thread)
        self.subscribed: Set[str] = set()
        self.relay_budget = int(relay_budget)
        self._pump = pump
        self._wlock = threading.Lock()
        self._pending: "deque[bytes]" = deque()  # guarded-by: _wlock
        self._inflight: Optional[memoryview] = None  # guarded-by: _wlock
        self._inflight_len = 0  # guarded-by: _wlock
        self._relay_bytes = 0  # guarded-by: _wlock
        self._pending_bytes = 0  # guarded-by: _wlock
        self.closed = False
        try:
            self._peer = sock.getpeername()
        except OSError:
            self._peer = ("?", 0)

    # -- cross-thread write API ------------------------------------------------

    def send_obj(self, obj: dict) -> None:
        self.send_bytes(frame_bytes(obj))

    def send_bytes(self, data: bytes) -> None:
        """Response-path enqueue (unbudgeted but high-watered): worker
        threads answer requests here; the pump flushes."""
        overflow = False
        with self._wlock:
            if self.closed:
                return
            if self._pending_bytes - self._relay_bytes \
                    > RESPONSE_HIGH_WATER:
                overflow = True
            else:
                self._pending.append(data)
                self._pending_bytes += len(data)
        if overflow:
            # A client that stopped reading its own responses: close
            # instead of buffering without bound (relay frames have
            # their own budget + demotion; this is the response path).
            self._pump.drop(self)
            return
        self._pump.mark_dirty(self)

    # -- the relay contract ----------------------------------------------

    def relay(self, data: bytes) -> bool:
        """Bounded enqueue of one broadcast frame: False = the budget is
        exhausted (a stalled or slow reader) and the caller demotes this
        session — the broadcaster's sink contract at this hop.  A frame
        larger than the whole budget is still accepted into an EMPTY
        relay queue (charged in flight): otherwise one oversized event
        would demote every subscriber — idle fast readers included — on
        every occurrence, forever.  Memory stays bounded by
        ``max(relay_budget, one frame)``."""
        with self._wlock:
            if self.closed:
                return True  # tearing down: drop silently, like the sink
            if self._relay_bytes > 0 \
                    and self._relay_bytes + len(data) > self.relay_budget:
                return False
            self._pending.append(data)
            self._relay_bytes += len(data)
            self._pending_bytes += len(data)
        self._pump.mark_dirty(self)
        return True

    def relay_priority(self, data: bytes) -> None:
        """Budget-exempt, queue-jumping enqueue for CONTROL frames
        (demoted / fence): bounded by construction — at most one per
        (doc, event) — and they must reach a saturated client PROMPTLY,
        not behind its whole data backlog (the demotion notice IS the
        recovery trigger the driver's re-subscribe rides; receivers
        dedup any stale data frames that drain after it by seq
        watermark).  ``appendleft`` is frame-aligned: the partially-sent
        frame lives in ``_inflight``, never in this deque."""
        with self._wlock:
            if self.closed:
                return
            self._pending.appendleft(data)
            self._pending_bytes += len(data)
        self._pump.mark_dirty(self)

    def relay_pending(self) -> int:
        with self._wlock:
            return self._relay_bytes

    def pending_bytes(self) -> int:
        with self._wlock:
            return self._pending_bytes

    # -- pump-side flush (loop thread only) ------------------------------------

    def flush(self) -> bool:  # on-loop
        """Send as much buffered data as the kernel accepts right now.
        Returns True when fully drained (the pump drops write
        interest).  Budget accounting: a relay frame stays charged
        until the kernel accepted its LAST byte — in-flight bytes count
        against the budget, exactly the writer-thread semantics."""
        while True:
            with self._wlock:
                if self._inflight is None:
                    if not self._pending:
                        return True
                    frame = self._pending.popleft()
                    self._inflight = memoryview(frame)
                    self._inflight_len = len(frame)
                view = self._inflight
                # The send stays inside the critical section: the socket
                # is non-blocking so the hold is one bounded syscall, and
                # it closes the window against close() clearing the
                # buffers between our read of _inflight and the
                # accounting below.
                try:
                    sent = self.sock.send(view)
                except (BlockingIOError, InterruptedError):
                    return False
                self._pending_bytes -= sent
                # _relay_bytes accounts whole frames; release on frame
                # completion below (per-byte split would need tagging —
                # whole-frame release keeps the stall bound identical).
                if sent == len(view):
                    self._relay_bytes = max(
                        0, self._relay_bytes
                        - self._uncharge(self._inflight_len))
                    self._inflight = None
                    self._inflight_len = 0
                else:
                    self._inflight = view[sent:]
                    return False

    def _uncharge(self, n: int) -> int:
        # holds-lock: _wlock
        # Relay frames and response frames share one FIFO (ordering is
        # the contract); budget release approximates by draining the
        # relay charge frame-by-frame — never below zero, never above
        # what was charged.  Exact per-frame tagging would double the
        # queue's memory for no observable difference in the demotion
        # bound.
        return n if self._relay_bytes >= n else self._relay_bytes

    def close(self) -> None:
        """Idempotent teardown; safe from any thread (the socket close
        races are absorbed by OSError guards — the pump unregisters on
        its next pass via the closed flag)."""
        with self._wlock:
            if self.closed:
                return
            self.closed = True
            self._pending.clear()
            self._inflight = None
            self._inflight_len = 0
            self._relay_bytes = 0
            self._pending_bytes = 0
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class FramePump:
    """The selector loop: one thread owning accept, reads, and writes
    for every client connection of a front-door replica.

    ``on_frame(conn, obj)`` fires ON the loop thread for every decoded
    frame — it must not block (hand work to a pool; see the module
    doc).  ``on_close(conn)`` fires when a connection leaves (EOF,
    error, response overflow) so the owner can drop bookkeeping."""

    def __init__(self, host: str, port: int,
                 on_frame: Callable[[PumpConnection, dict], None],
                 on_close: Optional[Callable[[PumpConnection], None]]
                 = None,
                 relay_budget: int = 4 << 20, backlog: int = 1024,
                 mc=None) -> None:
        self.host = host
        self.relay_budget = int(relay_budget)
        self._on_frame = on_frame
        self._on_close = on_close
        self._mc = mc
        self._selector = selectors.DefaultSelector()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(backlog)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        # self-pipe: cross-thread senders ring this to wake select()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._dirty_lock = threading.Lock()
        self._dirty: Set[PumpConnection] = set()  # guarded-by: _dirty_lock
        self._conns: Dict[socket.socket, PumpConnection] = {}
        self._want_write: Set[PumpConnection] = set()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.accepted = 0
        self.dropped = 0

    # -- lifecycle (off-loop) --------------------------------------------------

    def start(self) -> "FramePump":  # off-loop
        self._selector.register(self._lsock, selectors.EVENT_READ,
                                self._accept_ready)
        self._selector.register(self._wake_r, selectors.EVENT_READ,
                                self._wake_ready)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="framepump")
        self._thread.start()
        return self

    def close(self) -> None:  # off-loop
        """Stop the loop and close every socket.  Abrupt by design —
        buffered frames are NOT flushed (a replica SIGKILL and a
        graceful close are indistinguishable to clients, which is
        exactly the failover contract the drivers recover through)."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        self._ring()
        if self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)
        for conn in list(self._conns.values()):
            conn.close()
        self._conns.clear()
        try:
            self._lsock.close()
        except OSError:
            pass
        for sock in (self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._selector.close()
        except (OSError, RuntimeError):
            pass

    def connections(self) -> List[PumpConnection]:  # off-loop
        """Snapshot for stats; best-effort under concurrency (the dict
        is only mutated on the loop thread)."""
        return list(self._conns.values())

    # -- cross-thread write handshake (off-loop) -------------------------------

    def mark_dirty(self, conn: PumpConnection) -> None:  # off-loop
        """A writer queued bytes on ``conn``: hand it to the loop.  One
        wakeup byte per idle->busy transition, not per frame."""
        with self._dirty_lock:
            ring = not self._dirty
            self._dirty.add(conn)
        if ring:
            self._ring()

    def drop(self, conn: PumpConnection) -> None:  # off-loop
        """Close ``conn`` and have the loop forget it (response
        overflow, owner-side demote-to-dead)."""
        conn.close()
        self.mark_dirty(conn)  # the loop observes .closed and purges

    def _ring(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wakeup is already pending; or closing

    # -- the loop (every method below runs on the pump thread) -----------------

    def _run(self) -> None:  # on-loop
        while not self._stopping.is_set():
            events = self._selector.select(timeout=0.5)
            for key, mask in events:
                key.data(key, mask)
            self._flush_dirty()

    def _accept_ready(self, key, mask) -> None:  # on-loop
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closed mid-shutdown
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = PumpConnection(sock, self,
                                  relay_budget=self.relay_budget)
            self._conns[sock] = conn
            self.accepted += 1
            self._selector.register(sock, selectors.EVENT_READ,
                                    self._make_io_cb(conn))

    def _make_io_cb(self, conn: PumpConnection):  # on-loop
        def _cb(key, mask) -> None:
            if mask & selectors.EVENT_READ:
                self._read_ready(conn)
            if mask & selectors.EVENT_WRITE and not conn.closed:
                self._write_ready(conn)
        return _cb

    def _wake_ready(self, key, mask) -> None:  # on-loop
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _read_ready(self, conn: PumpConnection) -> None:  # on-loop
        try:
            data = conn.sock.recv(_READ_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._purge(conn)
            return
        if not data:
            self._purge(conn)  # EOF
            return
        try:
            frames = conn.parser.feed(data)
            for payload in frames:
                self._on_frame(conn, json.loads(payload))
        except ValueError as exc:
            # oversized frame or broken JSON: the stream is garbage
            if self._mc is not None:
                self._mc.logger.send({"eventName": "pumpFrameError",
                                      "error": str(exc)})
            self._purge(conn)

    def _write_ready(self, conn: PumpConnection) -> None:  # on-loop
        try:
            drained = conn.flush()
        except OSError:
            self._purge(conn)
            return
        if drained and conn in self._want_write:
            self._want_write.discard(conn)
            self._set_interest(conn, selectors.EVENT_READ)

    def _flush_dirty(self) -> None:  # on-loop
        with self._dirty_lock:
            if not self._dirty:
                return
            dirty = list(self._dirty)
            self._dirty.clear()
        for conn in dirty:
            if conn.closed:
                self._purge(conn)
                continue
            try:
                drained = conn.flush()
            except OSError:
                self._purge(conn)
                continue
            if not drained and conn not in self._want_write:
                self._want_write.add(conn)
                self._set_interest(conn, selectors.EVENT_READ
                                   | selectors.EVENT_WRITE)

    def _set_interest(self, conn: PumpConnection, mask: int) -> None:
        # on-loop
        try:
            self._selector.modify(conn.sock, mask,
                                  self._make_io_cb(conn))
        except (KeyError, ValueError, OSError):
            pass  # already purged / socket closed under us

    def _purge(self, conn: PumpConnection) -> None:  # on-loop
        try:
            self._selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        self._conns.pop(conn.sock, None)
        self._want_write.discard(conn)
        was_open = not conn.closed
        conn.close()
        if was_open:
            self.dropped += 1
        if self._on_close is not None:
            self._on_close(conn)
