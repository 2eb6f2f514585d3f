"""fluidproc front door: routing, supervision, failover, live migration.

The Alfred-shaped entry point of the out-of-process tier: one
process that owns the :class:`~.sharding.ShardRouter`, supervises a fleet
of :mod:`~.shardhost` **processes** (spawn, heartbeat, death detection),
and speaks the existing client frame protocol — so
``NetworkDocumentServiceFactory`` and the Loader run against it
unchanged.  Every document-scoped request is proxied to the owning shard
over a per-shard RPC connection; broadcast events are relayed
serialize-once (one ``frame_bytes`` per event for all subscribed client
sessions).

Connection layer: a single-threaded :mod:`~.framepump`
event loop owns every client socket — accept, reads, and budget-aware
writes — and decoded frames dispatch to a small worker pool (responses
match by ``re`` id, so per-connection pipelining is safe).  Connection
count is a benchmarked axis (``tools/loadgen.py --connections``), not a
thread-count ceiling.  N doors can front one shard fleet: replicas run
``spawn="attach"`` against the primary's ``shard_addrs()`` and agree on
placement purely through the deterministic rendezvous router — shared
assignment state is ZERO, and each replica taps shard broadcasts over
its own RPC connection.

Control plane (all topology mutations run on ONE supervisor thread — the
actor discipline that keeps failover and migration serialized without
holding a lock across an RPC round-trip):

- **Failover** (``proc.kill`` faults, heartbeat death detection, or a
  transport error observed by a proxy thread): the victim process is
  SIGKILLed first — *process death is the fence*; a merely-hung process
  must not wake up and extend a log whose documents were re-owned — then
  the router marks it dead, every surviving shard adopts the
  deterministically-derived fence epoch, and the dead shard's documents
  re-own by **adoption**: the new owner imports the document's span from
  the dead shard's on-disk log (read-only view) into its OWN log and
  recovers the orderer by replay.  Documents with live subscriptions
  adopt eagerly (broadcast channels re-wired, ``fence`` events pushed);
  the rest adopt lazily on next touch — failover is O(live
  subscriptions), exactly the in-proc tier's bar.
- **Live migration** (``add_shard``): per document — ``freeze`` on the
  source (fence + seal + checkpoint at the frozen head), ``transfer``
  (export the log span; the summary store is shared and content-
  addressed, so only the handle is named), ``import`` on the target
  (idempotent span append + checkpoint restore, so quorum state and
  dedup floors continue exactly), ``flip`` (the front door's per-doc
  override — rendezvous takes over when the shard finally joins the
  router), ``resume`` (re-wire broadcast, retire the source copy).  A
  crash at ANY step converges: source death falls back to failover +
  re-try, target death aborts with a ``thaw`` (the document never left),
  and the import's idempotence absorbs unknown-outcome retries.

See SEMANTICS.md "Deployment & migration" for the exact guarantees (and
non-guarantees: heartbeat detection cannot distinguish slow from dead —
the SIGKILL-before-adopt rule is what makes the distinction irrelevant).

The port's copy of ``fluidframework_tpu/service/frontdoor.py``: every
shard folds its catch-ups on the front door's ``device`` (the card by
default, checked once when the door is built).  A ``ProcShard`` spawns
``python -m fluidframework_tpu_torch.service.shardhost ... --device
<device>``, so each shard process opens its own CUDA context; a
``ThreadShard`` passes the device to its in-process server.
"""

from __future__ import annotations

import os
import queue
import signal as _signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from ..drivers.network_driver import (RpcError, RpcTimeoutError,
                                      RpcTransportError, _RpcClient)
from ..ops.mergetree_kernel import resolve_device
from ..protocol.messages import (DocRelocatedError, NackError,
                                 ShardFencedError)
from ..protocol.wire import (WIRE_VERSION, decode_column_batch,
                             encode_column_batch, frame_bytes)
from ..utils.telemetry import LockedCounterSet, MonitoringContext
from .framepump import FramePump, PumpConnection
from .sharding import ShardRouter, fence_token, rendezvous_score

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: transport-shaped failures from a shard RPC: the shard may be dead
#: (check it), the request may or may not have landed (retries dedup).
_TRANSPORT_ERRORS = (RpcTransportError, RpcTimeoutError, OSError)


class MigrationAborted(RuntimeError):
    """``add_shard`` could not complete (the target died mid-migration):
    every frozen document was thawed back to its source — the tier is
    exactly as it was, minus the dead would-be shard."""


class _Job:
    """One unit of supervisor work (the control-plane actor queue).
    ``fire_and_forget`` marks jobs with no waiter (heartbeat posts): their
    failure must surface through telemetry, or it vanishes entirely."""

    def __init__(self, fn: Callable[[], object],
                 fire_and_forget: bool = False) -> None:
        self.fn = fn
        self.fire_and_forget = fire_and_forget
        self.done = threading.Event()
        self.result: object = None
        self.error: Optional[BaseException] = None


class ShardHandle:
    """Supervision view of one shard server: RPC + liveness + signals."""

    def __init__(self, shard_id: str) -> None:
        self.shard_id = shard_id
        self.addr: Tuple[str, int] = ("", 0)
        self.rpc: Optional[_RpcClient] = None
        #: the shard process pid (from ``shard_info``): what lets a
        #: NON-owning front door (a replica attached to another door's
        #: shards) still honor SIGKILL-is-the-fence on failover.
        self.pid: Optional[int] = None
        #: the liveness probe's own connection (see :meth:`ping`)
        self._probe: Optional[_RpcClient] = None  # guarded-by: _probe_lock
        self._probe_lock = threading.Lock()

    def connect(self, mc=None, timeout: float = 30.0) -> None:
        self.rpc = _RpcClient(self.addr[0], self.addr[1], timeout=timeout,
                              mc=mc)

    def ping(self, timeout: float = 2.0) -> bool:
        """Liveness over a connection of its own: a shard serves one
        connection's requests in order, so a ping queued behind a long
        ``catchup`` on the data connection would time out and fence a
        shard that is only busy."""
        if self.rpc is None:
            return False
        try:
            with self._probe_lock:
                if self._probe is None:
                    self._probe = _RpcClient(self.addr[0], self.addr[1],
                                             timeout=timeout)
                probe = self._probe
            return probe.request("ping", {}, timeout=timeout) == "pong"
        except (RpcError, OSError, ConnectionError):
            return False

    def request(self, method: str, params: dict,
                timeout: Optional[float] = None):
        if self.rpc is None:
            raise RpcTransportError(
                f"shard {self.shard_id} has no connection")
        return self.rpc.request(method, params, timeout=timeout)

    # backend-specific ---------------------------------------------------------

    def alive(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def kill(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def hang(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def terminate(self, timeout: float = 15.0) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        if self.rpc is not None:
            self.rpc.close()
        with self._probe_lock:
            probe, self._probe = self._probe, None
        if probe is not None:
            probe.close()


class ProcShard(ShardHandle):
    """A real ``python -m fluidframework_tpu_torch.service.shardhost``
    process, folding on ``device``."""

    def __init__(self, shard_id: str, base_dir: str,
                 fault_plan_path: Optional[str] = None,
                 extra_args: Tuple[str, ...] = (),
                 device: str = "cuda") -> None:
        super().__init__(shard_id)
        cmd = [sys.executable, "-m",
               "fluidframework_tpu_torch.service.shardhost",
               "--shard-id", shard_id, "--dir", base_dir, "--port", "0",
               "--device", str(device)]
        if fault_plan_path:
            cmd += ["--fault-plan", fault_plan_path]
        cmd += list(extra_args)
        self.proc = subprocess.Popen(
            cmd, cwd=_REPO_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        self.log_tail: List[str] = []
        self._await_ready()
        self._drain = threading.Thread(target=self._drain_stdout,
                                       daemon=True)
        self._drain.start()

    def _await_ready(self, timeout: float = 60.0) -> None:
        import select

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ready, _, _ = select.select([self.proc.stdout], [], [], 0.5)
            if not ready:
                if self.proc.poll() is not None:
                    break
                continue
            line = self.proc.stdout.readline()
            if line == "" and self.proc.poll() is not None:
                break
            self.log_tail.append(line.rstrip())
            if "listening on" in line:
                addr = line.split("listening on", 1)[1].split()[0]
                host, port = addr.rsplit(":", 1)
                self.addr = (host, int(port))
                return
        self.proc.kill()
        raise RuntimeError(
            f"shardhost {self.shard_id} never reported listening: "
            f"{self.log_tail[-5:]}")

    def _drain_stdout(self) -> None:
        # Keep the pipe from filling; remember a bounded tail for
        # post-mortems (the SIGTERM seal line rides this).
        for line in self.proc.stdout:
            self.log_tail.append(line.rstrip())
            del self.log_tail[:-200]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()  # SIGKILL: no drain, no seal — the real test
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass

    def hang(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(_signal.SIGSTOP)

    def terminate(self, timeout: float = 15.0) -> None:
        """Graceful stop: SIGTERM → drain-and-seal → exit; escalates to
        SIGKILL only if the drain never completes."""
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()


class ThreadShard(ShardHandle):
    """An in-process shard server (same on-disk layout, same RPC) for
    cheap harness runs: "kill" abandons the server instead of SIGKILLing
    a process — equivalent to a kill landing between dispatches, which is
    the only difference the deterministic harnesses can observe.  The
    REAL signal semantics (mid-anything SIGKILL, SIGSTOP hangs, SIGTERM
    seal) are exercised by the ``ProcShard`` tests and benches."""

    def __init__(self, shard_id: str, base_dir: str,
                 extra_args: Tuple[str, ...] = (),
                 device: str = "cuda") -> None:
        from .shardhost import ShardHost, ShardHostServer, apply_shard_flags

        super().__init__(shard_id)
        self.host_obj = ShardHost(shard_id, base_dir)
        self.server = ShardHostServer(self.host_obj, port=0, device=device)
        # Same tuning vocabulary as the process CLI (and re-applied the
        # same way on a failover respawn).
        apply_shard_flags(self.server, extra_args)
        self.server.start_in_thread()
        self.addr = ("127.0.0.1", self.server.port)
        self._dead = False
        self._hung = False

    def ping(self, timeout: float = 2.0) -> bool:
        if self._hung or self._dead:
            return False
        return super().ping(timeout=timeout)

    def alive(self) -> bool:
        return not self._dead

    def _stop_listener(self) -> None:
        """Close the in-thread server's listening socket so abandoned
        shards do not accumulate live listeners/loops for the process
        lifetime (long harness sessions kill many of these)."""
        loop, server = self.server.loop, self.server._server
        if loop is not None and server is not None:
            try:
                loop.call_soon_threadsafe(server.close)
            except RuntimeError:
                pass  # loop already closed

    def kill(self) -> None:
        self._dead = True
        # Process-death semantics without a process: a SIGKILLed shard
        # stamps NOTHING ever again — fence every orderer BEFORE closing
        # the connection, or the server-side session teardown would
        # gracefully stamp LEAVEs into the "dead" log (messages a real
        # kill -9 could never produce, and the adopted owner would then
        # replay a quorum the oracle never saw).
        self.host_obj.service.fence_all()
        self.close()
        self._stop_listener()

    def hang(self) -> None:
        self._hung = True

    def terminate(self, timeout: float = 15.0) -> None:
        self._dead = True
        # Order matters: fence before closing the connection — the
        # server-side session teardown would otherwise stamp LEAVEs
        # into a log the seal below is about to close.
        self.host_obj.service.fence_all()
        self.close()
        self._stop_listener()
        self.host_obj.seal()


class ExternShard(ShardHandle):
    """Attach-mode handle: a shard-host process OWNED BY
    ANOTHER front door (the primary), addressed over TCP.  N shared-
    nothing replicas supervise the same shard fleet through these —
    they agree on doc→shard placement purely through the deterministic
    rendezvous router, with zero shared assignment state.

    Ownership split: ``terminate`` is a NO-OP (a replica closing must
    never tear down shards the primary still serves), but ``kill`` is
    REAL — it SIGKILLs by pid (``shard_info`` reports it; same-machine
    deployment).  SIGKILL-is-the-fence must hold no matter which
    replica runs a failover: adopting a merely-unreachable shard's
    documents without killing it would let the old process wake up and
    extend a re-owned log."""

    def __init__(self, shard_id: str, addr: Tuple[str, int]) -> None:
        super().__init__(shard_id)
        self.addr = (addr[0], int(addr[1]))

    def alive(self) -> bool:
        # No child handle to poll: liveness is observable only over the
        # wire.  The heartbeat model already accepts that ambiguity —
        # kill-before-adopt is what makes slow-vs-dead irrelevant.
        return self.ping()

    def kill(self) -> None:
        if self.pid is None:
            return
        try:
            os.kill(self.pid, _signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass  # already gone (the owner may have reaped it)

    def hang(self) -> None:
        if self.pid is None:
            return
        try:
            os.kill(self.pid, _signal.SIGSTOP)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self, timeout: float = 15.0) -> None:
        """Not ours to stop: the owning front door drains-and-seals its
        own children on ITS close."""


class FrontDoor:
    """The routing front door + shard supervisor of the fluidproc tier.

    Public API (thread-safe; topology mutations serialize on the
    supervisor thread): :meth:`start`, :meth:`close`, :meth:`add_shard`,
    :meth:`fail_shard`, :meth:`tick` (fault-plan driver), :meth:`stats`,
    :meth:`poll_shards` (synchronous death-detection sweep).
    """

    def __init__(self, base_dir: str, n_shards: int = 4,
                 shard_ids: Optional[List[str]] = None,
                 spawn: str = "proc", host: str = "127.0.0.1",
                 port: int = 0, faults=None,
                 heartbeat_interval: Optional[float] = None,
                 hang_detect_ticks: int = 2, mc=None,
                 shard_fault_plan_path: Optional[str] = None,
                 request_timeout: float = 30.0,
                 relay_budget: int = 4 << 20,
                 attach_addrs: Optional[Dict[str, Tuple[str, int]]] = None,
                 shard_args: Optional[List[str]] = None,
                 dispatch_workers: int = 8, device="cuda") -> None:
        if spawn not in ("proc", "thread", "attach"):
            raise ValueError(f"unknown spawn backend {spawn!r}")
        #: the device every shard this door spawns folds on, checked
        #: here once: "cuda" without a card raises before anything starts
        #: (attach replicas spawn nothing, so theirs is never used).
        self.device = resolve_device(device)
        if spawn == "attach":
            if not attach_addrs:
                raise ValueError("attach spawn requires attach_addrs")
            ids = (list(shard_ids) if shard_ids is not None
                   else sorted(attach_addrs))
        else:
            ids = (list(shard_ids) if shard_ids is not None
                   else [f"shard{i:02d}" for i in range(n_shards)])
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.spawn_mode = spawn
        self._attach_addrs = dict(attach_addrs or {})
        #: extra tuning args applied to every spawned shard — CLI args
        #: for proc spawns, the same vocabulary via
        #: ``shardhost.apply_shard_flags`` for thread spawns (e.g. the
        #: wire-clock admission flags a deterministic out-of-proc storm
        #: needs); ignored for attach spawns (not ours to configure).
        self.shard_args: Tuple[str, ...] = tuple(shard_args or ())
        self.host = host
        self.port = port
        self.router = ShardRouter(ids)
        self.epoch: Optional[str] = None
        self.fences = 0
        self._mc = (mc or MonitoringContext()).child("frontdoor")
        self._faults = faults
        self._shard_fault_plan_path = shard_fault_plan_path
        self.hang_detect_ticks = int(hang_detect_ticks)
        self._heartbeat_interval = heartbeat_interval
        #: per shard-RPC timeout: a SIGSTOPped (hung-not-dead) shard is
        #: only discovered when a request against it expires — harnesses
        #: drop this so hang windows cost seconds, not the 30 s default.
        self.request_timeout = float(request_timeout)
        #: per-client broadcast-relay byte budget: queued +
        #: in-flight relay bytes above this demote the session for the
        #: saturating document — bounded memory per laggard, no relay
        #: stall for anyone else.
        self.relay_budget = int(relay_budget)
        self.counters = LockedCounterSet(
            "fd.requests", "fd.failovers", "fd.adoptions", "fd.migrations",
            "fd.retries", "fd.events", "fd.hangs", "fd.heartbeat_failures",
            "fd.relay_demotions",
        )
        #: routing state — every map below is dict-operations-only under
        #: the route lock; RPC never happens while it is held.
        self._route_lock = threading.Lock()
        self._shards: Dict[str, ShardHandle] = {}  # guarded-by: _route_lock
        self._overrides: Dict[str, str] = {}  # guarded-by: _route_lock
        self._orphans: Dict[str, str] = {}  # guarded-by: _route_lock
        self._docs: Set[str] = set()  # guarded-by: _route_lock
        self._subs: Dict[str, List[PumpConnection]] = {}  # guarded-by: _route_lock
        self._tap_registered: Set[Tuple[str, str]] = set()  # guarded-by: _route_lock
        #: migration audit trail: (doc, source shard, target shard)
        self.migrations: List[Tuple[str, str, str]] = []  # guarded-by: _route_lock
        #: proc.hang detections pending their virtual-tick deadline
        self._hang_pending: Dict[str, int] = {}
        self._next_ordinal = len(ids)
        self._crash_hook: Optional[Callable[[str, str], None]] = None
        self._stopping = threading.Event()
        self._jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._supervisor: Optional[threading.Thread] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        #: the event-loop connection layer: ONE thread owns
        #: accept + reads + budget-aware writes for every client socket;
        #: decoded frames dispatch to the worker pool below (a shard RPC
        #: must never run on the loop — it would stall every connection).
        self._pump: Optional[FramePump] = None
        self._dispatch: Optional[ThreadPoolExecutor] = None
        self.dispatch_workers = int(dispatch_workers)
        #: set by :meth:`kill` (replica-death drills): this door went
        #: down ABRUPTLY — no drain, no seal, shards left running.
        self.killed = False

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FrontDoor":
        try:
            for sid in self.router.shard_ids():
                handle = self._spawn(sid)
                with self._route_lock:
                    self._shards[sid] = handle
            self._seed_registry()
        except BaseException:
            # A later spawn (port exhaustion, child import error) or the
            # registry seed failed: reap every shard already running, or
            # each failed start() leaks live processes.
            with self._route_lock:
                spawned = list(self._shards.values())
            for handle in spawned:
                handle.close()
                try:
                    handle.terminate()
                except (OSError, RuntimeError):
                    pass
            raise
        self._dispatch = ThreadPoolExecutor(
            max_workers=self.dispatch_workers,
            thread_name_prefix="fd-dispatch")
        self._pump = FramePump(self.host, self.port, self._on_frame,
                               on_close=self._drop_session,
                               relay_budget=self.relay_budget,
                               mc=self._mc)
        self._pump.start()
        self.port = self._pump.port
        self._supervisor = threading.Thread(target=self._supervisor_loop,
                                            daemon=True)
        self._supervisor.start()
        if self._heartbeat_interval is not None:
            self._heartbeat_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True)
            self._heartbeat_thread.start()
        return self

    def _spawn(self, shard_id: str) -> ShardHandle:
        if self.spawn_mode == "proc":
            handle: ShardHandle = ProcShard(
                shard_id, self.base_dir,
                fault_plan_path=self._shard_fault_plan_path,
                extra_args=self.shard_args, device=str(self.device))
        elif self.spawn_mode == "attach":
            if shard_id not in self._attach_addrs:
                raise RpcTransportError(
                    f"attach replica has no address for {shard_id!r}")
            handle = ExternShard(shard_id, self._attach_addrs[shard_id])
        else:
            handle = ThreadShard(shard_id, self.base_dir,
                                 extra_args=self.shard_args,
                                 device=self.device)
        handle.connect(mc=self._mc, timeout=self.request_timeout)
        info = handle.request("shard_info", {})
        handle.pid = info.get("pid")
        if self.epoch is None:
            self.epoch = info["epoch"]
        return handle

    def _seed_registry(self) -> None:
        """Restart over an existing deployment: the doc registry rebuilds
        from every shard's durable log heads."""
        with self._route_lock:
            handles = list(self._shards.values())
        seen: Set[str] = set()
        for handle in handles:
            stats = handle.request("stats", {})
            seen.update(stats.get("heads", {}))
        with self._route_lock:
            self._docs.update(seen)

    def close(self) -> None:
        """Graceful stop: connections down, workers drained, every OWNED
        shard drain-and-sealed (``ExternShard.terminate`` is a no-op —
        attach replicas never tear down the primary's fleet)."""
        self._stopping.set()
        if self._pump is not None:
            self._pump.close()
        if self._dispatch is not None:
            self._dispatch.shutdown(wait=False)
        self._jobs.put(None)
        with self._route_lock:
            handles = list(self._shards.values())
        for handle in handles:
            handle.close()
            try:
                handle.terminate()
            except (OSError, RuntimeError) as exc:
                self._mc.logger.send({
                    "eventName": "shardTerminateError",
                    "shard": handle.shard_id, "error": str(exc)})
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=10)

    def kill(self) -> None:
        """Abrupt death (replica drills): every client socket drops with
        NOTHING flushed — from the wire this is indistinguishable from a
        SIGKILLed replica process, which is the point.  Shard processes
        are NOT touched (a replica does not own them; for a primary this
        models the supervisor dying while its children keep serving —
        callers that own shards must still reap them)."""
        self.killed = True
        self._stopping.set()
        if self._pump is not None:
            self._pump.close()
        if self._dispatch is not None:
            self._dispatch.shutdown(wait=False, cancel_futures=True)
        self._jobs.put(None)
        with self._route_lock:
            handles = list(self._shards.values())
        for handle in handles:
            handle.close()  # the RPC socket only, never the process
        if self._supervisor is not None:
            self._supervisor.join(timeout=10)
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=10)

    # -- the supervisor actor (ALL topology mutations run here) ----------------

    def _supervisor_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                job.result = job.fn()
            except BaseException as exc:
                # Delivered to the waiter; a waiterless (fire-and-forget)
                # job's failure surfaces through telemetry instead of
                # vanishing with the Job object.
                job.error = exc
                if job.fire_and_forget:
                    self._mc.logger.send({
                        "eventName": "supervisorJobFailed",
                        "error": str(exc),
                        "errorType": type(exc).__name__,
                    })
            finally:
                job.done.set()

    def _control(self, fn: Callable[[], object], wait: bool = True,
                 timeout: float = 600.0):
        """Run ``fn`` on the supervisor thread.  ``wait=False`` posts and
        returns (heartbeat detections; failures land in telemetry);
        otherwise the caller blocks — bounded — and the job's exception
        re-raises here."""
        job = _Job(fn, fire_and_forget=not wait)
        self._jobs.put(job)
        if not wait:
            return None
        if not job.done.wait(timeout):
            raise RuntimeError("front-door supervisor stalled")
        if job.error is not None:
            raise job.error
        return job.result

    # -- routing ---------------------------------------------------------------

    def _owner_for(self, doc_id: str, candidates: List[str]) -> str:
        return max(candidates,
                   key=lambda sid: (rendezvous_score(doc_id, sid), sid))

    def _route_probe(self, doc_id: str) -> Tuple[str, Optional[str]]:
        """(current owner, orphan source or None) in one critical
        section."""
        with self._route_lock:
            sid = self._overrides.get(doc_id)
            if sid is None:
                sid = self.router.owner(doc_id)
            return sid, self._orphans.get(doc_id)

    def _route_ready(self, doc_id: str) -> str:
        """The owner shard id, with lazy failover adoption done: a
        document orphaned by a dead shard is imported into its new owner
        before any request is forwarded there."""
        sid, orphan_src = self._route_probe(doc_id)
        if orphan_src is None:
            return sid
        if threading.current_thread() is self._supervisor:
            # Already on the control plane (failover/migration re-wiring
            # resolving its own routes): posting a job to ourselves and
            # waiting would deadlock — run the adoption directly.
            self._adopt(doc_id)
        else:
            self._control(lambda: self._adopt(doc_id))
        sid, _ = self._route_probe(doc_id)
        return sid

    def _shard(self, shard_id: str) -> ShardHandle:
        with self._route_lock:
            handle = self._shards.get(shard_id)
        if handle is None:
            raise RpcTransportError(f"no live shard {shard_id!r}")
        return handle

    def _forward_doc(self, method: str, params: dict):
        """Proxy one doc-scoped request to the owning shard, riding
        through at most two topology changes (failover / migration flip)
        by re-resolving and retrying — submits are safe to resend because
        the sequencer dedups by (client, client_seq)."""
        doc_id = params["doc"]
        last: Optional[BaseException] = None
        for _attempt in range(3):
            sid = self._route_ready(doc_id)
            handle = self._shard(sid)
            try:
                return handle.request(method, params)
            except DocRelocatedError as exc:
                last = exc  # stale route: re-resolve through the maps
                self.counters.bump("fd.retries")
            except ShardFencedError as exc:
                last = exc
                self.counters.bump("fd.retries")
                self._control(lambda s=sid: self._check_shard(s))
            except _TRANSPORT_ERRORS as exc:
                last = exc
                self.counters.bump("fd.retries")
                self._control(lambda s=sid: self._check_shard(s))
        raise last

    # -- client-facing server (the pump feeds these) ---------------------------

    def _on_frame(self, session: PumpConnection, frame: dict) -> None:
        # on-loop: runs on the pump thread for EVERY decoded frame — the
        # only permissible work here is handing off to the worker pool
        # (a shard RPC on the loop would stall every connection).
        dispatch = self._dispatch
        if dispatch is None or self._stopping.is_set():
            return
        try:
            dispatch.submit(self._serve_frame, session, frame)
        except RuntimeError:
            pass  # pool shut down mid-teardown: the socket is dying too

    def _serve_frame(self, session: PumpConnection, frame: dict) -> None:
        """Worker-pool entry: serve one request, write the response back
        through the pump.  Responses may interleave across requests of
        one connection — the wire contract matches replies by ``re`` id,
        so per-connection pipelining is free concurrency, not a bug."""
        try:
            session.send_obj(self._respond(session, frame))
        except Exception as exc:  # a response writer must never die mute
            self._mc.logger.send({"eventName": "clientSessionError",
                                  "error": str(exc)})

    def _drop_session(self, session: PumpConnection) -> None:
        with self._route_lock:
            for doc_id in session.subscribed:
                subs = self._subs.get(doc_id)
                if subs and session in subs:
                    subs.remove(session)

    def _respond(self, session: PumpConnection, frame: dict) -> dict:
        rid = frame.get("id")
        if frame.get("v", 1) > WIRE_VERSION:
            return {"v": WIRE_VERSION, "re": rid, "ok": False,
                    "error": f"unsupported wire version {frame.get('v')}"}
        self.counters.bump("fd.requests")
        try:
            result = self._handle_method(session, frame.get("method"),
                                         frame.get("params", {}))
            return {"v": WIRE_VERSION, "re": rid, "ok": True,
                    "result": result}
        except NackError as nack:
            body = {"retryAfter": nack.retry_after,
                    "reason": nack.reason, "code": nack.code}
            if nack.admission is not None:
                body["admission"] = nack.admission
            return {"v": WIRE_VERSION, "re": rid, "ok": False,
                    "error": nack.reason, "nack": body}
        except DocRelocatedError as dr:
            return {"v": WIRE_VERSION, "re": rid, "ok": False,
                    "error": str(dr), "code": "wrongShard",
                    "doc": dr.doc_id}
        except ShardFencedError as sf:
            return {"v": WIRE_VERSION, "re": rid, "ok": False,
                    "error": str(sf), "code": "shardFenced",
                    "doc": sf.doc_id}
        except RpcError as exc:
            out = {"v": WIRE_VERSION, "re": rid, "ok": False,
                   "error": str(exc)}
            epoch = getattr(exc, "server_epoch", None)
            if epoch is not None:
                out["code"] = "epochMismatch"
                out["epoch"] = epoch
            return out
        except Exception as exc:  # surfaced to the client, like the server
            return {"v": WIRE_VERSION, "re": rid, "ok": False,
                    "error": str(exc), "code": "internal"}

    def _handle_method(self, session: PumpConnection, method: str,
                       params: dict):
        if method == "ping":
            return "pong"
        if method == "auth":
            return True  # tenancy lives on the single-server shape
        if method == "stats":
            return self.stats()
        if method == "locate":
            sid = self._route_ready(params["doc"])
            handle = self._shard(sid)
            return {"shard": sid, "host": handle.addr[0],
                    "port": handle.addr[1]}
        if method == "heads":
            return self.heads(list(params.get("docs") or ()))
        if method == "log_contiguous" and "docs" in params:
            return self.contiguous(list(params["docs"]))
        if method == "submit_mixed":
            return self._submit_mixed(params)
        if method == "catchup":
            return self._catchup(params)
        if method == "read_summary":
            # content-addressed + shared store: any live shard serves it
            return self._shard(self.router.alive()[0]).request(
                "read_summary", params)
        if method == "subscribe_doc":
            return self._subscribe(session, params)
        if method == "create_document":
            result = self._forward_doc(method, params)
            with self._route_lock:
                self._docs.add(params["doc"])
            return result
        if "doc" in params:
            return self._forward_doc(method, params)
        raise ValueError(f"unknown method {method!r}")

    # -- bulk routes -----------------------------------------------------------

    def _group_by_owner(self, doc_ids) -> Dict[str, List[str]]:
        """THE bulk-route fan-out grouping: documents by their
        (adoption-resolved) owning shard — one definition point so every
        bulk route routes, and lazily adopts, identically."""
        groups: Dict[str, List[str]] = {}
        for doc_id in doc_ids:
            groups.setdefault(self._route_ready(doc_id), []).append(doc_id)
        return groups

    def heads(self, doc_ids: List[str]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for sid, docs in sorted(self._group_by_owner(doc_ids).items()):
            out.update(self._shard(sid).request("heads", {"docs": docs}))
        return out

    def contiguous(self, doc_ids: List[str]) -> Dict[str, bool]:
        """Bulk per-doc seq-contiguity, grouped by owning shard."""
        out: Dict[str, bool] = {}
        for sid, docs in sorted(self._group_by_owner(doc_ids).items()):
            out.update(self._shard(sid).request("log_contiguous",
                                                {"docs": docs}))
        return out

    def _catchup(self, params: dict) -> dict:
        doc_ids = params.get("docs")
        if doc_ids is None:
            with self._route_lock:
                doc_ids = sorted(self._docs)
        groups = self._group_by_owner(doc_ids)
        merged = {"docs": {}, "skipped": [], "deviceDocs": 0, "cpuDocs": 0,
                  "cache": None, "deltaCache": None, "lane": None,
                  "lanes": {}, "degraded": []}
        for sid, docs in sorted(groups.items()):
            part = self._shard(sid).request(
                "catchup", dict(params, docs=docs))
            merged["docs"].update(part.get("docs", {}))
            merged["skipped"].extend(part.get("skipped", ()))
            merged["deviceDocs"] += part.get("deviceDocs", 0)
            merged["cpuDocs"] += part.get("cpuDocs", 0)
            merged["degraded"].extend(part.get("degraded", ()))
            merged["lanes"][sid] = part.get("lane")
        merged["skipped"] = sorted(merged["skipped"])
        merged["degraded"] = sorted(merged["degraded"])
        # One summary lane for single-shard callers; the per-shard split
        # stays in "lanes".  Worst lane wins: any degraded answer makes
        # the merged answer degraded (a stale doc is in there somewhere).
        lanes = set(merged["lanes"].values())
        merged["lane"] = ("degraded" if "degraded" in lanes
                          else "fold" if "fold" in lanes
                          else "warm" if lanes else None)
        return merged

    def _submit_mixed(self, params: dict) -> Dict[str, dict]:
        """Fan one client batch out to the owning shards: boxed op lists
        forward as-is, the columnar batch is row-sliced per shard
        (``ColumnBatch.take``) so each shard stamps exactly its
        documents' rows under ONE group commit of ITS log.  A shard dying
        mid-call reports its documents with ``consumed=-1`` ("unknown —
        re-read the durable head"); the whole-batch resubmit contract
        plus seq dedup make the retry safe."""
        batches = params.get("batches") or {}
        doc_rows = params.get("doc_rows") or {}
        batch = (decode_column_batch(params["columns"])
                 if params.get("columns") is not None else None)
        groups = self._group_by_owner(sorted(set(batches) | set(doc_rows)))
        out: Dict[str, dict] = {}
        for sid in sorted(groups):
            boxed = [d for d in groups[sid] if d in batches]
            row_docs = [d for d in groups[sid] if d in doc_rows]
            payload: dict = {
                "batches": {d: batches[d] for d in boxed}}
            if row_docs:
                ranges = sorted(
                    (int(doc_rows[d][0]), int(doc_rows[d][1]), d)
                    for d in row_docs)
                rows = np.concatenate([
                    np.arange(s, e, dtype=np.int64) for s, e, _d in ranges])
                sub_rows: Dict[str, list] = {}
                at = 0
                for s, e, d in ranges:
                    sub_rows[d] = [at, at + (e - s)]
                    at += e - s
                payload["columns"] = encode_column_batch(batch.take(rows))
                payload["doc_rows"] = sub_rows
            handle = self._shard(sid)
            try:
                out.update(handle.request("submit_mixed", payload))
            except _TRANSPORT_ERRORS as exc:
                self._control(lambda s=sid: self._check_shard(s))
                for d in groups[sid]:
                    out[d] = {"stamped": 0, "consumed": -1,
                              "error": f"shard died mid-batch: {exc}",
                              "code": "shardDead"}
        return out

    # -- broadcast relay -------------------------------------------------------

    def _subscribe(self, session: PumpConnection, params: dict) -> int:
        doc_id = params["doc"]
        head = self._ensure_tap(doc_id)
        with self._route_lock:
            subs = self._subs.setdefault(doc_id, [])
            if session not in subs:
                subs.append(session)
            # Under the lock: _drop_session and _demote_relay iterate /
            # mutate this set cross-thread, and pool dispatch means even
            # one connection's own subscribes run on arbitrary workers.
            session.subscribed.add(doc_id)
        return head

    def _ensure_tap(self, doc_id: str) -> int:
        """Subscribe the FRONT DOOR on the owning shard (once per
        (shard, doc)): op/signal events relay serialize-once to every
        subscribed client session."""
        sid = self._route_ready(doc_id)
        handle = self._shard(sid)
        with self._route_lock:
            register = (sid, doc_id) not in self._tap_registered
            if register:
                self._tap_registered.add((sid, doc_id))
        if register and handle.rpc is not None:
            handle.rpc.on("op", doc_id, self._relay_event)
            handle.rpc.on("signal", doc_id, self._relay_event)
            handle.rpc.on("demoted", doc_id, self._relay_demoted)
        return handle.request("subscribe_doc", {"doc": doc_id})

    def _relay_event(self, frame: dict) -> None:
        doc_id = frame.get("doc", "")
        with self._route_lock:
            sessions = list(self._subs.get(doc_id, ()))
        if not sessions:
            return
        self.counters.bump("fd.events")
        data = frame_bytes(frame)  # ONE encode for every client session
        for session in sessions:
            if not session.relay(data):
                self._demote_relay(session, doc_id)

    def _demote_relay(self, session: PumpConnection, doc_id: str) -> None:
        """Per-client relay flow control tripped: remove the
        laggard session from this document's fan-out and tell it once —
        the client driver re-subscribes and gap-repairs from durable
        deltas, the exact broadcaster demotion contract (SEMANTICS.md
        "Delivery and backpressure") applied at the front-door hop.
        The session's OTHER documents are untouched (it may be current
        on them), and no other session ever waits on the laggard."""
        with self._route_lock:
            subs = self._subs.get(doc_id)
            if subs is None or session not in subs:
                return  # already demoted by a racing relay fan-out
            subs.remove(session)
            # Under the lock, like every touch of session.subscribed
            # (_subscribe adds, _drop_session iterates — all
            # cross-thread once frames dispatch to a pool).
            session.subscribed.discard(doc_id)
        self.counters.bump("fd.relay_demotions")
        session.relay_priority(frame_bytes(
            {"v": WIRE_VERSION, "event": "demoted", "doc": doc_id,
             "head": 0}))

    def _relay_demoted(self, frame: dict) -> None:
        """The shard's broadcaster demoted the FRONT DOOR (we lagged):
        forward the demotion — each client's driver re-subscribes
        (re-requesting our upstream subscribe_doc) and gap-repairs from
        durable deltas, the exact single-server recovery path.  Handler
        registrations stay (``_tap_registered``): they belong to the
        connection, and re-adding them on re-subscribe would
        double-deliver every later event.  Rides the priority relay
        path: a demotion notice must reach even a budget-saturated
        client."""
        doc_id = frame.get("doc", "")
        with self._route_lock:
            sessions = list(self._subs.get(doc_id, ()))
        data = frame_bytes(frame)
        for session in sessions:
            session.relay_priority(data)

    def _retap(self, doc_id: str, head: int) -> None:
        """Failover/migration re-wiring: move the upstream tap to the
        document's current owner and push a ``fence`` event so pinned
        clients unpin proactively (byte-compatible with the in-proc
        tier's fence push)."""
        self._ensure_tap(doc_id)
        with self._route_lock:
            sessions = list(self._subs.get(doc_id, ()))
        frame = {"v": WIRE_VERSION, "event": "fence", "doc": doc_id,
                 "epoch": self.epoch, "head": head}
        data = frame_bytes(frame)
        for session in sessions:
            # Control frame: budget-exempt — a fenced client must learn
            # the new epoch even when its relay queue is saturated.
            session.relay_priority(data)

    # -- supervision: death detection + failover -------------------------------

    def poll_shards(self) -> List[str]:
        """Synchronous death-detection sweep (tests, tick harnesses):
        every unresponsive live shard fails over NOW.  Returns the shard
        ids that were failed over."""
        with self._route_lock:
            candidates = [(sid, h) for sid, h in self._shards.items()
                          if sid not in self.router.dead()]
        failed = []
        for sid, handle in candidates:
            if not handle.alive() or not handle.ping():
                self.counters.bump("fd.heartbeat_failures")
                self._control(lambda s=sid: self._failover(s))
                failed.append(sid)
        return failed

    def _heartbeat_loop(self) -> None:
        while not self._stopping.wait(self._heartbeat_interval):
            with self._route_lock:
                candidates = [(sid, h) for sid, h in self._shards.items()
                              if sid not in self.router.dead()]
            for sid, handle in candidates:
                if self._stopping.is_set():
                    return
                if not handle.alive() or not handle.ping():
                    self.counters.bump("fd.heartbeat_failures")
                    self._control(lambda s=sid: self._failover(s),
                                  wait=False)

    def fail_shard(self, shard_id: str) -> List[str]:
        """Kill one shard process and fail it over (test/chaos API)."""
        return self._control(lambda: self._kill_and_failover(shard_id))

    def fence_token(self, shard_id: str) -> str:
        """Deterministic fence epoch — the SAME derivation as the
        in-proc tier's (shared helper: cross-tier byte parity)."""
        return fence_token(self.epoch or "", shard_id)

    def _check_shard(self, shard_id: str) -> None:
        """Supervisor-side trouble report: transient errors are ignored;
        a dead/unresponsive shard fails over exactly once."""
        with self._route_lock:
            handle = self._shards.get(shard_id)
            already_dead = shard_id in self.router.dead()
        if handle is None or already_dead:
            return
        if handle.alive() and handle.ping():
            return
        self._failover(shard_id)

    def _kill_and_failover(self, shard_id: str) -> List[str]:
        alive = self.router.alive()
        if shard_id in alive and len(alive) <= 1:
            # Same contract as the in-proc tier's kill_shard: the last
            # live shard is unkillable — refuse BEFORE the SIGKILL, or
            # the refusal would come from mark_dead with the process
            # already dead and the tier unroutable.
            raise RuntimeError("cannot kill the last live shard")
        with self._route_lock:
            handle = self._shards.get(shard_id)
        if handle is not None:
            handle.kill()
        return self._failover(shard_id)

    def _routes_of(self, shard_id: str) -> List[str]:
        with self._route_lock:
            return sorted(
                d for d in self._docs
                if (self._overrides.get(d) or self.router.owner(d))
                == shard_id)

    def _apply_failover_routes(self, shard_id: str,
                               affected: List[str]) -> List[str]:
        """One critical section: orphan every affected doc (keeping an
        EARLIER orphan source — its log still holds the history), drop
        overrides pointing at the corpse, and snapshot the subscribed
        docs that need eager adoption."""
        with self._route_lock:
            for doc_id in affected:
                self._orphans.setdefault(doc_id, shard_id)
            for doc_id, sid in list(self._overrides.items()):
                if sid == shard_id:
                    self._overrides.pop(doc_id)
            for key in list(self._tap_registered):
                if key[0] == shard_id:
                    self._tap_registered.discard(key)
            self.fences += 1
            return [d for d in affected if self._subs.get(d)]

    def _failover(self, shard_id: str) -> List[str]:
        """Supervisor-only.  The epoch-fenced failover: SIGKILL the
        victim (process death IS the fence — a hung process must never
        wake up and extend a re-owned document's log), flip the router,
        orphan the dead shard's documents FIRST (the step everything
        else can heal from — it must never be skipped by a later
        failure), then bump the fence epoch on every survivor and
        eagerly adopt + re-wire the live-subscribed documents.  Every
        post-orphaning step is individually fault-isolated: a survivor
        that fails its epoch bump gets its own trouble check, a doc
        whose eager adoption fails keeps its orphan mark (the next
        touch retries) — a SECOND fault mid-failover degrades, never
        silently loses durable history."""
        with self._route_lock:
            handle = self._shards.get(shard_id)
            already_dead = shard_id in self.router.dead()
            routed = shard_id in self.router.shard_ids()
        if handle is None or already_dead:
            return []
        if not routed:
            # A pending migration target (spawned, not yet joined to the
            # router) died: nothing rendezvous-routes to it, but flipped
            # docs may override to it — re-orphan those from ITS log.
            self._abort_pending_shard(shard_id)
            return []
        alive = self.router.alive()
        if shard_id in alive and len(alive) <= 1:
            # The LAST live shard missed a probe (GC pause, disk stall):
            # SIGKILLing it would turn a stall into a total outage with
            # no adoption target.  Refuse BEFORE the kill — mark_dead
            # would refuse anyway, but only after the process was gone.
            self._mc.logger.send({
                "eventName": "lastShardUnfailable", "shard": shard_id})
            return []
        handle.kill()
        handle.close()
        affected = self._routes_of(shard_id)
        self.router.mark_dead(shard_id)  # raises on the last live shard
        subscribed = self._apply_failover_routes(shard_id, affected)
        self.counters.bump("fd.failovers")
        token = self.fence_token(shard_id)
        with self._route_lock:
            survivors = [(sid, h) for sid, h in self._shards.items()
                         if sid != shard_id
                         and sid not in self.router.dead()]
        new_epoch = self.epoch
        for sid, survivor in survivors:
            try:
                new_epoch = survivor.request("bump_epoch",
                                             {"token": token})
            except (RpcError, OSError, ConnectionError) as exc:
                # The survivor may itself be dying: its own failover will
                # re-route its documents; the missed (deterministic)
                # bump only widens the stale-pin window, never forks.
                self._mc.logger.send({
                    "eventName": "epochBumpFailed", "shard": sid,
                    "error": str(exc)})
        self.epoch = new_epoch
        for doc_id in subscribed:
            try:
                head = self._adopt(doc_id)
                self._retap(doc_id, head)
            except (RpcError, OSError, ConnectionError) as exc:
                # Orphan mark survives (only cleared on adopt success):
                # the next touch re-runs the adoption.
                self._mc.logger.send({
                    "eventName": "eagerAdoptFailed", "doc": doc_id,
                    "error": str(exc)})
        return affected

    def _abort_pending_shard(self, shard_id: str) -> None:
        """A shard that never joined the router died (migration target):
        kill the handle and re-orphan every doc flipped to it — its log
        holds their live spans."""
        with self._route_lock:
            handle = self._shards.pop(shard_id, None)
            flipped = [d for d, s in self._overrides.items()
                       if s == shard_id]
            for doc_id in flipped:
                self._overrides.pop(doc_id)
                self._orphans.setdefault(doc_id, shard_id)
            for key in list(self._tap_registered):
                if key[0] == shard_id:
                    self._tap_registered.discard(key)
        if handle is not None:
            handle.kill()
            handle.close()

    def _adopt(self, doc_id: str) -> int:
        """Supervisor-only: import an orphaned document's span from the
        dead source's log into its new owner.  Idempotent; returns the
        owner's durable head."""
        with self._route_lock:
            source = self._orphans.get(doc_id)
            sid = self._overrides.get(doc_id) or self.router.owner(doc_id)
        handle = self._shard(sid)
        if source is None:
            return handle.request("heads", {"docs": [doc_id]})[doc_id]
        # Any FAILURE keeps the orphan mark (a later touch retries) —
        # only an explicit verdict may clear it: either a successful
        # import, or the shard's structured "nothing durable existed"
        # answer (created-but-empty doc died with its shard; in-proc
        # parity is that the document simply no longer exists).  A
        # corrupt-object or replay error must NEVER be mistaken for
        # nothing-durable: that would silently abandon real history.
        result = handle.request("adopt_doc",
                                {"doc": doc_id, "from_shard": source})
        self._orphan_adopted(doc_id, source)
        if result.get("nothing"):
            self._mc.logger.send({
                "eventName": "adoptNothingDurable", "doc": doc_id,
                "from": source})
            return 0
        self.counters.bump("fd.adoptions")
        return result["head"]

    def _orphan_adopted(self, doc_id: str, source: str) -> None:
        """Clear the orphan mark — re-validated under the lock: only the
        exact source the adoption imported from is cleared, so a
        concurrent re-orphaning (the adopter itself died mid-call) is
        never wiped by a stale success."""
        with self._route_lock:
            if self._orphans.get(doc_id) == source:
                self._orphans.pop(doc_id)

    # -- fault-plan driver (deterministic harnesses) ---------------------------

    def _victim_of(self, point) -> Optional[str]:
        if point.shard is not None:
            victim = point.shard
        elif point.doc is not None:
            victim = self._route_probe(point.doc)[0]
        else:
            alive = self.router.alive()
            victim = alive[0] if alive else None
        if (victim is None or victim in self.router.dead()
                or len(self.router.alive()) <= 1):
            return None
        return victim

    def tick(self, now: int) -> List[str]:
        """Execute every scheduled ``proc.kill`` / ``proc.hang`` /
        ``shard.kill`` fault point whose virtual tick arrived (the
        harness step driver — same surface as the in-proc sharded tier).
        A hang SIGSTOPs the victim now; its death is only DETECTED
        ``hang_detect_ticks`` later (the heartbeat model), at which point
        the front door SIGKILLs the stopped process and fails over."""
        if self._faults is None:
            return []
        affected: List[str] = []
        for point in self._faults.due("proc.hang", now):
            victim = self._victim_of(point)
            if victim is None or victim in self._hang_pending:
                self._faults.mark_unfired(point)
                continue
            self._control(lambda v=victim: self._shard(v).hang())
            self.counters.bump("fd.hangs")
            self._hang_pending[victim] = now + self.hang_detect_ticks
        for site in ("proc.kill", "shard.kill"):
            for point in self._faults.due(site, now):
                victim = self._victim_of(point)
                if victim is None:
                    self._faults.mark_unfired(point)
                    continue
                affected.extend(self._control(
                    lambda v=victim: self._kill_and_failover(v)))
        for sid, deadline in sorted(self._hang_pending.items()):
            if deadline > now:
                continue
            alive = self.router.alive()
            if sid in alive and len(alive) <= 1:
                # The hung shard is the last one alive: failing it over
                # is impossible — KEEP the entry pending so a later tick
                # (after capacity returns via add_shard) still shoots it.
                continue
            self._hang_pending.pop(sid)
            affected.extend(self._control(
                lambda v=sid: self._kill_and_failover(v)))
        return affected

    # -- live migration (add_shard) --------------------------------------------

    def set_crash_hook(self, fn: Optional[Callable[[str, str], None]]
                       ) -> None:
        """Test instrument: ``fn(step, doc)`` runs immediately before
        every migration step (steps: freeze, transfer, import, flip,
        resume) — crash-point suites kill a shard there and assert the
        protocol converges."""
        self._crash_hook = fn

    def _crash_point(self, step: str, doc_id: str) -> None:
        if self._crash_hook is not None:
            self._crash_hook(step, doc_id)

    def add_shard(self, shard_id: Optional[str] = None) -> dict:
        """Spawn a new shard process and LIVE-migrate the ~1/N documents
        rendezvous assigns it — freeze → transfer → import → flip →
        resume per document — then join it to the router.  Raises
        :class:`MigrationAborted` (with every frozen doc thawed) if the
        new shard dies mid-migration."""
        return self._control(lambda: self._add_shard_job(shard_id))

    def _new_shard_id(self) -> str:
        existing = set(self.router.shard_ids())
        while True:
            sid = f"shard{self._next_ordinal:02d}"
            self._next_ordinal += 1
            if sid not in existing:
                return sid

    def _add_shard_job(self, shard_id: Optional[str]) -> dict:
        sid = shard_id if shard_id is not None else self._new_shard_id()
        handle = self._spawn(sid)
        with self._route_lock:
            self._shards[sid] = handle
            docs = sorted(self._docs)
        future = self.router.alive() + [sid]
        movers = [d for d in docs if self._owner_for(d, future) == sid]
        moved: List[str] = []
        try:
            for doc_id in movers:
                if self._migrate_doc(doc_id, sid):
                    moved.append(doc_id)
        except MigrationAborted:
            self._abort_add_shard(sid, moved)
            raise
        self.router.add_shard(sid)
        with self._route_lock:
            # rendezvous now agrees with every override pointing at the
            # new shard — the overrides are redundant, not load-bearing.
            for doc_id in moved:
                self._overrides.pop(doc_id, None)
        return {"shard": sid, "moved": moved,
                "docs": len(docs), "movers": len(movers)}

    def _abort_add_shard(self, sid: str, moved: List[str]) -> None:
        """The new shard died mid-migration.  Docs already flipped to it
        are orphaned from ITS log (their live span is there); the rest
        never left their sources.  The would-be shard never joins the
        router."""
        with self._route_lock:
            handle = self._shards.pop(sid, None)
            for doc_id in moved:
                self._overrides.pop(doc_id, None)
                self._orphans.setdefault(doc_id, sid)
            subscribed = [d for d in moved if self._subs.get(d)]
        if handle is not None:
            handle.kill()
            handle.close()
        for doc_id in subscribed:
            try:
                head = self._adopt(doc_id)
                self._retap(doc_id, head)
            except (RpcError, OSError, ConnectionError) as exc:
                # Same per-doc isolation as _failover's eager loop: the
                # orphan mark survives, the next touch retries.
                self._mc.logger.send({
                    "eventName": "abortAdoptFailed", "doc": doc_id,
                    "error": str(exc)})

    def _migrate_doc(self, doc_id: str, target_sid: str) -> bool:
        """One document's live migration; supervisor-only.  Returns True
        when the doc ended up on the target.  Source death at any step
        degrades to the failover path (+ one retry from the adopted
        owner); target death raises :class:`MigrationAborted` after
        thawing the frozen source."""
        for _attempt in range(2):
            with self._route_lock:
                src_sid = (self._overrides.get(doc_id)
                           or self.router.owner(doc_id))
            if src_sid == target_sid:
                return True
            src = self._shard(src_sid)
            dst = self._shard(target_sid)
            frozen = None
            try:
                self._crash_point("freeze", doc_id)
                frozen = src.request("freeze_doc", {"doc": doc_id})
                self._crash_point("transfer", doc_id)
                span = src.request("export_doc", {"doc": doc_id})
                self._crash_point("import", doc_id)
                dst.request("import_doc", {
                    "doc": doc_id, "records": span["records"],
                    "checkpoint": frozen["checkpoint"]})
                self._crash_point("flip", doc_id)
            except _TRANSPORT_ERRORS as exc:
                if not (dst.alive() and dst.ping()):
                    # Target died: thaw the source (the doc never left)
                    # and abort the whole expansion.
                    if frozen is not None and src.alive():
                        src.request("thaw_doc", {"doc": doc_id})
                    raise MigrationAborted(
                        f"target shard {target_sid} died migrating "
                        f"{doc_id!r}: {exc}") from exc
                # Source died pre-flip: ordinary failover re-owns the
                # doc from the dead log; retry the migration from there.
                self._check_shard(src_sid)
                self._adopt(doc_id)
                continue
            subscribed = self._flip_doc(doc_id, src_sid, target_sid)
            self.counters.bump("fd.migrations")
            self._crash_point("resume", doc_id)
            try:
                if subscribed:
                    self._retap_migrated(doc_id)
            except (RpcError, OSError, ConnectionError) as exc:
                if not (dst.alive() and dst.ping()):
                    # Target died AFTER the flip: its log already holds
                    # the doc's live span — re-orphan it from there
                    # (exactly what _abort_add_shard does for earlier
                    # movers) and abort the expansion.
                    self._unflip_to_orphan(doc_id, target_sid)
                    raise MigrationAborted(
                        f"target shard {target_sid} died resuming "
                        f"{doc_id!r}: {exc}") from exc
                # Transient re-tap failure on a live target: the client
                # drivers' own demote/re-subscribe path self-heals.
                self._mc.logger.send({
                    "eventName": "migrationRetapFailed", "doc": doc_id,
                    "error": str(exc)})
            try:
                src.request("retire_doc", {"doc": doc_id})
                self._purge_tap(src_sid, doc_id, src)
            except _TRANSPORT_ERRORS as exc:
                # Post-flip source death: its OTHER docs fail over
                # normally; this doc already lives on the target.
                self._mc.logger.send({
                    "eventName": "retireAfterFlipFailed", "doc": doc_id,
                    "shard": src_sid, "error": str(exc)})
                self._check_shard(src_sid)
            return True
        raise MigrationAborted(
            f"could not migrate {doc_id!r} to {target_sid}: source kept "
            "dying")

    def _unflip_to_orphan(self, doc_id: str, dead_target: str) -> None:
        """Undo a flip whose target died: route falls back to rendezvous
        and the doc adopts from the dead target's log (the live span is
        there — the import landed before the flip)."""
        with self._route_lock:
            self._overrides.pop(doc_id, None)
            self._orphans.setdefault(doc_id, dead_target)

    def _purge_tap(self, shard_id: str, doc_id: str,
                   handle: ShardHandle) -> None:
        """Migration hygiene: drop the source-side tap bookkeeping and
        event handlers for a doc that moved away — only failover's
        by-shard purge cleaned these before, so long-lived tiers rotted
        a registration per migrated subscribed doc."""
        with self._route_lock:
            self._tap_registered.discard((shard_id, doc_id))
        if handle.rpc is not None:
            handle.rpc.off("op", doc_id, self._relay_event)
            handle.rpc.off("signal", doc_id, self._relay_event)
            handle.rpc.off("demoted", doc_id, self._relay_demoted)

    def _flip_doc(self, doc_id: str, src_sid: str,
                  target_sid: str) -> bool:
        """The migration commit point, one critical section: route the
        document to the target and record the move.  Returns whether the
        doc has live subscriptions (the caller re-wires broadcast)."""
        with self._route_lock:
            self._overrides[doc_id] = target_sid
            self.migrations.append((doc_id, src_sid, target_sid))
            return bool(self._subs.get(doc_id))

    def _retap_migrated(self, doc_id: str) -> None:
        """Migration resume for a live-subscribed doc: move the tap; no
        fence event — migration does not change the storage generation
        (summaries are content-addressed and shared), so clients keep
        every cache."""
        self._ensure_tap(doc_id)

    # -- introspection ---------------------------------------------------------

    def doc_ids(self) -> List[str]:
        with self._route_lock:
            return sorted(self._docs)

    def shard_addrs(self) -> Dict[str, Tuple[str, int]]:
        """(host, port) per live shard — what an attach replica needs to
        supervise the same fleet (``FrontDoor(spawn="attach",
        attach_addrs=primary.shard_addrs())``)."""
        with self._route_lock:
            dead = set(self.router.dead())
            return {sid: handle.addr
                    for sid, handle in sorted(self._shards.items())
                    if sid not in dead}

    def stats(self) -> dict:
        with self._route_lock:
            handles = sorted(self._shards.items())
            migrations = list(self.migrations)
            fences = self.fences
        pump = self._pump
        sessions = pump.connections() if pump is not None else []
        shards = {}
        for sid, handle in handles:
            if sid in self.router.dead() or not handle.alive():
                shards[sid] = {"dead": True}
                continue
            try:
                # Bounded like a probe: an undetected-hung (SIGSTOPped)
                # shard must not stall the whole stats call for the full
                # request timeout.
                shards[sid] = handle.request(
                    "stats", {}, timeout=min(self.request_timeout, 5.0))
            except (RpcError, OSError, ConnectionError) as exc:
                shards[sid] = {"error": str(exc)}
        # Supervisor-view rollup: each shard host
        # snapshots its catchup admission counters locally, but an
        # operator watching a storm needs the TIER's overload picture in
        # one place — sum every live shard's admission counters here.
        admission: Dict[str, int] = {}
        for per_shard in shards.values():
            for key, value in (per_shard.get("admission") or {}).items():
                admission[key] = admission.get(key, 0) + int(value)
        return {
            "shards": shards,
            "alive": self.router.alive(),
            "dead": self.router.dead(),
            "router_version": self.router.version,
            "epoch": self.epoch,
            "fences": fences,
            "migrations": [list(m) for m in migrations],
            "counters": self.counters.snapshot(),
            "admission": admission,
            # per-client relay flow control health: live client
            # sessions, bytes currently queued across them, the
            # per-session budget (demotions are in counters).
            "relay": {
                "sessions": len(sessions),
                "pending_bytes": sum(s.relay_pending()
                                     for s in sessions),
                "budget_per_session": self.relay_budget,
            },
            # connection-layer health (the event-loop pump)
            "pump": {
                "accepted": pump.accepted if pump is not None else 0,
                "dropped": pump.dropped if pump is not None else 0,
                "open": len(sessions),
            },
        }


def _raise_nofile_limit() -> None:
    """Best-effort: lift the soft fd limit to the hard cap.  The
    connection-scale gate (tools/loadgen.py --connections) needs every
    fd the container will give one process; the HARD cap is a kernel/
    container fact this process cannot raise, so the bench records it
    honestly instead."""
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="fluidproc front door: routing + shard supervision "
                    "over real shard-host processes")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--heartbeat", type=float, default=1.0,
                        help="heartbeat interval in seconds (death "
                             "detection); 0 disables")
    parser.add_argument("--spawn", choices=("proc", "thread"),
                        default="proc",
                        help="shard backend: real processes, or "
                             "in-process servers (connection-scale "
                             "benches measure ONE process this way)")
    parser.add_argument("--relay-budget", type=int, default=4 << 20,
                        help="per-client broadcast relay byte budget")
    parser.add_argument("--shard-arg", action="append", default=[],
                        help="extra CLI arg forwarded to every spawned "
                             "shard-host process (repeatable)")
    parser.add_argument("--device", default="cuda",
                        help="the device every shard folds its catch-ups "
                             "on (default 'cuda'; 'cpu' runs the plain "
                             "folds on the host).  Checked at start: "
                             "without a CUDA device the default refuses "
                             "to start")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))
    _raise_nofile_limit()
    door = FrontDoor(
        args.dir, n_shards=args.shards, spawn=args.spawn, host=args.host,
        port=args.port,
        heartbeat_interval=args.heartbeat if args.heartbeat > 0 else None,
        relay_budget=args.relay_budget,
        shard_args=args.shard_arg, device=device,
    )
    door.start()
    print(f"frontdoor listening on {door.host}:{door.port} "
          f"shards={door.router.alive()} pid={os.getpid()}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        door.close()


if __name__ == "__main__":
    main()
