"""loadgen: drive fluidscale swarm scenarios and record per-scenario
perf gates.

The CLI front end of ``testing/scenarios.py``: each named scenario is a
replay-deterministic swarm — 10³ to 10⁶ columnar virtual clients whose
every op flows through the REAL sharded ordering tier's batched ingress,
the serialize-once broadcaster, and the durable op log.  A scenario only
PASSES when it sustains its ops/sec floor, its sampled documents load
byte-identical to the fault-free single-shard oracle twin, and (with
``--replay-check``) a same-seed re-run reproduces every metric and
telemetry counter bit-identically.

Every catch-up fold of a run happens on ``--device`` (default ``cuda``):
the storm's ``OrderingServer``, the ``FrontDoor`` and its shard processes
(``--device``), the streaming fold and the fold probe's
``CatchupService``.  The device is checked before anything starts:
without a CUDA device the default exits 2 naming it, and ``--device
cpu`` runs the plain folds on the host.

    python -m fluidframework_tpu_torch.tools.loadgen --list
    python -m fluidframework_tpu_torch.tools.loadgen --clients 1000
    python -m fluidframework_tpu_torch.tools.loadgen --scenario \
        catchup-storm --storm --device cuda --out storm.json
    python -m fluidframework_tpu_torch.tools.loadgen --scenario \
        failover-drill --replay-check
    python -m fluidframework_tpu_torch.tools.loadgen --out-of-proc \
        --clients 100000 --replay-check   # the REAL process tier
        # (shard-host processes, per-shard logs, front-door routing;
        # the drill SIGKILLs a real shard process)
    python -m fluidframework_tpu_torch.tools.loadgen --out-of-proc \
        --replicas 2 --replay-check   # every scenario through TWO
        # shared-nothing front-door replicas with the traffic-bearing
        # one SIGKILLed mid-run
    python -m fluidframework_tpu_torch.tools.loadgen --connections \
        100000   # real TCP connection scale against ONE event-loop
        # front-door process, RSS-tripwired per idle connection

Emits ONE JSON document via the shared bench writer: per scenario —
ops/sec (wall), p50/p99 delivery and catch-up latency in VIRTUAL ticks
(schedule distance, deterministic per seed; wall time is not), oracle
and replay verdicts (schema-stable ``null`` when skipped), counter
dumps, and the gate verdict.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from ..ops.mergetree_kernel import resolve_device
from ..testing.scenarios import (
    SCENARIOS, build_scenario, oracle_spec, run_swarm, scenario_docs,
)
from .bench_harness import write_bench_json

#: conservative CPU ops/sec floors per scenario (sequenced messages over
#: wall seconds, swarm + service + broadcaster + durable log end to end).
#: Measured ~30k msgs/s at 10⁵ clients on the dev container; the gate
#: trips on an order-of-magnitude regression (a Python inner loop landing
#: on the batch path), not on host jitter.
GATES_OPS_PER_SEC = {
    "steady-typing": 3000.0,
    "catchup-herd": 3000.0,
    "laggard-window": 3000.0,
    # tree changesets ride the boxed envelope path by design (outside
    # the closed columnar vocabulary), so the floor sits at the boxed
    # rate, not the columnar one.
    "tree-collab": 1000.0,
    # the storm spends its wall on REAL device folds (the whole point),
    # so its ops/sec floor sits well below the pure-ingress scenarios.
    "catchup-storm": 250.0,
    "failover-drill": 2000.0,
}

#: out-of-process floors: every op crosses the wire TWICE (swarm → front
#: door → owning shard process) and heads read back over RPC, so the
#: absolute floor is lower — the gate still trips on an order-of-magnitude
#: regression (a per-op Python loop landing on the proxy fan-out path).
GATES_OPS_PER_SEC_PROC = {
    "steady-typing": 300.0,
    "catchup-herd": 300.0,
    "laggard-window": 300.0,
    "tree-collab": 100.0,
    "catchup-storm": 100.0,
    "failover-drill": 200.0,
}

#: p99 catch-up STORM latency gate, in virtual ticks (deterministic per
#: seed): first attempt → served, across shed pacing and retries.  The
#: herd must drain in bounded schedule time, not just eventually.
STORM_GATE_P99_TICKS = 64.0

#: Streaming-fold gates.  With the streaming fold attached the
#: storm must serve ≥95% of its answers with ZERO fold work (warm +
#: streaming-head lanes); the newest durable summary may trail the head
#: by at most this many fold cadences (polls run once per tick, so one
#: tick's commit burst can stack on top of the cadence); and the
#: truncated on-disk log must be strictly smaller than the untruncated
#: baseline.
STREAM_GATE_SERVE_RATE = 0.95
STREAM_GATE_LAG_CADENCES = 4.0

#: Connection-scale gates (``--connections``).  The bench holds
#: N REAL TCP connections against ONE front-door process and trips when:
#: resident bytes per idle connection exceed the budget (a thread-per-
#: connection regression shows up here first — one thread stack dwarfs
#: a PumpConnection); the server's thread count scales with connections
#: instead of staying a small constant; or a sampled connection stops
#: answering ping.  The fd HEADROOM is what the two processes keep free
#: for everything that is not a herd socket (listen socket, shard RPC
#: connections, logs, stdio) — the achieved count is recorded honestly
#: against the container's NON-RAISABLE hard fd limit (``env_capped``).
CONN_FD_HEADROOM = 512
CONN_RSS_BUDGET_BYTES = 16 * 1024
CONN_MAX_SERVER_THREADS = 64
CONN_PING_SAMPLES = 64


def run_stream(seed: int, clients: int, docs: int, shards: int,
               replay_check: bool = False, *, device="cuda") -> dict:
    """The streaming-fold gate: the catchup-storm scenario twice — once
    with the sequencer-attached streaming fold ON, once OFF — over
    file-backed op logs, asserting (a) byte-identical convergence
    (heads, sampled digests, stamped counts), (b) the herd served
    almost entirely from the warm/streaming-head lanes with cold folds
    collapsed vs the OFF baseline, (c) summary lag bounded by the fold
    cadence, and (d) the on-disk log physically smaller behind the
    summary-anchored truncation.  Every fold runs on ``device``."""
    import tempfile

    def _log_bytes(d: str) -> int:
        path = os.path.join(d, "swarm-ops.jsonl")
        return os.path.getsize(path) if os.path.exists(path) else 0

    spec = build_scenario("catchup-storm", seed=seed, clients=clients,
                          docs=docs, shards=shards)
    with tempfile.TemporaryDirectory(prefix="fluid-stream-") as base:
        spec_off = dataclasses.replace(spec, dir=os.path.join(base, "off"))
        spec_on = dataclasses.replace(spec, dir=os.path.join(base, "on"),
                                      stream=True)
        t0 = time.time()
        r_off = run_swarm(spec_off, device=device)
        wall_off = time.time() - t0
        t0 = time.time()
        r_on = run_swarm(spec_on, device=device)
        wall_on = time.time() - t0
        replay_identical = None
        if replay_check:
            r_on2 = run_swarm(dataclasses.replace(
                spec_on, dir=os.path.join(base, "on2")), device=device)
            replay_identical = r_on2.identity() == r_on.identity()
        bytes_off = _log_bytes(spec_off.dir)
        bytes_on = _log_bytes(spec_on.dir)

    s_off, s_on = r_off.storm, r_on.storm
    sf = s_on.get("streamfold") or {}
    converged = (r_on.per_doc_head == r_off.per_doc_head
                 and r_on.sampled_digests == r_off.sampled_digests
                 and r_on.ops_stamped == r_off.ops_stamped)
    served = int(s_on.get("served") or 0)
    no_fold = int(s_on.get("warm") or 0) + int(s_on.get("stream") or 0)
    serve_rate = round(no_fold / served, 4) if served else None
    lag_max = int(sf.get("head_lag_max") or 0)
    lag_gate = int(spec_on.stream_cadence * STREAM_GATE_LAG_CADENCES)
    # The honest before/after-truncation comparison is WITHIN the ON
    # run: final log size vs final size + the bytes compaction dropped.
    # (Comparing against the OFF run's file would charge/credit the
    # marker records and serve-pattern differences, and at small scale
    # marker overhead can exceed the reclaim — a gate artifact, not a
    # regression.)
    reclaimed = int(sf.get("oplog_bytes_reclaimed") or 0)
    untruncated_on = bytes_on + reclaimed
    passed = (
        converged
        and replay_identical is not False
        and s_on.get("served") == s_on.get("requests")
        and s_off.get("served") == s_off.get("requests")
        and serve_rate is not None and serve_rate >= STREAM_GATE_SERVE_RATE
        and lag_max <= lag_gate
        and int(sf.get("truncated_msgs") or 0) > 0
        and 0 < bytes_on < untruncated_on
    )
    return {
        "seed": seed,
        "clients": clients,
        "docs": docs,
        "shards": shards,
        "stream_cadence": spec_on.stream_cadence,
        "stream_retention": spec_on.stream_retention,
        "sequenced_ops": r_on.sequenced_ops,
        "wall_sec_on": round(wall_on, 3),
        "wall_sec_off": round(wall_off, 3),
        # steady streaming throughput: committed ops folded by the
        # streaming service per wall second of the ON run
        "stream_ops_folded_per_sec": (
            round(int(sf.get("ops_folded") or 0) / wall_on, 1)
            if wall_on > 0 else 0.0),
        # newest-durable-summary lag high-water, in sequence numbers
        # (== virtual schedule distance; nothing here reads wall clock)
        "stream_summary_lag_max_seqs": lag_max,
        "stream_lag_gate_seqs": lag_gate,
        # storm lanes, on vs off: the herd must land on warm/stream with
        # streaming attached, on warm/fold without
        "stream_serve_rate": serve_rate,
        "gate_serve_rate": STREAM_GATE_SERVE_RATE,
        "stream_serves_on": int(s_on.get("stream") or 0),
        "warm_serves_on": int(s_on.get("warm") or 0),
        "cold_folds_on": int(s_on.get("folds") or 0),
        "warm_serves_off": int(s_off.get("warm") or 0),
        "cold_folds_off": int(s_off.get("folds") or 0),
        "storm_requests": int(s_on.get("requests") or 0),
        "storm_served": served,
        # summary-anchored truncation: the ON run's final log size vs
        # what it would be without truncation (final + reclaimed); the
        # OFF run's file rides along for context only
        "oplog_bytes_off": bytes_off,
        "oplog_bytes_on": bytes_on,
        "oplog_bytes_untruncated_on": untruncated_on,
        "oplog_bytes_reclaimed": reclaimed,
        "oplog_bytes_reclaimed_ratio": (
            round(reclaimed / untruncated_on, 4)
            if untruncated_on else None),
        "truncations": int(sf.get("truncations") or 0),
        "truncated_msgs": int(sf.get("truncated_msgs") or 0),
        "converged_identical": converged,
        "replay_identical": replay_identical,
        "streamfold": sf or None,
        "passed": passed,
    }


def _proc_status(pid: int) -> dict:
    """{rss_bytes, threads} for a live pid from ``/proc`` (Linux); empty
    on platforms without procfs — the tripwire then records null and the
    gate skips the memory leg honestly instead of guessing."""
    out: dict = {}
    try:
        with open(f"/proc/{pid}/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
    except OSError:
        pass
    return out


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        buf += chunk
    return bytes(buf)


def _raw_rpc(sock, method: str, params: dict, rid: int = 1):
    """One request/response round-trip on a raw herd socket, skipping any
    interleaved event frames (replies match by ``re``)."""
    import json
    import struct

    from ..protocol.wire import WIRE_VERSION, frame_bytes

    length = struct.Struct(">I")
    sock.sendall(frame_bytes({"v": WIRE_VERSION, "id": rid,
                              "method": method, "params": params}))
    while True:
        (n,) = length.unpack(_recv_exact(sock, 4))
        frame = json.loads(_recv_exact(sock, n))
        if frame.get("re") == rid:
            if not frame.get("ok"):
                raise RuntimeError(frame.get("error"))
            return frame.get("result")


def run_connections(requested: int, relay_budget: int = 4096,
                    ops: int = 256, *, device="cuda") -> dict:
    """The connection-scale gate: hold ``requested`` REAL TCP
    connections against ONE front-door process (event-loop frame pump,
    in-process shard — the bench measures the CONNECTION layer, not the
    process tier) and assert, concurrently:

    - every sampled connection still answers ``ping`` (liveness under
      load, ``CONN_PING_SAMPLES`` spread across the herd);
    - resident bytes per idle connection stay under
      ``CONN_RSS_BUDGET_BYTES`` (peak RSS over baseline / achieved);
    - the server's thread count stays a small constant
      (``CONN_MAX_SERVER_THREADS``) — the anti-thread-per-connection pin;
    - steady-typing traffic flows end to end through a real driver
      client while the herd is held; and
    - the per-connection relay byte budget is ENFORCED: a deliberately
      never-reading subscriber must be demoted (``fd.relay_demotions``
      >= 1) instead of ballooning the relay queue.

    The container's hard fd limit is not raisable from userspace, so the
    achieved count is ``min(requested, hard - CONN_FD_HEADROOM)`` and the
    report records ``env_capped`` honestly rather than silently passing a
    smaller gate.  The front-door process folds on ``device``.
    """
    import resource
    import shutil
    import socket
    import subprocess
    import tempfile
    import time as _time

    from ..drivers.network_driver import NetworkDocumentServiceFactory
    from ..protocol.messages import MessageType, RawOperation
    from ..runtime.container import ContainerRuntime

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    target = min(requested, max(1, hard - CONN_FD_HEADROOM))
    env_capped = target < requested

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = tempfile.mkdtemp(prefix="fluid-conns-")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.frontdoor",
         "--dir", os.path.join(base, "door"), "--shards", "1",
         "--spawn", "thread", "--port", "0", "--heartbeat", "0",
         "--relay-budget", str(relay_budget),
         "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=repo_root)
    conns: list = []
    extra_socks: list = []
    factory = None
    try:
        host, port, pid = None, None, None
        deadline = _time.time() + 60
        while _time.time() < deadline:
            line = proc.stdout.readline()
            if line == "" and proc.poll() is not None:
                break
            if "listening on" in line:
                addr = line.split("listening on", 1)[1].split()[0]
                host, _, port_s = addr.rpartition(":")
                port = int(port_s)
                pid = int(line.rsplit("pid=", 1)[1].split()[0])
                break
        if port is None:
            raise RuntimeError("front door never reported listening")

        # Steady-typing fixture BEFORE the baseline RSS read, so the RSS
        # delta charges the herd sockets and nothing else: one real
        # driver client (reads its events) + one raw subscriber that
        # NEVER reads (the relay-budget demotion victim).
        factory = NetworkDocumentServiceFactory(host=host, port=port)
        service = factory.create_document(
            "conn-doc", ContainerRuntime().summarize())
        endpoint = service.connection()
        delivered: list = []
        endpoint.subscribe(lambda m: delivered.append(m.seq))
        endpoint.connect("typist")
        # SO_RCVBUF is clamped BEFORE connect (it fixes the negotiated
        # TCP window): otherwise loopback autotuning absorbs megabytes
        # into kernel buffers and the pump's own relay queue — the thing
        # the budget meters — never grows at bench-sized volumes.
        deadbeat = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        deadbeat.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8192)
        deadbeat.settimeout(30)
        deadbeat.connect((host, port))
        extra_socks.append(deadbeat)
        _raw_rpc(deadbeat, "subscribe_doc", {"doc": "conn-doc"})
        # From here on the deadbeat is NEVER read: broadcast bytes pile
        # into its pump-side write queue until the budget demotes it.
        baseline = _proc_status(pid)

        t0 = _time.time()
        rss_peak = baseline.get("rss_bytes", 0)
        for i in range(target):
            for attempt in (1, 2, 3):
                try:
                    conns.append(
                        socket.create_connection((host, port), timeout=30))
                    break
                except OSError:
                    if attempt == 3:
                        raise
                    _time.sleep(0.2)  # accept burst backlog: brief, rare
            if (i + 1) % 2048 == 0:
                rss_peak = max(rss_peak, _proc_status(pid)
                               .get("rss_bytes", 0))
            if (i + 1) % 8192 == 0:
                print(f"  connections: {i + 1}/{target}", file=sys.stderr)
        connect_wall = _time.time() - t0

        ping_ok = 0
        stride = max(1, target // CONN_PING_SAMPLES)
        sampled = list(range(0, target, stride))
        for j in sampled:
            if _raw_rpc(conns[j], "ping", {}) == "pong":
                ping_ok += 1

        # Traffic while the herd is held: real ops through the driver,
        # events delivered back through the pump's relay path.  The
        # never-reading subscriber receives the same broadcast bytes and
        # must blow its relay budget → demotion, not unbounded queueing.
        # Only bytes the pump cannot hand to the KERNEL count against
        # the budget, and loopback autotuning absorbs megabytes before
        # send() blocks — so the bench types until the demotion fires
        # (budget enforced) or a hard byte ceiling proves it never does,
        # rather than guessing this host's kernel buffer depth.
        pad = "x" * 8192
        ops_sent, demotions = 0, 0
        stats: dict = {}
        while ops_sent < ops or (not demotions and ops_sent < 2048):
            endpoint.submit(RawOperation(
                client_id="typist", client_seq=ops_sent + 1, ref_seq=0,
                type=MessageType.OP,
                contents={"i": ops_sent, "pad": pad}))
            ops_sent += 1
            if ops_sent % 64 == 0:
                stats = _raw_rpc(conns[0], "stats", {})
                demotions = stats["counters"].get("fd.relay_demotions", 0)
        deadline = _time.time() + 30
        while _time.time() < deadline:
            stats = _raw_rpc(conns[0], "stats", {})
            demotions = stats["counters"].get("fd.relay_demotions", 0)
            if len(delivered) >= ops_sent and demotions:
                break
            _time.sleep(0.1)
        status = _proc_status(pid)
        rss_peak = max(rss_peak, status.get("rss_bytes", 0))
        rss_base = baseline.get("rss_bytes")
        per_conn = (max(0, rss_peak - rss_base) / target
                    if rss_base is not None else None)
        threads = status.get("threads")
        pump = stats.get("pump") or {}
        passed = (
            len(conns) == target
            and ping_ok == len(sampled)
            and pump.get("open", 0) >= target
            and (per_conn is None or per_conn <= CONN_RSS_BUDGET_BYTES)
            and (threads is None or threads <= CONN_MAX_SERVER_THREADS)
            and len(delivered) >= ops_sent
            and demotions >= 1
        )
        return {
            "requested_connections": requested,
            "achieved_connections": len(conns),
            "fd_hard_limit": hard,
            "fd_headroom": CONN_FD_HEADROOM,
            "env_capped": env_capped,
            "connect_wall_sec": round(connect_wall, 3),
            "connects_per_sec": (round(target / connect_wall, 1)
                                 if connect_wall > 0 else None),
            "rss_baseline_bytes": rss_base,
            "rss_peak_bytes": rss_peak,
            "rss_per_conn_bytes": (round(per_conn, 1)
                                   if per_conn is not None else None),
            "rss_budget_per_conn_bytes": CONN_RSS_BUDGET_BYTES,
            "server_threads": threads,
            "server_threads_max": CONN_MAX_SERVER_THREADS,
            "ping_sampled": len(sampled),
            "ping_ok": ping_ok,
            "ops_submitted": ops_sent,
            "events_delivered": len(delivered),
            "relay_budget_bytes": relay_budget,
            "relay_demotions": demotions,
            "pump": pump or None,
            "passed": passed,
        }
    finally:
        if factory is not None:
            try:
                factory.close()
            except Exception:
                pass
        for sock in conns + extra_socks:
            try:
                sock.close()
            except OSError:
                pass
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        shutil.rmtree(base, ignore_errors=True)


def run_one(name: str, seed: int, clients: int, docs: int, shards: int,
            oracle: bool, replay_check: bool, columnar: bool = True,
            sample_every: int = 8, gate_override: float = None,
            compare_boxed: bool = False, out_of_proc: bool = False,
            replicas: int = 1, *, device="cuda") -> dict:
    """One scenario through ``run_swarm`` on ``device``, with its oracle
    twin, replay and boxed checks as asked, and its gate verdict."""
    spec = build_scenario(name, seed=seed, clients=clients, docs=docs,
                          shards=shards)
    if out_of_proc and name == "catchup-storm":
        # The catchup.* seams live inside the shard processes, which
        # scheduled-site validation rightly rejects from the harness
        # plan; the deterministic in-proc storm is the seam-coverage
        # run — out of proc exercises the real RPC path instead, and
        # WIDENS the real-call sample: connections are cheap
        # behind the event-loop pump, so 4× the storming clients per doc
        # actually cross the wire.
        spec = dataclasses.replace(spec, plan=None,
                                   storm_clients_per_doc=16)
    if out_of_proc and name == "failover-drill":
        # The drill's scheduled kill becomes a REAL process kill: same
        # tick, same victim selection, SIGKILL semantics.
        from ..testing.faults import FaultPlan, FaultPoint

        spec = dataclasses.replace(spec, plan=FaultPlan(
            seed=seed, points=tuple(
                FaultPoint("proc.kill", "kill", at=p.at, doc=p.doc,
                           shard=p.shard)
                for p in spec.plan.points if p.site == "shard.kill")))
    if out_of_proc and replicas > 1:
        # The replica drill: run the scenario through N shared-
        # nothing front-door replicas and SIGKILL the traffic-bearing
        # one mid-run — client drivers fail over through the survivor
        # and the single-replica oracle twin must still match
        # byte-identically (the twin resets replicas=1 and drops the
        # kill, so the verdict is the failover's, not the topology's).
        from ..testing.faults import FaultPlan, FaultPoint

        mid = max(1, sum(p.ticks for p in spec.phases) // 2)
        points = tuple(spec.plan.points) if spec.plan is not None else ()
        # out_of_proc rides along here (it is re-applied below): the
        # replicas>1 spec validation rightly refuses an in-proc topology.
        spec = dataclasses.replace(spec, replicas=replicas,
                                   out_of_proc=True, plan=FaultPlan(
                                       seed=seed, points=points + (
                                           FaultPoint("replica.kill",
                                                      "kill", at=mid),)))
    spec = dataclasses.replace(spec, columnar=columnar,
                               sample_every=sample_every,
                               out_of_proc=out_of_proc,
                               # catchup-herd and tree-collab are the
                               # fold-tier scenarios: after the swarm run
                               # their sampled docs catch up cold+warm
                               # through the REAL CatchupService so the
                               # report carries the resident-tier
                               # counters — served / spliced /
                               # evictions / bytes_saved next to delta +
                               # pack stats — and, for tree-collab, the
                               # SECOND kernel family's tree-tier
                               # counters.
                               fold_probe=(
                                   name in ("catchup-herd", "tree-collab")
                                   and not out_of_proc))
    t0 = time.time()
    result = run_swarm(spec, device=device)
    wall = time.time() - t0  # the gated number times the PRIMARY run only
    oracle_match = None
    if oracle:
        twin = run_swarm(oracle_spec(spec, result), device=device)
        oracle_match = (result.sampled_digests == twin.sampled_digests
                        and result.per_doc_head == twin.per_doc_head)
    replay_identical = None
    if replay_check:
        replay_identical = \
            run_swarm(spec, device=device).identity() == result.identity()
    boxed_compare = None
    if compare_boxed:
        # The ingress comparator: the SAME scenario through the boxed
        # per-op path (parity-pinned byte-identical), so the recorded
        # ingress_us_per_op ratio is apples to apples.
        t0 = time.time()
        boxed = run_swarm(dataclasses.replace(spec, columnar=False),
                          device=device)
        boxed_wall = time.time() - t0
        speedup = (boxed.ingress["ingress_us_per_op"]
                   / result.ingress["ingress_us_per_op"]
                   if result.ingress["ingress_us_per_op"] else None)
        boxed_compare = {
            "identity_match": boxed.identity() == result.identity(),
            "ops_per_sec": round(boxed.sequenced_ops / boxed_wall, 1)
            if boxed_wall > 0 else 0.0,
            "ingress": boxed.ingress,
            "ingress_speedup_vs_boxed":
                round(speedup, 2) if speedup else None,
        }
    storm_report = storm_record(spec, result) if spec.storm else None
    gate = (gate_override if gate_override is not None
            else (GATES_OPS_PER_SEC_PROC if out_of_proc
                  else GATES_OPS_PER_SEC).get(name))
    checks = verdict(result, wall, gate, oracle_match=oracle_match,
                     replay_identical=replay_identical,
                     boxed_compare=boxed_compare, storm_report=storm_report)
    ops_per_sec = result.sequenced_ops / wall if wall > 0 else 0.0
    return {
        "clients": result.clients,
        "docs": result.docs,
        "shards": result.shards,
        "replicas": replicas if out_of_proc else 1,
        "ticks": result.ticks,
        "seed": seed,
        "sequenced_ops": result.sequenced_ops,
        "ops_stamped": result.ops_stamped,
        "ops_deduped": result.ops_deduped,
        "joins": result.joins,
        "ops_per_sec": round(ops_per_sec, 1),
        "gate_ops_per_sec": gate,
        "wall_sec": round(wall, 3),
        # latency in VIRTUAL ticks: deterministic per seed
        "delivery_p50_ticks": result.delivery_p50_ticks,
        "delivery_p99_ticks": result.delivery_p99_ticks,
        "delivery_samples": result.delivery_samples,
        "catchup_p50_ticks": result.catchup_p50_ticks,
        "catchup_p99_ticks": result.catchup_p99_ticks,
        "catchup_samples": result.catchup_samples,
        "max_pending_depth": result.max_pending_depth,
        "defers": len(result.defers),
        "join_defers": len(result.join_defers),
        "kills": [list(k) for k in result.kills],
        "sampled_docs": len(result.sampled_digests),
        # schema-stable verdicts: null when the check was skipped
        "oracle_match": oracle_match,
        "replay_identical": replay_identical,
        "fault_counts": result.fault_counts,
        "counters": result.counters,
        # ingress-stage accounting (wall-derived; outside replay identity)
        "columnar": columnar,
        "ingress": result.ingress,
        "boxed_compare": boxed_compare,
        # out-of-proc: per-shard counters over the stats RPC + live-tap
        # delivery audit (empty dict for in-proc runs)
        "out_of_proc": out_of_proc,
        "shard_stats": result.shard_stats,
        # catchup-herd: resident / delta / pack fold-tier counters from
        # the post-run cold+warm CatchupService pass over sampled docs
        # (empty dict on other scenarios)
        "fold_tier": result.fold_tier,
        # catchup-storm: the herd-through-the-real-fold-tier record —
        # lanes, shed rate, cache hit rate, degraded serves, gated p99
        # storm latency, admission balance + fault-coverage verdicts
        "storm": storm_report,
        "passed": checks["passed"],
    }


def storm_record(spec, result) -> dict:
    """The herd-through-the-real-fold-tier record of a storm run: lanes,
    shed rate, cache hit rate, degraded serves, p99 storm latency, the
    admission balance and fault-coverage verdicts."""
    storm = result.storm
    tiers = storm.get("tiers") or {}
    cache = tiers.get("cache") or {}
    lookups = cache.get("hits", 0) + cache.get("misses", 0)
    admission = storm.get("admission") or {}
    # The acceptance balance: every fold-lane entry is accounted —
    # admitted + shed + degraded = requests (warm bypasses ride outside
    # the balance by design).
    balance_ok = (
        admission.get("catchup.requests", 0)
        == admission.get("catchup.admitted", 0)
        + admission.get("catchup.shed", 0)
        + admission.get("catchup.degraded", 0)
    ) if admission else None
    coverage_ok = (all(
        result.fault_counts.get(f"{p.site}:{p.kind}", 0) > 0
        for p in spec.plan.points
    ) if spec.plan is not None else None)
    return {
        **{key: storm.get(key) for key in (
            "mode", "requests", "served", "warm", "folds", "shed",
            "degraded", "retries", "fold_errors", "shed_rate",
            "latency_p50_ticks", "latency_p99_ticks",
            "latency_samples")},
        # Fraction of storm answers served with ZERO fold work (the
        # warm priority lane: tier-0/1 serves, single-flight joins,
        # and the no-new-ops fast path — the last bypasses the
        # tier-1 hit counter, so this is the honest storm-side rate;
        # the raw tier-1 lookup split stays under "tiers").
        "cache_hit_rate": (
            round(storm.get("warm", 0) / storm["served"], 4)
            if storm.get("served") else None),
        "tier1_lookup_hit_rate": (
            round(cache.get("hits", 0) / lookups, 4)
            if lookups else None),
        "degraded_serves": storm.get("degraded"),
        "admission": admission or None,
        "admission_balance_ok": balance_ok,
        "fault_coverage_ok": coverage_ok,
        "gate_p99_ticks": STORM_GATE_P99_TICKS,
        "tiers": tiers or None,
    }


def verdict(result, wall: float, gate, *, oracle_match=None,
            replay_identical=None, boxed_compare=None,
            storm_report=None) -> dict:
    """A run's gate, condition by condition, and ``passed`` (all of
    them): at least ``gate`` sequenced ops a second over ``wall`` (no
    floor when ``gate`` is None), the oracle twin and the same-seed
    re-run not refuted (None: not run), the boxed run identical, and for
    a storm every request served, the admission lane balanced, every
    planned fault seen and the p99 storm latency within
    ``STORM_GATE_P99_TICKS``."""
    ops_per_sec = result.sequenced_ops / wall if wall > 0 else 0.0
    storm = storm_report or {}
    p99 = storm.get("latency_p99_ticks")
    checks = {
        "rate_ok": gate is None or ops_per_sec >= gate,
        "oracle_ok": oracle_match is not False,
        "replay_ok": replay_identical is not False,
        "boxed_ok": (boxed_compare is None
                     or boxed_compare["identity_match"]),
        "served_all": storm.get("served") == storm.get("requests"),
        "admission_balance_ok":
            storm.get("admission_balance_ok") is not False,
        "fault_coverage_ok": storm.get("fault_coverage_ok") is not False,
        "p99_ok": p99 is None or p99 <= STORM_GATE_P99_TICKS,
    }
    checks["passed"] = all(checks.values())
    return checks


def platform_of(device) -> str:
    """The report's ``platform``: ``cpu``, or the card's name."""
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="drive fluidscale swarm scenarios with perf gates")
    parser.add_argument("--list", action="store_true",
                        help="print named scenarios with one-line docs")
    parser.add_argument("--scenario", choices=tuple(SCENARIOS) + ("all",),
                        default="all")
    parser.add_argument("--clients", type=int, default=100_000)
    parser.add_argument("--docs", type=int, default=128)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--seed", type=int, default=10)
    parser.add_argument("--no-oracle", action="store_true",
                        help="skip the single-shard oracle twin "
                             "(halves the wall time; verdict is null)")
    parser.add_argument("--replay-check", action="store_true",
                        help="re-run each scenario with the same seed and "
                             "assert bit-identical metrics + counters")
    parser.add_argument("--boxed", action="store_true",
                        help="drive the per-op boxed ingress path instead "
                             "of the columnar wire path")
    parser.add_argument("--sample-every", type=int, default=8,
                        help="sample every Nth document for elections + "
                             "the digest oracle (sampled docs keep live "
                             "broadcast subscribers and pay per-message "
                             "materialization)")
    parser.add_argument("--gate", type=float, default=None,
                        help="override the per-scenario ops/sec floor "
                             "(e.g. 100000 for the 10^6-client record)")
    parser.add_argument("--compare-boxed", action="store_true",
                        help="re-run each scenario through the boxed path "
                             "and record the ingress_us_per_op ratio "
                             "(plus a full identity parity verdict)")
    parser.add_argument("--storm", action="store_true",
                        help="run the catchup-storm scenario as THE gate: "
                             "a join herd through the REAL "
                             "catchup RPC with adaptive admission — "
                             "records cache_hit_rate, shed_rate, "
                             "degraded_serves, gated p99 storm latency, "
                             "admission balance and fault coverage")
    parser.add_argument("--stream", action="store_true",
                        help="run the streaming-fold gate: "
                             "catchup-storm with the sequencer-attached "
                             "streaming fold on vs off — byte-identical "
                             "convergence, ≥95%% zero-fold serves, "
                             "cadence-bounded summary lag, and the "
                             "truncated log strictly smaller on disk")
    parser.add_argument("--out-of-proc", action="store_true",
                        help="drive the REAL process tier: shard-host "
                             "processes with per-shard durable logs behind "
                             "the routing front door; the "
                             "failover drill SIGKILLs a real shard process")
    parser.add_argument("--replicas", type=int, default=1,
                        help="front-door replicas for out-of-proc runs; "
                             "with >= 2 the traffic-bearing "
                             "replica is SIGKILLed mid-run and clients "
                             "fail over through a survivor")
    parser.add_argument("--connections", type=int, default=None,
                        help="connection-scale gate: hold N "
                             "REAL TCP connections against one event-loop "
                             "front-door process under a per-connection "
                             "RSS tripwire, with steady-typing traffic "
                             "flowing and relay budgets enforced; the "
                             "achieved count is capped by the container's "
                             "hard fd limit and recorded honestly")
    parser.add_argument("--out", default=None,
                        help="write the JSON report here (default stdout)")
    parser.add_argument("--device", default="cuda",
                        help="the device every catch-up fold runs on "
                             "(default 'cuda'; 'cpu' runs the plain folds "
                             "on the host).  Checked before anything "
                             "starts: without a CUDA device the default "
                             "exits 2")
    args = parser.parse_args(argv)

    if args.list:
        for name, doc in scenario_docs().items():
            print(f"{name:16s} {doc}")
        return 0
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))
    platform = platform_of(device)

    if args.connections:
        t0 = time.time()
        result = run_connections(args.connections, device=device)
        report = {
            "bench": "frontdoor_connections",
            "platform": platform,
            "connections": result,
            "wall_sec": round(time.time() - t0, 3),
        }
        print(
            f"connections: {result['achieved_connections']}/"
            f"{result['requested_connections']}"
            f"{' (env fd cap)' if result['env_capped'] else ''} | "
            f"{result['rss_per_conn_bytes']}B/conn rss "
            f"(budget {result['rss_budget_per_conn_bytes']}) | "
            f"threads {result['server_threads']} | ping "
            f"{result['ping_ok']}/{result['ping_sampled']} | events "
            f"{result['events_delivered']}/{result['ops_submitted']} | "
            f"demotions {result['relay_demotions']} | "
            f"{'PASS' if result['passed'] else 'FAIL'}",
            file=sys.stderr,
        )
        write_bench_json(report, out=args.out)
        return 0 if result["passed"] else 1

    if args.stream:
        t0 = time.time()
        result = run_stream(args.seed, args.clients, args.docs,
                            args.shards, replay_check=args.replay_check,
                            device=device)
        report = {
            "bench": "streamfold",
            "platform": platform,
            "clients": args.clients,
            "docs": args.docs,
            "shards": args.shards,
            "stream": result,
            "wall_sec": round(time.time() - t0, 3),
        }
        print(
            f"streamfold: folds {result['cold_folds_off']}→"
            f"{result['cold_folds_on']} | serve_rate "
            f"{result['stream_serve_rate']} | lag "
            f"{result['stream_summary_lag_max_seqs']}/"
            f"{result['stream_lag_gate_seqs']} seqs | log "
            f"{result['oplog_bytes_untruncated_on']}→"
            f"{result['oplog_bytes_on']}B | "
            f"converged={result['converged_identical']} | "
            f"{'PASS' if result['passed'] else 'FAIL'}",
            file=sys.stderr,
        )
        write_bench_json(report, out=args.out)
        return 0 if result["passed"] else 1

    if args.storm:
        args.scenario = "catchup-storm"
    names = tuple(SCENARIOS) if args.scenario == "all" else (args.scenario,)
    t0 = time.time()
    report: dict = {
        "bench": ("catchup_storm" if args.storm
                  else "service_proc" if args.out_of_proc
                  else "service_scale"),
        "platform": platform,
        "clients": args.clients,
        "docs": args.docs,
        "shards": args.shards,
        "columnar": not args.boxed,
        "sample_every": args.sample_every,
        "out_of_proc": args.out_of_proc,
        "replicas": args.replicas if args.out_of_proc else 1,
        "scenarios": {},
    }
    for name in names:
        result = run_one(name, args.seed, args.clients, args.docs,
                         args.shards, oracle=not args.no_oracle,
                         replay_check=args.replay_check,
                         columnar=not args.boxed,
                         sample_every=args.sample_every,
                         gate_override=args.gate,
                         compare_boxed=args.compare_boxed,
                         out_of_proc=args.out_of_proc,
                         replicas=args.replicas, device=device)
        report["scenarios"][name] = result
        print(
            f"{name}: {result['sequenced_ops']} msgs @ "
            f"{result['ops_per_sec']:,.0f}/s | ingress "
            f"{result['ingress']['ingress_us_per_op']}us/op | delivery p99 "
            f"{result['delivery_p99_ticks']} ticks | catchup p99 "
            f"{result['catchup_p99_ticks']} ticks | oracle="
            f"{result['oracle_match']} replay={result['replay_identical']} "
            f"| {'PASS' if result['passed'] else 'FAIL'}",
            file=sys.stderr,
        )
    report["total_passed"] = sum(
        1 for s in report["scenarios"].values() if s["passed"])
    report["total_scenarios"] = len(report["scenarios"])
    report["wall_sec"] = round(time.time() - t0, 3)
    write_bench_json(report, out=args.out)
    return 0 if report["total_passed"] == report["total_scenarios"] else 1


if __name__ == "__main__":
    sys.exit(main())
