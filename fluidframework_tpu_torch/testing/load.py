"""Load/stress harness: many puppet clients with fault injection.

Capability-equivalent of the reference's ``test-service-load`` (SURVEY.md
§4: many puppet clients against a real service, configurable op rates,
random disconnects).

Drives the REAL stack (Loader → driver → ordering service), not the mocks:
each puppet runs a seeded random schedule of edits, syncs, disconnects/
reconnects, stash/rehydrate cycles, and late joins; at the end everything
synchronizes and the harness asserts byte-identical summaries across every
surviving client — the convergence oracle under load.

The port's copy of ``fluidframework_tpu/testing/load.py``.  It adds
:func:`seed_wire_soak`, the wire soak's seeding step (the worker
subprocesses of ``python -m fluidframework_tpu_torch.testing.load
--wire-worker``, each waited for within a deadline), so that the tests
and the chip smoke seed the soak one way."""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional

from ..drivers import LocalDocumentServiceFactory
from ..loader import Loader
from ..service import LocalOrderingService


@dataclasses.dataclass
class LoadSpec:
    seed: int = 0
    clients: int = 4
    #: fault injection: NACK every Nth submit service-side (0 = off); the
    #: nacked ops must still converge (the runtime requeues + resends)
    nack_every: int = 0
    steps: int = 200               # total scheduled actions
    edit_weight: float = 0.70
    sync_weight: float = 0.15
    disconnect_weight: float = 0.05
    stash_weight: float = 0.03     # crash + rehydrate as a new session
    late_join_weight: float = 0.02
    max_clients: int = 8


class VirtualClock:
    """Deterministic time source for the simulated stack.

    Each read advances by a fixed tick, so DeltaManager retryAfter holds
    (``clock() + retry_after`` vs later reads) resolve after the same
    number of scheduler decisions on every run, regardless of host speed
    or wall-clock start — the load run is fully replayable from its seed.
    """

    def __init__(self, tick: float = 0.001) -> None:
        self.now = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.now += self.tick
        return self.now

    def sleep(self, seconds: float) -> None:
        """Virtual sleep: advance time without blocking — the backoff
        actuator RetryPolicy uses, so a retry schedule is a pure function
        of the run's decision sequence (the DeltaManager picks this up
        automatically when its injected clock has a ``sleep``)."""
        self.now += max(0.0, seconds)


@dataclasses.dataclass
class LoadResult:
    steps: int
    edits: int
    disconnects: int
    rehydrates: int
    late_joins: int
    final_clients: int
    sequenced_ops: int
    summary_digest: str
    nacks_issued: int = 0


def run_load(spec: LoadSpec) -> LoadResult:
    rng = random.Random(spec.seed)
    throttle = None
    if spec.nack_every:
        counter = {"n": 0}

        def throttle(_client_id):
            counter["n"] += 1
            if counter["n"] % spec.nack_every == 0:
                return 0.0  # immediate-retry nack (fault injection)
            return None

    service = LocalOrderingService(throttle=throttle)
    # Wall-clock-free: every DeltaManager in the run shares one virtual
    # clock, so nack holds resolve identically on every replay of a seed.
    loader = Loader(LocalDocumentServiceFactory(service),
                    clock=VirtualClock())

    def build(rt):
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")
        ds.create_channel("counter-tpu", "count")

    containers: Dict[str, object] = {}
    offline: Dict[str, bool] = {}
    next_id = 0

    def new_client(pending_state=None):
        nonlocal next_id
        next_id += 1
        cid = f"load-{spec.seed}-{next_id}"
        if not containers and pending_state is None:
            c = loader.create("load-doc", cid, build)
        else:
            c = loader.resolve("load-doc", cid, pending_state=pending_state)
        containers[cid] = c
        offline[cid] = False
        return cid

    for _ in range(spec.clients):
        new_client()

    edits = disconnects = rehydrates = late_joins = 0

    def do_edit(container):
        nonlocal edits
        ds = container.runtime.get_datastore("ds")
        choice = rng.random()
        if choice < 0.6:
            text = ds.get_channel("text")
            length = len(text.text)
            if length < 4 or rng.random() < 0.7:
                text.insert_text(rng.randint(0, length),
                                 rng.choice("abcdef") * rng.randint(1, 4))
            else:
                start = rng.randint(0, length - 2)
                text.remove_range(start, min(length, start + 3))
        elif choice < 0.9:
            ds.get_channel("kv").set(f"k{rng.randint(0, 20)}",
                                     rng.randint(0, 999))
        else:
            ds.get_channel("count").increment(rng.choice([1, -1, 5]))
        edits += 1

    for _step in range(spec.steps):
        cid = rng.choice(sorted(containers))
        container = containers[cid]
        r = rng.random()
        if r < spec.edit_weight:
            do_edit(container)
        elif r < spec.edit_weight + spec.sync_weight:
            for c in containers.values():
                c.drain()
        elif r < spec.edit_weight + spec.sync_weight \
                + spec.disconnect_weight:
            if offline[cid]:
                container.reconnect()
                offline[cid] = False
            else:
                container.disconnect()
                offline[cid] = True
            disconnects += 1
        elif r < spec.edit_weight + spec.sync_weight \
                + spec.disconnect_weight + spec.stash_weight:
            if len(containers) > 1:
                stash = container.close_and_get_pending_state()
                del containers[cid]
                del offline[cid]
                new_client(pending_state=stash)
                rehydrates += 1
        else:
            if len(containers) < spec.max_clients:
                new_client()
                late_joins += 1

    # Final convergence: reconnect everyone, drain to quiescence.
    for cid, container in containers.items():
        if offline[cid]:
            container.reconnect()
            offline[cid] = False
    # Pump until TRUE quiescence: reconnect resubmits and nack-requeued
    # wire messages (fault injection) may need several flush+drain rounds
    # before every replica has flushed everything and seen the head.
    for _round in range(64):
        for container in containers.values():
            container.runtime.flush()
            container.drain()
        head = service.oplog.head("load-doc")
        if all(
            c.runtime.ref_seq == head
            and not c.runtime._pending_wire
            and not c.runtime._outbox
            for c in containers.values()
        ):
            break
    else:
        raise AssertionError("load run never quiesced after 64 rounds")

    digests = {c.runtime.summarize().digest() for c in containers.values()}
    if len(digests) != 1:
        detail = []
        for cid, c in containers.items():
            text = c.runtime.get_datastore("ds").get_channel("text")
            dm = c.delta_manager
            detail.append(
                f"{cid}: seq={c.runtime.ref_seq} nacks={dm.nacks} "
                f"state={dm.state.value} "
                f"pending_wire={len(c.runtime._pending_wire)} "
                f"outbox={len(c.runtime._outbox)} text={text.text[:40]!r}"
            )
        raise AssertionError(
            "load run diverged: "
            + f"{len(digests)} distinct summaries\n" + "\n".join(detail)
        )
    return LoadResult(
        steps=spec.steps,
        edits=edits,
        disconnects=disconnects,
        rehydrates=rehydrates,
        late_joins=late_joins,
        final_clients=len(containers),
        sequenced_ops=service.oplog.head("load-doc"),
        summary_digest=next(iter(digests)),
        nacks_issued=sum(
            o.sequencer.nacks_issued for o in service._orderers.values()
        ),
    )


# --- sharded ordering tier: multi-shard traffic with mid-run failover --------


@dataclasses.dataclass
class ShardedLoadSpec:
    """A deterministic multi-document, multi-client schedule over the
    sharded ordering tier, with an optional mid-run shard kill.

    The same spec driven with ``shards=1`` (single ``LocalOrderingService``)
    and ``scripted_reconnect_at`` set to the killed run's fence step is the
    byte-identity ORACLE: a voluntary reconnect stamps the same LEAVE+JOIN
    the fence reconnect does, so the two runs sequence identical per-doc
    logs and must produce identical summaries."""

    seed: int = 0
    shards: int = 4
    docs: int = 8
    clients_per_doc: int = 2
    steps: int = 240
    #: step AFTER which one shard is killed (None = no kill).  The victim
    #: is the owner of the first doc unless ``kill_shard`` names one.
    kill_at: Optional[int] = None
    kill_shard: Optional[str] = None
    #: "eager" = fenced clients reconnect at the kill step (the fence
    #: event); "lazy" = clients keep editing until a submit raises the
    #: fence flag, then reconnect (exercises the in-flight fence path).
    fence_reaction: str = "eager"
    #: oracle-twin knob: at this step, voluntarily reconnect the clients
    #: of ``scripted_docs`` (no kill) — mirrors the killed run's fence
    #: reconnects so both runs stamp identical LEAVE+JOIN schedules.
    scripted_reconnect_at: Optional[int] = None
    scripted_docs: tuple = ()
    #: attach a serialize-once Broadcaster probe with this many recorder
    #: sinks per document (0 = off); latencies are in virtual-clock ticks.
    probe_sinks: int = 0


@dataclasses.dataclass
class ShardedLoadResult:
    per_doc_digest: Dict[str, str]
    per_doc_head: Dict[str, int]
    sequenced_ops: int
    edits: int
    reconnects: int
    fenced_docs: List[str]
    killed_shard: Optional[str]
    epoch_bumped: bool
    shard_docs: Dict[str, int]      # live docs per surviving shard
    shard_ops: Dict[str, int]       # sequenced ops per surviving shard
    broadcast_encodes: int = 0
    broadcast_latencies: Optional[List[float]] = None


class _ProbeSink:
    """Recorder sink for the Broadcaster probe: accepts every frame and
    records delivery latency in virtual-clock ticks against the
    scenario's current submit timestamp."""

    def __init__(self, clock: VirtualClock, submit_t0: dict,
                 latencies: List[float]) -> None:
        self._clock = clock
        self._submit_t0 = submit_t0
        self._latencies = latencies

    def write_frame(self, data: bytes) -> bool:
        self._latencies.append(self._clock() - self._submit_t0["t"])
        return True

    def write_signal(self, data: bytes, signal: dict) -> bool:
        return True

    def on_demoted(self, doc_id: str, head_seq: int) -> None:
        raise AssertionError("probe sink accepts everything")

    def on_fence(self, doc_id: str, epoch: str, head_seq: int) -> None:
        pass


def run_sharded_load(spec: ShardedLoadSpec) -> ShardedLoadResult:
    from ..protocol.messages import ShardFencedError
    from ..service.broadcaster import Broadcaster
    from ..service.sharding import ShardedOrderingService

    rng = random.Random(spec.seed)
    clock = VirtualClock()
    if spec.shards > 1:
        service = ShardedOrderingService(n_shards=spec.shards)
    else:
        service = LocalOrderingService()
    factory = LocalDocumentServiceFactory(service)
    loader = Loader(factory, clock=clock)

    doc_ids = [f"shard-doc-{i:02d}" for i in range(spec.docs)]

    def build(rt):
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")

    containers: Dict[tuple, object] = {}
    for doc_id in doc_ids:
        for c in range(spec.clients_per_doc):
            cid = f"ld{spec.seed}-{doc_id}-c{c}"
            if c == 0:
                containers[(doc_id, c)] = loader.create(doc_id, cid, build)
            else:
                containers[(doc_id, c)] = loader.resolve(doc_id, cid)

    # Broadcaster probe: serialize-once fan-out over every doc, recorder
    # sinks timing delivery in virtual ticks.
    broadcaster = latencies = None
    submit_t0 = {"t": 0.0}
    if spec.probe_sinks > 0:
        broadcaster = Broadcaster()
        latencies = []
        for doc_id in doc_ids:
            for _ in range(spec.probe_sinks):
                broadcaster.attach(doc_id, service.endpoint(doc_id),
                                   _ProbeSink(clock, submit_t0, latencies))
        if hasattr(service, "add_fence_listener"):
            service.add_fence_listener(
                lambda _sid, docs, epoch: [
                    broadcaster.refence(d, service.endpoint(d), epoch)
                    for d in docs
                ]
            )

    edits = reconnects = 0
    fenced_docs: List[str] = []
    killed: Optional[str] = None
    epoch0 = service.storage.epoch

    def do_edit(container):
        nonlocal edits
        ds = container.runtime.get_datastore("ds")
        if rng.random() < 0.7:
            text = ds.get_channel("text")
            n = len(text.text)
            if n < 4 or rng.random() < 0.7:
                text.insert_text(rng.randint(0, n),
                                 rng.choice("abcdef") * rng.randint(1, 3))
            else:
                start = rng.randint(0, n - 2)
                text.remove_range(start, min(n, start + 2))
        else:
            ds.get_channel("kv").set(f"k{rng.randint(0, 15)}",
                                     rng.randint(0, 999))
        edits += 1

    def reconnect(key):
        nonlocal reconnects
        doc_id, _ = key
        containers[key].reconnect(
            document_service=factory.resolve(doc_id))
        reconnects += 1

    def reconnect_doc_clients(docs):
        for key in sorted(containers):
            if key[0] in docs:
                reconnect(key)

    for step in range(spec.steps):
        key = (rng.choice(doc_ids), rng.randrange(spec.clients_per_doc))
        container = containers[key]
        submit_t0["t"] = clock.now  # probe anchor: do not advance
        try:
            do_edit(container)
        except ShardFencedError:
            # Lazy reaction: the edit's flush hit the fence before the
            # wire-drain could swallow it (connect paths raise through).
            reconnect(key)
            container.drain()
        if container.delta_manager.fence_required:
            # The wire-drain swallowed the fence (ConnectionError
            # contract) and flagged it: re-resolve through the router
            # and reconnect — the queued ops ride out on the new owner.
            reconnect(key)
        if step % 4 == 3:
            for c in containers.values():
                c.drain()
        if spec.kill_at is not None and step == spec.kill_at:
            victim = spec.kill_shard or service.shard_of(doc_ids[0])
            fenced_docs = service.kill_shard(victim)
            killed = victim
            if spec.fence_reaction == "eager":
                reconnect_doc_clients(set(fenced_docs))
        if spec.scripted_reconnect_at is not None \
                and step == spec.scripted_reconnect_at:
            reconnect_doc_clients(set(spec.scripted_docs))

    # Quiescence: same discipline as run_load, per document.
    for _round in range(64):
        for c in containers.values():
            if c.delta_manager.fence_required:
                reconnect_doc_clients({c.doc_id})
            c.runtime.flush()
            c.drain()
        if all(
            c.runtime.ref_seq == service.oplog.head(c.doc_id)
            and not c.runtime._pending_wire
            and not c.runtime._outbox
            for c in containers.values()
        ):
            break
    else:
        raise AssertionError("sharded load never quiesced after 64 rounds")

    per_doc_digest: Dict[str, str] = {}
    per_doc_head: Dict[str, int] = {}
    for doc_id in doc_ids:
        digests = {
            c.runtime.summarize().digest()
            for key, c in containers.items() if key[0] == doc_id
        }
        if len(digests) != 1:
            raise AssertionError(
                f"{doc_id} diverged: {len(digests)} distinct summaries")
        per_doc_digest[doc_id] = next(iter(digests))
        head = service.oplog.head(doc_id)
        per_doc_head[doc_id] = head
        seqs = [m.seq for m in service.oplog.get(doc_id)]
        if seqs != list(range(1, head + 1)):
            raise AssertionError(
                f"{doc_id} seq numbers not contiguous: {seqs[:10]}...")

    shard_docs: Dict[str, int] = {}
    shard_ops: Dict[str, int] = {}
    if isinstance(service, ShardedOrderingService):
        for sid, (n_docs, n_ops) in service.shard_load().items():
            shard_docs[sid] = n_docs
            shard_ops[sid] = n_ops
    return ShardedLoadResult(
        per_doc_digest=per_doc_digest,
        per_doc_head=per_doc_head,
        sequenced_ops=sum(per_doc_head.values()),
        edits=edits,
        reconnects=reconnects,
        fenced_docs=list(fenced_docs),
        killed_shard=killed,
        epoch_bumped=service.storage.epoch != epoch0,
        shard_docs=shard_docs,
        shard_ops=shard_ops,
        broadcast_encodes=(broadcaster.stats()["encodes"]
                           if broadcaster is not None else 0),
        broadcast_latencies=latencies,
    )


# --- chaos load: mixed traffic under a generated fault schedule --------------


@dataclasses.dataclass
class ChaosLoadSpec:
    """A deterministic multi-shard schedule driven UNDER a fault plan
    (testing/faults.py): every seam failure — durable-append outages,
    torn writes, stale summary serves, laggard clients, a shard kill —
    is injected by occurrence/tick, so the whole run is a pure function
    of ``(seed, plan)``.

    The acceptance oracle (:func:`run_chaos_with_oracle`) re-drives the
    SAME scenario fault-free on a single shard, with the kill's
    fence-forced reconnects mirrored as scripted voluntary reconnects
    and the laggard (client-behavior) stalls kept — final per-document
    summaries must be byte-identical: faults may cost retries, never
    state."""

    seed: int = 0
    shards: int = 4
    docs: int = 6
    clients_per_doc: int = 2
    steps: int = 240
    #: None → ``FaultPlan.generate(seed, docs, steps)``
    plan: Optional[object] = None
    #: directory for the durable tier (file-backed oplog + summary
    #: store); required when the plan carries file-level fault points
    #: (torn appends, storage store/read faults)
    dir: Optional[str] = None
    #: None → a deterministic small-backoff RetryPolicy
    retry: Optional[object] = None
    #: one scripted late-join per document (exercises the cold-load /
    #: stale-summary-serve path mid-run); identical in the oracle twin
    late_joins: bool = True
    #: oracle-twin knob: ((step, (doc, ...)), ...) voluntary reconnects
    #: mirroring the chaos run's fence reconnects
    scripted_reconnects: tuple = ()


@dataclasses.dataclass
class ChaosLoadResult:
    per_doc_digest: Dict[str, str]
    per_doc_head: Dict[str, int]
    sequenced_ops: int
    edits: int
    reconnects: int
    #: (step, killed shard id, (affected doc, ...)) per executed kill
    kills: List[tuple]
    #: injector ``site:kind`` observation counts (replay-identity surface)
    fault_counts: Dict[str, int]
    #: summed DeltaManager ``retry.*`` counters across every client
    retry_counts: Dict[str, int]
    #: labels of plan points that never fired (must be [] for a run that
    #: claims its plan's coverage)
    unfired: List[str]
    #: virtual ticks from each kill to every affected doc re-converging
    recovery_ticks: List[float]
    stalled_steps: int


def chaos_doc_ids(docs: int) -> List[str]:
    """The chaos harness's document naming scheme — public so plan
    builders (tools/chaos.py, plan files) target real ids; a doc-scoped
    point naming a nonexistent id would silently never fire."""
    return [f"chaos-doc-{i:02d}" for i in range(docs)]


def _chaos_doc_ids(spec: ChaosLoadSpec) -> List[str]:
    return chaos_doc_ids(spec.docs)


def percentile(sorted_values, q: float) -> float:
    """Index-clamped percentile over an already-sorted sample — the one
    shared implementation for every bench reporter (service_e2e, chaos)."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1,
              max(0, int(len(sorted_values) * q) - 1))
    return sorted_values[idx]


def run_chaos_load(spec: ChaosLoadSpec) -> ChaosLoadResult:
    import os as _os

    from ..drivers.file_driver import FileSummaryStorage
    from ..protocol.messages import ShardFencedError
    from ..service.oplog import OpLog
    from ..service.retry import RetryPolicy
    from ..service.sharding import ShardedOrderingService
    from .faults import FaultInjector, FaultPlan

    doc_ids = _chaos_doc_ids(spec)
    plan = spec.plan if spec.plan is not None \
        else FaultPlan.generate(spec.seed, doc_ids, spec.steps)
    wire_sites = [p.site for p in plan.points
                  if p.site.startswith("rpc.") or p.site == "session.write"
                  or p.site.startswith("catchup.")]
    if wire_sites:
        raise ValueError(
            f"plan points at {sorted(set(wire_sites))} need the TCP "
            "stack or the server catchup fold lane, which this "
            "in-process harness does not drive — they would silently "
            "never fire and fail the coverage oracle; exercise wire "
            "sites via tools/chaos.py's tcp_smoke or the directed wire "
            "tests (tests/test_faultline.py), and catchup.* via the "
            "catchup-storm swarm scenario (testing/scenarios.py)")
    file_sites = ("storage.store", "storage.read", "oplog.flush")
    needs_dir = any(
        p.site in file_sites or (p.site == "oplog.append"
                                 and p.kind == "torn")
        for p in plan.points)
    if needs_dir and spec.dir is None:
        raise ValueError(
            "this plan injects file-level faults (torn appends, flush, "
            "summary store/read); pass ChaosLoadSpec.dir for the "
            "durable tier")
    injector = FaultInjector(plan)
    rng = random.Random(spec.seed)
    clock = VirtualClock()
    retry = spec.retry if spec.retry is not None else RetryPolicy(
        max_attempts=5, base_delay=0.01, max_delay=0.5, budget=5.0)

    if spec.dir is not None:
        _os.makedirs(spec.dir, exist_ok=True)
        # autoflush = the deployed durable-before-broadcast shape (the
        # standalone server's): every append fsyncs before the
        # broadcast, so flush faults fire on the real cadence.
        oplog = OpLog(_os.path.join(spec.dir, "chaos-ops.jsonl"),
                      autoflush=True, faults=injector)
        storage = FileSummaryStorage(
            _os.path.join(spec.dir, "chaos-summaries"), faults=injector)
    else:
        oplog, storage = OpLog(faults=injector), None
    if spec.shards > 1:
        service = ShardedOrderingService(
            n_shards=spec.shards, oplog=oplog, storage=storage,
            faults=injector)
    else:
        service = LocalOrderingService(oplog=oplog, storage=storage)
    factory = LocalDocumentServiceFactory(service)
    loader = Loader(factory, clock=clock, retry=retry)

    def build(rt):
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")

    containers: Dict[tuple, object] = {}
    for doc_id in doc_ids:
        for c in range(spec.clients_per_doc):
            cid = f"ch{spec.seed}-{doc_id}-c{c}"
            if c == 0:
                containers[(doc_id, c)] = loader.create(doc_id, cid, build)
            else:
                containers[(doc_id, c)] = loader.resolve(doc_id, cid)

    # Scripted late-joins: doc i gains a fresh client at a deterministic
    # step — identical in the oracle twin (scenario, not fault); the cold
    # resolve is where a stale-summary serve lands mid-run.
    late_join_step = {}
    if spec.late_joins:
        for i, doc_id in enumerate(doc_ids):
            late_join_step[spec.steps // 3 + 2 * i] = doc_id

    edits = reconnects = stalled_steps = 0
    kills: List[tuple] = []
    #: (doc, client index) -> stalled until step (exclusive)
    stalled: Dict[tuple, int] = {}
    #: (kill step, t0 virtual, remaining affected docs) under recovery
    recovering: List[list] = []
    recovery_ticks: List[float] = []

    def do_edit(container):
        nonlocal edits
        ds = container.runtime.get_datastore("ds")
        if rng.random() < 0.7:
            text = ds.get_channel("text")
            n = len(text.text)
            if n < 4 or rng.random() < 0.7:
                text.insert_text(rng.randint(0, n),
                                 rng.choice("abcdef") * rng.randint(1, 3))
            else:
                start = rng.randint(0, n - 2)
                text.remove_range(start, min(n, start + 2))
        else:
            ds.get_channel("kv").set(f"k{rng.randint(0, 15)}",
                                     rng.randint(0, 999))
        edits += 1

    def reconnect_docs(docs) -> None:
        nonlocal reconnects
        for key in sorted(containers):
            if key[0] in docs:
                # No explicit service: a fence reconnect re-resolves the
                # recovered owner through the DeltaManager's retry
                # (ShardFencedError → on_fence → router); a voluntary
                # (oracle-twin) reconnect just re-attaches.  Both stamp
                # the same LEAVE+JOIN.
                containers[key].reconnect()
                reconnects += 1

    for step in range(spec.steps):
        key = (rng.choice(doc_ids), rng.randrange(spec.clients_per_doc))
        container = containers[key]
        try:
            do_edit(container)
        except ShardFencedError:
            container.drain()  # self-heal: re-resolve + replay held ops
        doc_id = late_join_step.get(step)
        if doc_id is not None:
            # Mid-run service-side summary at the current durable head
            # (scenario behavior, identical in the oracle twin: no ops
            # are stamped).  This is what makes a stale-read fault on
            # the late join REAL — a lagging replica then serves the
            # PARENT summary and the joiner replays the longer tail.
            ro = loader.resolve(doc_id)
            service.storage.upload(doc_id, ro.runtime.summarize(),
                                   ro.runtime.ref_seq)
            ro.close()
            idx = spec.clients_per_doc
            containers[(doc_id, idx)] = loader.resolve(
                doc_id, f"ch{spec.seed}-{doc_id}-c{idx}")
        for p in injector.due("client.stall", step):
            victim = (p.doc, 1 % spec.clients_per_doc)
            stalled[victim] = step + int(p.arg)
            stalled_steps += int(p.arg)
        if step % 4 == 3:
            for ckey in sorted(containers):
                if stalled.get(ckey, 0) > step:
                    continue  # laggard: inbound queue grows, no drain
                containers[ckey].drain()
        if isinstance(service, ShardedOrderingService):
            before_dead = set(service.router.dead())
            affected = service.tick(step)
            newly_dead = [s for s in service.router.dead()
                          if s not in before_dead]
            if newly_dead:
                kills.append((step, newly_dead[0], tuple(affected)))
                recovering.append([step, clock.now, set(affected)])
                reconnect_docs(set(affected))
        for when, docs in spec.scripted_reconnects:
            if when == step:
                reconnect_docs(set(docs))
        # Recovery metric: a doc counts recovered once every one of its
        # clients is back at the durable head; the sample is the virtual
        # ticks elapsed since its shard was killed.
        for entry in recovering:
            done = {
                d for d in entry[2]
                if all(c.runtime.ref_seq >= service.oplog.head(d)
                       for k, c in containers.items() if k[0] == d)
            }
            for _d in sorted(done):
                recovery_ticks.append(clock.now - entry[1])
            entry[2] -= done
        recovering = [e for e in recovering if e[2]]

    # Quiescence: flush+drain rounds; Container.drain self-heals fences.
    for _round in range(64):
        for c in containers.values():
            c.runtime.flush()
            c.drain()
        if all(
            c.runtime.ref_seq == service.oplog.head(c.doc_id)
            and not c.runtime._pending_wire
            and not c.runtime._outbox
            for c in containers.values()
        ):
            break
    else:
        raise AssertionError("chaos load never quiesced after 64 rounds")

    # Docs still marked recovering when the step loop ended converged in
    # the quiescence rounds: sample them at the post-quiescence clock.
    for entry in recovering:
        for _d in sorted(entry[2]):
            recovery_ticks.append(clock.now - entry[1])

    per_doc_digest: Dict[str, str] = {}
    per_doc_head: Dict[str, int] = {}
    for doc_id in doc_ids:
        digests = {
            c.runtime.summarize().digest()
            for key, c in containers.items() if key[0] == doc_id
        }
        if len(digests) != 1:
            raise AssertionError(
                f"{doc_id} diverged: {len(digests)} distinct summaries")
        per_doc_digest[doc_id] = next(iter(digests))
        head = service.oplog.head(doc_id)
        per_doc_head[doc_id] = head
        seqs = [m.seq for m in service.oplog.get(doc_id)]
        if seqs != list(range(1, head + 1)):
            raise AssertionError(
                f"{doc_id} seq numbers not contiguous under faults: "
                f"{seqs[:10]}...")

    retry_counts: Dict[str, int] = {}
    for ckey in sorted(containers):
        counters = containers[ckey].delta_manager.retry_counters
        for name, value in sorted(counters.snapshot().items()):
            retry_counts[name] = retry_counts.get(name, 0) + value
    return ChaosLoadResult(
        per_doc_digest=per_doc_digest,
        per_doc_head=per_doc_head,
        sequenced_ops=sum(per_doc_head.values()),
        edits=edits,
        reconnects=reconnects,
        kills=kills,
        fault_counts=injector.snapshot(),
        retry_counts=retry_counts,
        unfired=[p.label() for p in injector.unfired()],
        recovery_ticks=recovery_ticks,
        stalled_steps=stalled_steps,
    )


def run_chaos_with_oracle(spec: ChaosLoadSpec):
    """THE acceptance harness: drive ``spec`` under its fault plan, then
    re-drive the identical scenario FAULT-FREE on a single shard — the
    kill's fence reconnects mirrored as scripted voluntary reconnects at
    the same steps (a reconnect stamps the same LEAVE+JOIN either way),
    laggard stalls kept (client behavior, not a service fault) — and
    return ``(chaos, oracle)``.  Callers assert per-doc digests/heads
    byte-identical: the entire fault schedule may cost retries and
    recoveries, but never state."""
    from .faults import FaultPlan

    chaos = run_chaos_load(spec)
    doc_ids = _chaos_doc_ids(spec)
    plan = spec.plan if spec.plan is not None \
        else FaultPlan.generate(spec.seed, doc_ids, spec.steps)
    stall_points = tuple(p for p in plan.points
                         if p.site == "client.stall")
    oracle_spec = dataclasses.replace(
        spec,
        shards=1,
        dir=None,  # fault-free: the in-memory durable tier suffices
        plan=FaultPlan(seed=spec.seed, points=stall_points),
        scripted_reconnects=tuple(
            (step, docs) for step, _shard, docs in chaos.kills),
    )
    return chaos, run_chaos_load(oracle_spec)


# --- wire soak: many docs through the standalone server's catchup RPC --------


def _soak_doc_name(i: int) -> str:
    return f"soak{i:05d}"


#: channel mix per doc index — all four kernel types cross the device path
_SOAK_KINDS = ("string", "map", "matrix", "tree", "string+map")


def _soak_build(kind: str):
    def build(rt):
        ds = rt.create_datastore("ds")
        if kind in ("string", "string+map"):
            ds.create_channel("sequence-tpu", "text")
        if kind in ("map", "string+map"):
            ds.create_channel("map-tpu", "kv")
        if kind == "matrix":
            ds.create_channel("matrix-tpu", "mx")
        if kind == "tree":
            ds.create_channel("tree-tpu", "tr")

    return build


def _soak_edit(container, kind: str, rng: random.Random,
               edits: int) -> None:
    ds = container.runtime.get_datastore("ds")
    for _ in range(edits):
        if kind in ("string", "string+map"):
            text = ds.get_channel("text")
            n = len(text.text)
            r = rng.random()
            if n < 4 or r < 0.6:
                text.insert_text(rng.randint(0, n),
                                 rng.choice("abcdef") * rng.randint(1, 4))
            elif r < 0.85 or kind == "string":
                start = rng.randint(0, n - 2)
                text.remove_range(start, min(n, start + 2))
            else:
                ds.get_channel("kv").set(f"k{rng.randint(0, 9)}",
                                         rng.randint(0, 99))
        elif kind == "map":
            ds.get_channel("kv").set(f"k{rng.randint(0, 9)}",
                                     rng.randint(0, 99))
        elif kind == "matrix":
            mx = ds.get_channel("mx")
            if mx.row_count == 0 or mx.col_count == 0:
                mx.insert_rows(0, 2)
                mx.insert_cols(0, 2)
            else:
                mx.set_cell(rng.randrange(mx.row_count),
                            rng.randrange(mx.col_count),
                            rng.randint(0, 99))
        else:  # tree
            tr = ds.get_channel("tr")
            kids = tr.children("", "a")
            if not kids or rng.random() < 0.6:
                tr.insert("", "a", rng.randint(0, len(kids)),
                          [tr.build("n", value=rng.randint(0, 99))])
            else:
                tr.set_value(rng.choice(kids), rng.randint(0, 99))


def wire_soak_worker(host: str, port: int, lo: int, hi: int,
                     edits_per_doc: int, seed: int) -> Dict[str, str]:
    """Seed docs [lo, hi) against a running standalone server over TCP;
    returns {doc_id: expected summary digest} (the seeder's drained-to-head
    summarize — what a post-catchup fresh load must reproduce)."""
    import time

    from ..drivers.network_driver import NetworkDocumentServiceFactory

    factory = NetworkDocumentServiceFactory(host=host, port=port)
    out: Dict[str, str] = {}
    try:
        loader = Loader(factory)
        for i in range(lo, hi):
            doc_id = _soak_doc_name(i)
            kind = _SOAK_KINDS[i % len(_SOAK_KINDS)]
            rng = random.Random(seed * 7919 + i)
            c = loader.create(doc_id, f"seeder{i}", _soak_build(kind))
            _soak_edit(c, kind, rng, edits_per_doc)
            c.runtime.flush()
            head = factory.resolve(doc_id).delta_storage.head()
            deadline = time.time() + 30
            while time.time() < deadline and c.runtime.ref_seq < head:
                c.drain()
                time.sleep(0.005)
            c.drain()
            c.close()  # LEAVE advances the head past the seeder's view...
            # ...so the expected digest comes from a READ-ONLY load (no
            # JOIN) at the quiesced head — exactly what a post-catchup
            # fresh read-only load must reproduce byte-identically.
            ro = loader.resolve(doc_id)
            out[doc_id] = ro.runtime.summarize().digest()
            ro.close()
        return out
    finally:
        factory.close()


#: the wire soak's seeding: worker subprocesses, edits a document, and
#: the seed of every document's edit schedule
SOAK_PROCS, SOAK_EDITS, SOAK_SEED = 4, 6, 42


def seed_wire_soak(host: str, port: int, n_docs: int,
                   timeout: float = 600.0) -> Dict[str, str]:
    """Seed soak documents [0, ``n_docs``) against a running server from
    ``SOAK_PROCS`` worker subprocesses (the last takes the remainder),
    ``SOAK_EDITS`` edits a document from ``SOAK_SEED``; returns the merged
    {doc_id: expected summary digest}.  Every worker must end within
    ``timeout`` seconds of the start; past it, or when one fails, every
    worker still running is killed and the call raises."""
    import json
    import os
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    per = n_docs // SOAK_PROCS
    workers = [
        subprocess.Popen(
            [sys.executable, "-m", "fluidframework_tpu_torch.testing.load",
             "--wire-worker", host, str(port), str(w * per),
             str(n_docs if w == SOAK_PROCS - 1 else (w + 1) * per),
             str(SOAK_EDITS), str(SOAK_SEED)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=repo)
        for w in range(SOAK_PROCS)
    ]
    deadline = time.monotonic() + timeout
    expected: Dict[str, str] = {}
    try:
        for w in workers:
            out, err = w.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            if w.returncode != 0:
                raise RuntimeError(
                    f"wire soak worker exited {w.returncode}: "
                    f"{err[-2000:]}")
            expected.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    return expected


def main() -> None:
    """Subprocess entry: ``python -m
    fluidframework_tpu_torch.testing.load --wire-worker HOST PORT LO HI
    EDITS SEED`` prints one JSON object of {doc_id: digest}."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("--wire-worker", nargs=6, metavar=(
        "HOST", "PORT", "LO", "HI", "EDITS", "SEED"))
    args = p.parse_args()
    if args.wire_worker:
        host, port, lo, hi, edits, seed = args.wire_worker
        digests = wire_soak_worker(host, int(port), int(lo), int(hi),
                                   int(edits), int(seed))
        json.dump(digests, sys.stdout)
        sys.stdout.write("\n")


if __name__ == "__main__":
    main()
