"""fluidscale: a vectorized 10⁵–10⁶-client scenario engine over the REAL
serving stack.

``testing/load.py`` drives dozens of puppet clients, each a full
Container + DeltaManager — which makes the north star's "millions of
users" claim unfalsifiable: nothing could ever drive enough clients to
measure it.  This module simulates swarm populations **columnar**: all
per-client state (document assignment, op cadence, next-fire tick,
connect / laggard / catch-up state, consumption cursor) lives in numpy
arrays stepped O(population) per virtual tick, while every generated op
is submitted through the *real* path — by default the
columnar wire path: each tick's ops planned as ONE struct-packed
:class:`~fluidframework_tpu_torch.protocol.wire.ColumnBatch`, shipped through
the real ``column_batch_to_bytes``/``from_bytes`` framing, and stamped
vectorized via ``submit_columns`` (one durable-log flush per tick);
with ``spec.columnar=False``, the boxed per-op path — the
byte-identical parity oracle.  Broadcast sinks ride the serialize-once
:class:`~fluidframework_tpu_torch.service.broadcaster.Broadcaster` on the
SAMPLED documents (identical topology in both modes), and everything
lands in the durable
:class:`~fluidframework_tpu_torch.service.oplog.OpLog`.  Nothing in
the serving path is mocked; only the CLIENTS are virtual.

Determinism (see SEMANTICS.md "Swarm determinism"): a run is a pure
function of ``(seed, spec)`` — op content and cadence come from counter-
based hash mixing, consumption is modeled in virtual ticks, faults are
``FaultPlan``-scheduled, and the single-threaded step loop gives the
batched ingress a deterministic submission order.  Replaying the same
spec reproduces every metric, fault observation, and telemetry counter
bit-identically.

The acceptance oracle (:func:`run_swarm_with_oracle`) re-drives the SAME
scenario fault-free on a single shard, mirroring any batch deferrals the
faulted run recorded (``scripted_defers``) so both runs stamp
byte-identical per-document logs — final summaries of sampled documents,
loaded through the real Loader, must match byte-for-byte.

The port's copy of ``fluidframework_tpu/testing/scenarios.py``.  Its one
change is the device: ``ClientSwarm``, ``run_swarm`` and
``run_swarm_with_oracle`` take a keyword-only ``device`` (default
``"cuda"``, checked before anything is built) and hand it to the three
places a swarm folds: the storm's ``OrderingServer``, the out-of-process
tier's ``FrontDoor`` (whose shard processes run ``--device``) and the
fold probe's ``CatchupService``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..drivers import LocalDocumentServiceFactory
from ..loader import Loader
from ..ops.mergetree_kernel import resolve_device
from ..service import LocalOrderingService
from ..service.broadcaster import Broadcaster
from ..service.oplog import OpLog
from ..service.sharding import ShardedOrderingService
from ..protocol.messages import MessageType, NackError, RawOperation
from ..protocol.wire import (COL_KIND_INCREMENT, COL_KIND_INSERT,
                             COL_KIND_SET, CHAR_STRINGS, ColumnBatch,
                             column_batch_from_bytes, column_batch_to_bytes,
                             key_string)
from ..runtime.op_pipeline import BATCH_WIRE_VERSION
from ..utils.telemetry import CounterSet, IngressMeter
from .faults import FaultInjector, FaultPlan, FaultPoint
from .load import VirtualClock, percentile

# -- client states (int8 column) ----------------------------------------------

_UNBORN = 0     # not yet connected (pre-ramp)
_STEADY = 1     # connected, typing and draining on its fire cadence
_DARK = 2       # herd cohort: neither submits nor drains (gone dark)
_LAGGARD = 3    # keeps typing against a FROZEN view; never drains
_CATCHUP = 4    # draining a backlog at catchup_rate ops/tick


def _u64(x) -> np.uint64:
    return np.uint64(x & 0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a uint64 array: the counter-based hash
    every swarm decision draws from — no PRNG object state, so any
    (client, op index) decision is recomputable from the seed alone."""
    x = (x ^ (x >> np.uint64(30))) * _u64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * _u64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_clients(seed: int, salt: int, idx: np.ndarray,
                  extra: Optional[np.ndarray] = None) -> np.ndarray:
    h = (idx.astype(np.uint64) * _u64(0x9E3779B97F4A7C15)
         + _u64(seed * 0x100000001B3 + salt * 0xD1B54A32D192ED03 + 1))
    if extra is not None:
        h = h + extra.astype(np.uint64) * _u64(0xA0761D6478BD642F)
    return _mix64(h)


# -- scenario DSL -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    """One scenario phase.  ``kind``:

    - ``ramp``     — the population connects, spread over the phase
      (batched JOINs through ``connect_many``);
    - ``steady``   — steady typing traffic on per-client cadences;
    - ``herd``     — ``frac`` of the steady population goes DARK for the
      phase, then re-enters together as a catch-up herd at its end;
    - ``laggards`` — ``frac`` get individual stop-draining windows inside
      the phase (they keep typing against frozen views — the MSN-pinning
      shape), each recovering through a catch-up burst;
    - ``election`` — instant event (``ticks`` may be 0): a service-side
      summarizer loads each sampled document at the durable head and
      uploads a summary (the summary-election capability at scale).
    """

    kind: str
    ticks: int = 0
    frac: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("ramp", "steady", "herd", "laggards",
                             "election"):
            raise ValueError(f"unknown phase kind {self.kind!r}")
        if self.ticks < 0 or not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"bad phase {self}")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A fully deterministic swarm scenario: the run is a pure function
    of this value (``seed`` included)."""

    name: str
    phases: Tuple[Phase, ...]
    seed: int = 0
    clients: int = 1000
    docs: int = 16
    shards: int = 4
    #: mean client ops over the whole run; op cadence is derived from it
    #: (total ops ≈ clients × ops_per_client, independent of population)
    ops_per_client: float = 3.0
    #: ops a catching-up client consumes per tick
    catchup_rate: int = 256
    #: every Nth document is sampled for elections + the digest oracle
    sample_every: int = 8
    #: scheduled faults (shard kills, durable-append outages) driven at
    #: virtual ticks through testing/faults.py
    plan: Optional[FaultPlan] = None
    #: oracle-twin knob: ``((tick, doc_index, consumed), ...)`` — split
    #: that document's tick batch at ``consumed`` and defer the whole
    #: batch to the next tick, mirroring a faulted run's recorded
    #: deferrals so both runs stamp identical logs
    scripted_defers: Tuple[tuple, ...] = ()
    #: same mirror for batched JOINs: ``((tick, doc_index, joined), ...)``
    #: — connect only the first ``joined`` clients of that document's
    #: tick cohort, the rest re-try next tick
    scripted_join_defers: Tuple[tuple, ...] = ()
    #: directory for a durable file-backed op log (None = in-memory);
    #: group commit makes the fsync cost one flush per tick batch
    dir: Optional[str] = None
    #: columnar wire path: plan each tick's ops as ONE
    #: struct-packed ColumnBatch, ship it through the real wire
    #: encode/decode, and stamp it through the services' vectorized
    #: ``submit_columns``; the per-op boxed loop survives as the
    #: fallback for pending/scripted/subscriber-bearing documents.
    #: ``False`` = the boxed path — the byte-identical parity oracle.
    columnar: bool = True
    #: out-of-process tier: drive the scenario against REAL
    #: shard-host processes behind an in-process front door — every op
    #: crosses the wire twice (swarm → front door → owning shard), logs
    #: are per-shard files on disk, and scheduled ``proc.kill`` /
    #: ``proc.hang`` points SIGKILL/SIGSTOP real processes.  Only
    #: SCHEDULED fault sites are allowed in the plan (a seam site like
    #: ``oplog.append`` lives inside a shard process this harness cannot
    #: reach — such a plan fails loudly instead of reporting hollow
    #: coverage).
    out_of_proc: bool = False
    #: run a REAL CatchupService cold+warm fold pass over the sampled
    #: documents after the run: the swarm's op logs hit the
    #: device fold twice with tier 1 off, so the warm pass exercises the
    #: pack / delta / device-resident tiers and their counters land in
    #: ``SwarmResult.fold_tier`` (outside replay identity, like
    #: ``ingress``).  In-proc runs only.
    fold_probe: bool = False
    #: SharedTree collaboration: every document carries a
    #: tree channel and the swarm's generated ops are id-addressed tree
    #: changesets (leaf insert / value set / remove under root fields)
    #: instead of map/counter/string traffic.  Tree changesets are
    #: outside the closed columnar wire vocabulary, so ingress takes the
    #: boxed envelope path by design (the per-doc fallback route the
    #: columnar contract documents); with ``fold_probe`` the sampled
    #: documents then catch up through the REAL CatchupService TREE
    #: route — the second-kernel-family serving shape.
    tree_ops: bool = False
    #: catch-up STORM: every herd/laggard re-entry cohort
    #: elects real catch-up callers per document whose joins are
    #: converted into REAL ``CatchupService.catch_up`` calls through an
    #: adaptive-admission fold lane (``service/server.py``) — warm
    #: bypass, load-derived shed pacing, degraded serving, and the
    #: ``catchup.slow``/``catchup.fail`` seams all fire; the rest of the
    #: cohort models consumption columnar so cost stays bounded.
    #: In-proc runs are replay bit-identical (admission runs off a
    #: VirtualClock); out-of-proc runs issue the real ``catchup`` RPC
    #: through the front door against WIRE-CLOCK shard admission,
    #: so remote verdicts are bit-identical too — only transport noise
    #: stays outside replay identity.
    storm: bool = False
    #: real catch-up callers elected per document per storm wave — the
    #: "sampled real folds" bound; the cohort remainder stays columnar
    storm_clients_per_doc: int = 4
    #: admission slots of the storm fold lane (Catchup.MaxInflight)
    storm_max_inflight: int = 4
    #: consecutive overflow verdicts before degraded-mode serving takes
    #: over from shedding (Catchup.DegradeAfter) — high enough that the
    #: herd really cycles through shed → paced retry before the tier
    #: falls back to stale serves
    storm_degrade_after: int = 4
    #: reconnect jitter: a cohort's first attempts hash-spread over this
    #: many ticks (an instantaneous 10⁴ spike would lock the tier into
    #: pure degraded mode on tick one — real herds arrive over seconds,
    #: and the spread is what lets folds, sheds, paced retries, and warm
    #: hits all interplay)
    storm_spread_ticks: int = 8
    #: modeled fold duration: virtual ticks an admission lease stays
    #: occupied after its (synchronous) fold returns — what makes a
    #: single-threaded deterministic driver produce real overlapping-
    #: fold admission pressure
    storm_fold_ticks: int = 2
    #: seconds one virtual tick maps to on the storm's injected clock
    #: (converts the server's load-derived retry_after into ticks)
    storm_tick_seconds: float = 0.05
    #: oracle-twin knob (set by :func:`oracle_spec`): unlimited
    #: admission and zero modeled hold — the never-shed twin every
    #: shed/degraded client must converge byte-identically to
    storm_never_shed: bool = False
    #: streaming fold: attach a
    #: :class:`~..service.streamfold.StreamFoldService` to the storm's
    #: in-proc server — committed micro-batches fold once per tick at
    #: ``stream_cadence``, summaries publish to the streaming-head
    #: index, and the oplog truncates behind the newest durable summary
    #: (``stream_retention`` hot-tail floor).  Herd re-entries then
    #: serve from the ``stream`` lane instead of cold folds.
    stream: bool = False
    stream_cadence: int = 8
    stream_retention: int = 64
    #: fail-loud floor on the real-caller election:
    #: a gate that needs at least this many REAL catch-up callers per
    #: document must declare it here — asking for more than
    #: ``storm_clients_per_doc`` admits is a spec error, not a silently
    #: clipped sample.
    storm_min_cohort: int = 0
    #: front-door replicas: out-of-proc runs stand up this
    #: many front doors over ONE shard fleet — the primary spawns and
    #: supervises the shards, every additional door ATTACHES to the same
    #: addresses (shared-nothing: replicas agree on placement only
    #: through the deterministic rendezvous router).  The swarm's data
    #: path pins to the NEWEST replica, so a scheduled ``replica.kill``
    #: SIGKILLs the door the traffic actually rides and the adapter must
    #: fail over to a survivor.
    replicas: int = 1
    #: shard backend for out-of-proc runs: ``"proc"`` (real processes,
    #: the default) or ``"thread"`` (in-process ShardHostServers behind
    #: the same real TCP wire — no fork cost, which is what lets a
    #: replica-death drill run in tier-1 time).  ``replica.kill`` works
    #: under either; ``proc.kill``/``proc.hang`` need real processes.
    proc_spawn: str = "proc"

    def __post_init__(self) -> None:
        if self.clients < self.docs:
            raise ValueError("need at least one client per document")
        if self.storm_min_cohort > self.storm_clients_per_doc:
            raise ValueError(
                f"{self.name!r} asks for storm_min_cohort="
                f"{self.storm_min_cohort} real catch-up callers per doc "
                f"but storm_clients_per_doc={self.storm_clients_per_doc} "
                f"silently bounds the election — raise the bound or "
                f"lower the gate")
        if self.stream and not self.storm:
            raise ValueError(
                f"{self.name!r}: stream=True rides the storm's in-proc "
                f"server — set storm=True")
        if self.stream and self.out_of_proc:
            raise ValueError(
                f"{self.name!r}: streaming scenarios run in-proc (shard "
                f"host processes take --stream directly)")
        if self.docs < 1 or self.shards < 1:
            raise ValueError(f"bad docs/shards on {self.name!r}")
        if self.replicas < 1:
            raise ValueError(f"bad replicas on {self.name!r}")
        if self.replicas > 1 and not self.out_of_proc:
            raise ValueError(
                f"{self.name!r}: front-door replicas are an out-of-proc "
                f"topology — set out_of_proc=True")
        if self.proc_spawn not in ("proc", "thread"):
            raise ValueError(
                f"{self.name!r}: proc_spawn must be 'proc' or 'thread'")
        if self.out_of_proc and self.plan is not None:
            allowed = {"proc.kill", "proc.hang", "shard.kill",
                       "replica.kill"}
            bad = [p.label() for p in self.plan.points
                   if p.site not in allowed]
            if bad:
                raise ValueError(
                    f"out-of-proc scenarios only execute scheduled "
                    f"process faults {sorted(allowed)}; plan has {bad}")
            if self.replicas < 2 and any(p.site == "replica.kill"
                                         for p in self.plan.points):
                raise ValueError(
                    f"{self.name!r}: replica.kill needs a survivor — "
                    f"set replicas >= 2")
            if self.proc_spawn == "thread" and any(
                    p.site in ("proc.kill", "proc.hang")
                    for p in self.plan.points):
                raise ValueError(
                    f"{self.name!r}: proc.kill/proc.hang SIGKILL/SIGSTOP "
                    f"real processes — use proc_spawn='proc' (thread "
                    f"shards take shard.kill)")

    @property
    def ticks(self) -> int:
        return sum(p.ticks for p in self.phases)

    def doc_id(self, d: int) -> str:
        return f"sw-{d:04d}"


@dataclasses.dataclass
class SwarmResult:
    """Everything a run measures — all of it deterministic, so the whole
    value doubles as the replay-identity surface."""

    name: str
    seed: int
    clients: int
    docs: int
    shards: int
    ticks: int
    #: sequenced messages across all documents (JOIN/LEAVE included)
    sequenced_ops: int
    #: client OP messages stamped / submitted / dedup'd on resubmit
    ops_stamped: int
    ops_submitted: int
    ops_deduped: int
    joins: int
    #: virtual-tick latency until the SLOWEST steady client consumed a
    #: message (per sequenced message)
    delivery_p50_ticks: float
    delivery_p99_ticks: float
    delivery_samples: int
    #: virtual ticks from catch-up start to reaching the head
    catchup_p50_ticks: float
    catchup_p99_ticks: float
    catchup_samples: int
    #: deepest head-minus-cursor backlog any client reached
    max_pending_depth: int
    #: (tick, doc_index, ops consumed) per deferred batch
    defers: Tuple[tuple, ...]
    #: (tick, doc_index, clients joined) per deferred JOIN cohort
    join_defers: Tuple[tuple, ...]
    #: (tick, killed shard, docs re-owned) per executed failover
    kills: Tuple[tuple, ...]
    #: (tick, door index) per executed front-door replica kill
    replica_kills: Tuple[tuple, ...]
    per_doc_head: Dict[str, int]
    #: sampled doc -> final summary digest (real Loader load at the end)
    sampled_digests: Dict[str, str]
    #: injector ``site:kind`` observations (empty when no plan)
    fault_counts: Dict[str, int]
    #: swarm + broadcaster counters
    counters: Dict[str, int]
    #: per-phase counter attribution (CounterSet.delta over each phase)
    phase_counters: Dict[str, Dict[str, int]]
    #: ingress-stage accounting (IngressMeter.snapshot()): wall-derived,
    #: NOT part of the replay-identity surface
    ingress: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: out-of-proc runs: per-shard stats pulled over the ``stats`` RPC
    #: plus live-tap delivery accounting — carries pids and async frame
    #: counts, so (like ``ingress``) excluded from replay identity
    shard_stats: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: ``spec.fold_probe`` runs: catch-up fold-tier counters over the
    #: sampled docs (device-resident / delta / pack cache stats + the
    #: h2d/d2h byte split) — busy seconds are wall-derived, so (like
    #: ``ingress``) excluded from replay identity
    fold_tier: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: ``spec.storm`` runs: the catch-up storm report (per-lane counts,
    #: p50/p99 storm latency in virtual ticks, admission + tier-cache
    #: snapshots, per-phase tier stats).  The DETERMINISTIC essentials
    #: (requests/warm/folds/shed/degraded/retries) are mirrored into
    #: ``counters`` as ``swarm.storm_*`` for in-proc runs — those ARE
    #: replay identity; this dict additionally carries wall-derived
    #: stage seconds and (out of proc) remote verdicts, so the dict
    #: itself is excluded like ``ingress``.
    storm: Dict[str, object] = dataclasses.field(default_factory=dict)

    def identity(self) -> dict:
        """The bit-identity surface: every field, canonically shaped —
        except ``ingress``/``shard_stats``/``fold_tier``/``storm``,
        which carry wall-clock / process derived detail and are
        excluded (the storm's deterministic counters ride ``counters``
        instead)."""
        out = dataclasses.asdict(self)
        out.pop("ingress", None)
        out.pop("shard_stats", None)
        out.pop("fold_tier", None)
        out.pop("storm", None)
        return out


# -- named scenarios ----------------------------------------------------------


def _steady_typing(seed, clients, docs, shards) -> ScenarioSpec:
    """Ramp to full population, then steady typing traffic end to end."""
    return ScenarioSpec(
        name="steady-typing", seed=seed, clients=clients, docs=docs,
        shards=shards,
        phases=(Phase("ramp", 24), Phase("steady", 120)),
    )


def _catchup_herd(seed, clients, docs, shards) -> ScenarioSpec:
    """A cohort goes dark mid-run and returns as one catch-up herd.

    The bursty reconnect-storm shape: 30% of the steady population stops
    submitting and draining for a window, then re-enters together and
    drains its backlog at the catch-up rate."""
    return ScenarioSpec(
        name="catchup-herd", seed=seed, clients=clients, docs=docs,
        shards=shards,
        phases=(Phase("ramp", 16), Phase("steady", 48),
                Phase("herd", 40, frac=0.3), Phase("steady", 48)),
    )


def _laggard_window(seed, clients, docs, shards) -> ScenarioSpec:
    """Staggered laggards keep typing against frozen views (MSN pin).

    20% of the swarm stops draining in individually-staggered windows
    while still submitting — their frozen views pin the MSN — and each
    recovers through a catch-up burst."""
    return ScenarioSpec(
        name="laggard-window", seed=seed, clients=clients, docs=docs,
        shards=shards,
        phases=(Phase("ramp", 16), Phase("steady", 32),
                Phase("laggards", 80, frac=0.2), Phase("steady", 32)),
    )


def _tree_collab(seed, clients, docs, shards) -> ScenarioSpec:
    """SharedTree collab swarm: boxed tree changesets + a catch-up herd.

    Every client edits a shared tree channel (leaf inserts / LWW value
    sets / removes under root fields, all id-addressed); a cohort goes
    dark mid-run and returns as one herd.  The sampled documents then
    catch up cold+warm through the REAL CatchupService tree route
    (``fold_probe``), so the report carries the second kernel family's
    resident / delta / pack tier counters."""
    return ScenarioSpec(
        name="tree-collab", seed=seed, clients=clients, docs=docs,
        shards=shards, tree_ops=True,
        phases=(Phase("ramp", 16), Phase("steady", 48),
                Phase("herd", 32, frac=0.25), Phase("steady", 32)),
    )


def _catchup_storm(seed, clients, docs, shards) -> ScenarioSpec:
    """A dark cohort returns as a catch-up STORM through the real fold tier.

    30% of the steady population goes dark, then re-enters together —
    and the re-entry herd is converted into real
    ``CatchupService.catch_up`` calls (``storm_clients_per_doc`` real
    callers elected per document; the cohort remainder models
    consumption columnar) against the server's adaptive-admission fold
    lane: warm-cache bypass, load-derived shed pacing honored under
    VirtualClock, degraded serving under sustained overload, and the
    ``catchup.slow``/``catchup.fail`` fault seams, all deterministic
    and replay bit-identical.  A mid-run election freshens
    the stored summaries degraded serving answers from."""
    phases = (Phase("ramp", 16), Phase("steady", 40), Phase("election"),
              Phase("herd", 32, frac=0.3), Phase("steady", 40))
    plan = FaultPlan(seed=seed, points=(
        # The 2nd admitted fold is slow (0.2 s on the injected clock =
        # 4 ticks): the measured-cost EMA, and with it the shed pacing,
        # must adapt.  The 5th admitted fold dies: single-flight
        # finally-abandon + admission release + caller retry.
        FaultPoint("catchup.slow", "delay", at=2, arg=0.2),
        FaultPoint("catchup.fail", "fail", at=5),
    ))
    return ScenarioSpec(
        name="catchup-storm", seed=seed, clients=clients, docs=docs,
        shards=shards, storm=True, plan=plan, phases=phases)


def _failover_drill(seed, clients, docs, shards) -> ScenarioSpec:
    """Mid-run shard kill between summary elections, under live traffic.

    A FaultPlan-scheduled kill fences one shard's orderers, bumps the
    storage epoch, and lazily re-owns its documents while the swarm keeps
    typing; summary elections bracket the failover."""
    phases = (Phase("ramp", 16), Phase("steady", 40), Phase("election"),
              Phase("steady", 40), Phase("election"), Phase("steady", 40))
    total = sum(p.ticks for p in phases)
    plan = FaultPlan(seed=seed, points=(
        FaultPoint("shard.kill", "kill", doc="sw-0000", at=total // 2),
    ))
    return ScenarioSpec(
        name="failover-drill", seed=seed, clients=clients, docs=docs,
        shards=shards, phases=phases, plan=plan,
    )


#: name -> builder(seed, clients, docs, shards); the builder docstring's
#: first line is the one-line doc ``tools/loadgen.py --list`` prints.
SCENARIOS: Dict[str, Callable[..., ScenarioSpec]] = {
    "steady-typing": _steady_typing,
    "catchup-herd": _catchup_herd,
    "laggard-window": _laggard_window,
    "tree-collab": _tree_collab,
    "catchup-storm": _catchup_storm,
    "failover-drill": _failover_drill,
}


def build_scenario(name: str, seed: int = 0, clients: int = 1000,
                   docs: int = 16, shards: int = 4) -> ScenarioSpec:
    builder = SCENARIOS.get(name)
    if builder is None:
        raise KeyError(
            f"unknown scenario {name!r} (have: {', '.join(SCENARIOS)})")
    return builder(seed, clients, docs, shards)


def scenario_docs() -> Dict[str, str]:
    """{name: one-line description} for CLI listings."""
    return {
        name: (builder.__doc__ or "").strip().splitlines()[0]
        for name, builder in SCENARIOS.items()
    }


# -- the engine ---------------------------------------------------------------


class _SwarmSink:
    """Broadcaster sink for the swarm: accepts every frame (counting
    them — the serialize-once pin) and rides fences quietly; per-client
    delivery is modeled columnar, not per sink."""

    def __init__(self, counters: CounterSet) -> None:
        self._counters = counters

    def write_frame(self, data: bytes) -> bool:
        self._counters.bump("swarm.frames")
        return True

    def write_signal(self, data: bytes, signal: dict) -> bool:
        return True

    def on_demoted(self, doc_id: str, head_seq: int) -> None:
        raise AssertionError("swarm sink accepts everything")

    def on_fence(self, doc_id: str, epoch: str, head_seq: int) -> None:
        self._counters.bump("swarm.sink_fences")


class _StormSession:
    """Session shim for driving ``OrderingServer._dispatch`` in-proc
    (the storm server is never started — no sockets, no tenants)."""

    tenant = None


class _CatchupStorm:
    """Deterministic catch-up storm driver: the loop-closer
    between the swarm engine and the fold tier.

    **In-proc**: builds a REAL :class:`~..service.server.OrderingServer`
    (never started — no sockets) over the swarm's sharded service and
    drives its catchup entry per storming client, sequentially, off a
    dedicated VirtualClock.  Fold-slot occupancy is modeled in virtual
    time (``catchup_hold_seconds`` = ``storm_fold_ticks`` ×
    ``storm_tick_seconds``), so sequentially-driven folds OVERLAP on
    the admission controller's clock and every shed / degrade / warm /
    retry decision is a pure function of ``(seed, spec)`` — the whole
    storm replays bit-identically, counters included.  Shed clients
    honor the server's load-derived ``retry_after`` (converted to
    ticks) before retrying.

    **Out-of-proc**: issues the real ``catchup`` RPC through the front
    door to the owning shard process.  The shard runs WIRE-CLOCK
    admission: its controller advances only on the ``vnow``
    each request carries, requests go out sequentially on one
    connection, and the remote verdict sequence becomes the same pure
    function of ``(seed, spec)`` as in-proc — verdict counters rejoin
    the replay-identity surface, and only transport noise (timeouts,
    dead sockets, their retries) stays in the identity-excluded
    ``SwarmResult.storm`` report.
    """

    #: defensive bound — the acceptance criterion is ZERO unbounded
    #: queueing, so a client that cannot get served in this many
    #: attempts is a bug, not pacing.
    MAX_ATTEMPTS = 64

    def __init__(self, swarm: "ClientSwarm") -> None:
        self.swarm = swarm
        spec = swarm.spec
        #: tick -> storm client indices due (first attempt or retry)
        self.due: Dict[int, List[int]] = {}
        self.start_tick: Dict[int, int] = {}
        self.attempts: Dict[int, int] = {}
        self.latencies: List[int] = []
        self.remote: Dict[str, int] = {}
        self.phase_tiers: Dict[str, object] = {}
        self._session = _StormSession()
        self.clock = None
        self.server = None
        self.streamfold = None
        #: cohort members the storm_clients_per_doc bound clipped out of
        #: the real-caller election (they stay columnar-modeled): the
        #: bound is counted, never silent
        self.elected = 0
        self.clipped = 0
        #: fold-cost EMA twin: the harness re-runs
        #: the admission controller's cost arithmetic from ITS OWN
        #: observations — in-proc the virtual-clock delta across the
        #: dispatch plus the modeled hold, out-of-proc the modeled hold
        #: alone (wire-clock admission admits and releases at the same
        #: observed vnow) — and every shed nack's snapshot ``cost_ema``
        #: must reproduce it, or the storm fails loudly: a server whose
        #: pacing derives from costs the harness never observed is
        #: lying or buggy.  Keyed per admission domain (the one in-proc
        #: server, or the owning shard id out-of-proc — each shard
        #: paces from its own controller).
        from ..service.server import ADMISSION_COST_INIT
        self.ema_twin: Dict[str, float] = {}
        self.ema_checks = 0
        self.ema_skips = 0
        #: set when transport noise makes the twin unverifiable (a lost
        #: request may still have folded server-side; a respawned shard
        #: comes back with a RESET controller) — checks are then
        #: SKIPPED and counted, never silently passed.
        self.ema_taint: Optional[str] = None
        self._cost_init = ADMISSION_COST_INIT
        #: modeled fold duration (seconds of lease occupancy after the
        #: synchronous fold returns) — the same value the in-proc server
        #: gets on ``catchup_hold_seconds`` and the out-of-proc shards
        #: get via ``--catchup-hold``.
        self.fold_hold = (0.0 if spec.storm_never_shed
                          else spec.storm_fold_ticks
                          * spec.storm_tick_seconds)
        #: out-of-proc storms run WIRE-CLOCK admission: the
        #: shard's controller advances only on the vnow each catchup
        #: request carries, the harness issues requests sequentially on
        #: one connection, and the verdict sequence becomes a pure
        #: function of request order — so verdict counters rejoin the
        #: replay-identity surface.  Transport noise (timeouts, socket
        #: errors and the retries they cause) stays identity-excluded.
        self.wire_clock = spec.out_of_proc
        if not spec.out_of_proc:
            from ..service.server import OrderingServer
            from ..utils.telemetry import ConfigProvider, MonitoringContext

            self.clock = VirtualClock(tick=0.0001)
            max_inflight = (1 << 30 if spec.storm_never_shed
                            else spec.storm_max_inflight)
            self.server = OrderingServer(
                swarm.service, catchup_max_inflight=max_inflight,
                faults=swarm.injector, clock=self.clock,
                mc=MonitoringContext(config=ConfigProvider({
                    "Catchup.DegradeAfter": spec.storm_degrade_after,
                })), device=swarm.device)
            if not spec.storm_never_shed:
                self.server.catchup_hold_seconds = (
                    spec.storm_fold_ticks * spec.storm_tick_seconds)
            if spec.stream:
                # Streaming fold rides the SAME server the storm drives:
                # the commit hook attaches to the swarm's real service,
                # and step() polls once per virtual tick.
                self.streamfold = self.server.enable_streaming(
                    cadence_ops=spec.stream_cadence,
                    retention_floor=spec.stream_retention)

    # -- scheduling ------------------------------------------------------------

    def enlist(self, t: int, cohort: np.ndarray) -> None:
        """A re-entry cohort formed at tick ``t-1``: elect the first
        ``storm_clients_per_doc`` members of each document's cohort
        (client-index order — deterministic) as REAL catch-up callers
        due at ``t``; the rest stay columnar-modeled."""
        if cohort.size == 0:
            return
        k = max(0, int(self.swarm.spec.storm_clients_per_doc))
        if k == 0:
            return
        docs = self.swarm.doc_of[cohort]
        order = np.argsort(docs, kind="stable")
        members = cohort[order]
        docs = docs[order]
        cuts = np.flatnonzero(np.diff(docs)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [members.size]])
        chosen: List[int] = []
        for s, e in zip(starts.tolist(), ends.tolist()):
            take = min(e, s + k)
            chosen.extend(int(i) for i in members[s:take])
            self.clipped += e - take
        self.elected += len(chosen)
        spread = max(1, int(self.swarm.spec.storm_spread_ticks))
        jitter = _hash_clients(self.swarm.spec.seed, 41,
                               np.asarray(chosen, dtype=np.int64))
        for i, j in zip(chosen, (jitter % np.uint64(spread)).tolist()):
            due_t = t + int(j)
            self.due.setdefault(due_t, []).append(i)
            self.start_tick[i] = due_t
            self.attempts[i] = 0
        self.swarm.counters.bump("swarm.storm_requests", len(chosen))

    def pending(self) -> bool:
        return bool(self.due)

    # -- the per-tick step -----------------------------------------------------

    def step(self, t: int) -> None:
        if self.clock is not None:
            # One swarm tick of storm time: previously-held fold leases
            # age toward expiry on the admission controller's clock.
            self.clock.sleep(self.swarm.spec.storm_tick_seconds)
        if self.streamfold is not None:
            # One streaming round per virtual tick.  step() runs after
            # the tick's ingress group commit closed, so the truncation
            # marker's flush commit point is real — poll() must never
            # run inside an open oplog.batch().
            self.streamfold.poll()
        # Everything due AT OR BEFORE t: the run loop skips storm steps
        # across the phase→quiescence boundary (those ticks advance ``t``
        # without a step), and an entry stranded at a skipped tick would
        # otherwise never pop — ``pending()`` stays true and the drain
        # loop spins forever.
        wave: List[int] = []
        for tick in sorted(k for k in self.due if k <= t):
            wave.extend(self.due.pop(tick))
        if not wave:
            return
        for i in wave:
            self.attempts[i] += 1
            if self.attempts[i] > self.MAX_ATTEMPTS:
                raise AssertionError(
                    f"storm client {i} not served after "
                    f"{self.MAX_ATTEMPTS} attempts — unbounded queueing")
            if self.server is not None:
                self._issue_inproc(i, t)
            else:
                self._issue_proc(i, t)

    def _bump(self, name: str, by: int = 1) -> None:
        """Verdict accounting: in-proc verdicts are deterministic and
        land in the swarm counters (the replay-identity surface).
        Out-of-proc verdicts USED to be wall-clock shaped and rode only
        the identity-excluded ``storm`` report; under wire-clock
        admission they are deterministic too and rejoin the
        identity counters — only transport NOISE (fold errors and the
        retries they cause, bumped explicitly into ``remote``) stays
        excluded, because a request timeout under load must never flip
        ``replay_identical``."""
        if self.server is not None or self.wire_clock:
            self.swarm.counters.bump(name, by)
        else:
            self.remote[name] = self.remote.get(name, 0) + by

    def _count(self, name: str) -> int:
        if self.server is not None or self.wire_clock:
            return self.swarm.counters.get(name)
        return self.remote.get(name, 0)

    def _noise(self, name: str, by: int = 1) -> None:
        """Non-deterministic accounting (transport errors, their
        retries): identity-excluded by construction."""
        self.remote[name] = self.remote.get(name, 0) + by

    def _ema_observe(self, key: str, cost: float) -> None:
        """One fold lease released: fold its observed cost into the
        twin with the controller's own arithmetic (release(), EMA 1/2 —
        including the cost>0 guard, so zero-cost releases leave the
        twin untouched exactly as they leave the controller's EMA)."""
        if cost > 0.0:
            self.ema_twin[key] = (0.5 * self.ema_twin.get(
                key, self._cost_init) + 0.5 * cost)

    def _ema_check(self, key: str, snap) -> None:
        """The storm-verdict tolerance gate: the
        shed nack's snapshot ``cost_ema`` must reproduce the harness's
        own observed fold costs.  In-proc the tolerance covers the
        server's OWN clock reads between admit and release (each
        VirtualClock read advances one tick the harness cannot see);
        out-of-proc wire-clock admission is exact up to the snapshot's
        1e-6 rounding.  Tainted runs (transport noise, respawns) skip
        the check and COUNT the skip — never a silent pass."""
        if not snap or "cost_ema" not in snap:
            return
        if self.server is None and self.ema_taint is None:
            if self.swarm.counters.get("swarm.kills"):
                self.ema_taint = "shard-kill (controller reset on respawn)"
            elif getattr(self.swarm.service, "door_failovers", 0):
                self.ema_taint = "door-failover (resend may have folded)"
        if self.ema_taint is not None:
            self.ema_skips += 1
            return
        twin = self.ema_twin.get(key, self._cost_init)
        tol = 50 * self.clock.tick if self.clock is not None else 1e-5
        self.ema_checks += 1
        if abs(float(snap["cost_ema"]) - twin) > tol:
            raise AssertionError(
                f"admission snapshot cost_ema {snap['cost_ema']!r} does "
                f"not reproduce the harness-observed fold-cost EMA "
                f"{twin!r} for {key!r} (tolerance {tol!r}): the shed "
                f"pacing derives from costs the harness never saw")

    def _retry(self, i: int, t: int, after_ticks: int,
               noise: bool = False) -> None:
        self.due.setdefault(t + max(1, after_ticks), []).append(i)
        if noise:
            self._noise("swarm.storm_retries")
        else:
            self._bump("swarm.storm_retries")

    def _serve(self, i: int, t: int, out: dict) -> None:
        """Record one successful catchup answer and verify it.  The
        served ``(handle, seq)`` is integrity-checked (a readable
        summary at a seq the durable log actually holds), but the
        client's consumption CURSOR is deliberately untouched: admission
        verdicts differ between a shedding run and its never-shed
        oracle twin, and any cursor influence would shift the client's
        later fire schedule and ref_seqs — forking the logs the oracle
        methodology pins byte-identical.  Sheds and degrades cost
        LATENCY (recorded here in virtual ticks), never state; the
        cohort drains columnar at ``catchup_rate`` either way — the
        "sampled real folds + columnar-modeled remainder" split.  (The
        100k matrix CAUGHT the cursor-jump variant of this harness:
        divergent served seqs leaked into op ref_seqs and the sampled
        digests split from the oracle.)"""
        swarm = self.swarm
        doc_id = swarm.doc_ids[int(swarm.doc_of[i])]
        served = out["docs"].get(doc_id)
        if served is not None:
            handle, seq = served
            if int(seq) > int(swarm.head_arr[swarm.doc_of[i]]):
                raise AssertionError(
                    f"catchup served {doc_id} at seq {seq} beyond the "
                    f"durable head {int(swarm.head_arr[swarm.doc_of[i]])}")
            if self.server is not None:
                # In-proc: the handle must resolve in the shared store —
                # a degraded serve hands out a REAL stored summary, not
                # a fabrication.
                swarm.service.storage.read(handle)
        lane = out.get("lane", "fold")
        self._bump({
            "warm": "swarm.storm_warm",
            "fold": "swarm.storm_folds",
            "degraded": "swarm.storm_degraded",
            "stream": "swarm.storm_stream",
        }.get(lane, "swarm.storm_folds"))
        self._bump("swarm.storm_served")
        self.latencies.append(t - self.start_tick[i])

    def _issue_inproc(self, i: int, t: int) -> None:
        swarm = self.swarm
        doc_id = swarm.doc_ids[int(swarm.doc_of[i])]
        # ``.now`` is the non-advancing read: the before/after pair must
        # not itself tick the clock the server's admission reads from.
        before = self.clock.now
        try:
            out = self.server._dispatch(self._session, "catchup",
                                        {"docs": [doc_id]})
        except NackError as exc:
            # Load-derived pacing honored in virtual ticks — the shed
            # client waits the server's own hold, never less.  The nack
            # carries the controller snapshot; its cost_ema must match
            # the harness's own fold-cost observations.
            self._bump("swarm.storm_shed")
            self._ema_check("inproc", getattr(exc, "admission", None))
            ticks = int(round(float(exc.retry_after)
                              / swarm.spec.storm_tick_seconds))
            self._retry(i, t, ticks)
            return
        except OSError:
            # Injected catchup.fail (FaultError ⊂ OSError): the fold
            # died after admission — slot released, single-flight
            # waiters woken by the finally-abandon; the caller retries.
            # The finally released WITH the hold, so the failed fold's
            # cost still landed in the pacing EMA — mirror it.
            self._ema_observe("inproc",
                              (self.clock.now - before) + self.fold_hold)
            self._bump("swarm.storm_fold_errors")
            self._retry(i, t, 1)
            return
        if out.get("lane", "fold") == "fold":
            # A real fold held a lease: its released cost (the virtual
            # time the dispatch consumed — catchup.slow sleeps land
            # here — plus the modeled hold) is what the controller's
            # EMA folded in.  Warm/stream/degraded serves never took a
            # lease and never touch the EMA.
            self._ema_observe("inproc",
                              (self.clock.now - before) + self.fold_hold)
        self._serve(i, t, out)

    def _issue_proc(self, i: int, t: int) -> None:
        """One REAL catchup RPC through the front door (with door
        failover — a replica SIGKILL mid-storm rotates to a survivor and
        resends).  The request carries the wire clock: ``vnow`` is the
        storm's own virtual time, and the shard's virtual admission
        controller advances on nothing else — same pacing model as the
        in-proc storm, across a real process boundary."""
        from ..drivers.network_driver import RpcError

        swarm = self.swarm
        doc_id = swarm.doc_ids[int(swarm.doc_of[i])]
        shard = str(swarm.service.router.owner(doc_id))
        try:
            out = swarm.service.request("catchup", {
                "docs": [doc_id],
                "vnow": t * swarm.spec.storm_tick_seconds})
        except NackError as exc:
            self._bump("swarm.storm_shed")
            retry = float(exc.retry_after)
            snap = getattr(exc, "admission", None)
            if self.wire_clock and snap:
                # The nack carries the shard's
                # admission snapshot, and the pacing must RE-DERIVE from
                # the reported fold-cost EMA — drift between the
                # snapshot and the verdict's retry_after is a bug, not
                # rounding (cost_ema ships rounded to 1e-6).
                backlog = int(snap["inflight"]) + int(snap["shed_streak"])
                derived = min(float(snap["retry_cap"]), max(
                    float(snap["retry_floor"]),
                    float(snap["cost_ema"]) * backlog
                    / max(1, int(snap["max_inflight"]))))
                if abs(derived - retry) > 1e-4:
                    raise AssertionError(
                        f"admission snapshot does not reproduce the "
                        f"shed pacing: derived {derived!r} vs wire "
                        f"retry_after {retry!r} ({snap!r})")
                retry = derived
                # The reported cost_ema itself must
                # reproduce the harness's own fold-cost observations
                # for this shard's admission domain.
                self._ema_check(shard, snap)
            ticks = int(round(retry / swarm.spec.storm_tick_seconds))
            self._retry(i, t, ticks)
            return
        except (RpcError, OSError) as exc:
            # Transport noise: wall-clock shaped, identity-excluded —
            # and it taints the EMA twin (the lost request may still
            # have folded, and released, server-side).
            if self.ema_taint is None:
                self.ema_taint = f"transport:{type(exc).__name__}"
            self._noise("swarm.storm_fold_errors")
            self._noise(f"error:{type(exc).__name__}")
            self._retry(i, t, 1, noise=True)
            return
        if out.get("lane", "fold") == "fold":
            # Wire-clock admission admits and releases a sequential
            # request at the SAME observed vnow: the lease's released
            # cost is exactly the modeled hold.
            self._ema_observe(shard, self.fold_hold)
        self._serve(i, t, out)

    # -- reporting -------------------------------------------------------------

    def _tier_stats(self):
        if self.server is None:
            return None
        catchup = self.server._catchup
        if catchup is None:
            return None
        return {
            "cache": (catchup.cache.stats()
                      if catchup.cache is not None else None),
            "delta_cache": (catchup.delta_cache.stats()
                            if catchup.delta_cache is not None else None),
            "pack_cache": (catchup._pack_cache.stats()
                           if catchup._pack_cache is not None else None),
            "device_cache": (catchup.device_cache.stats()
                             if catchup.device_cache is not None
                             else None),
        }

    def phase_mark(self, key: str) -> None:
        """Cumulative tier-cache snapshot at one phase boundary — the
        per-phase hit-rate record the storm bench reads (diff adjacent
        snapshots for a phase's own traffic)."""
        self.phase_tiers[key] = self._tier_stats()

    def summary(self) -> Dict[str, object]:
        lat = sorted(self.latencies)
        folds = self._count("swarm.storm_folds")
        shed = self._count("swarm.storm_shed")
        degraded = self._count("swarm.storm_degraded")
        lane_total = folds + shed + degraded
        out: Dict[str, object] = {
            "mode": "proc" if self.server is None else "inproc",
            # Wire-clock storms (every out-of-proc storm now): verdict
            # counters are deterministic and live in the swarm counters;
            # ``remote`` below carries only transport noise.
            "wire_clock": self.wire_clock,
            "requests": self.swarm.counters.get("swarm.storm_requests"),
            # The real-caller election bound, surfaced: gates sampling
            # "real folds" must read the bound they sampled under, and
            # how many cohort members it clipped to columnar modeling.
            "clients_per_doc_bound":
                self.swarm.spec.storm_clients_per_doc,
            "elected": self.elected,
            "cohort_clipped": self.clipped,
            "served": self._count("swarm.storm_served"),
            "warm": self._count("swarm.storm_warm"),
            "stream": self._count("swarm.storm_stream"),
            "folds": folds,
            "shed": shed,
            "degraded": degraded,
            "retries": (self._count("swarm.storm_retries")
                        + self.remote.get("swarm.storm_retries", 0)),
            "fold_errors": (self._count("swarm.storm_fold_errors")
                            + self.remote.get("swarm.storm_fold_errors",
                                              0)),
            "shed_rate": (round(shed / lane_total, 4)
                          if lane_total else None),
            "latency_p50_ticks": float(percentile(lat, 0.50)),
            "latency_p99_ticks": float(percentile(lat, 0.99)),
            "latency_samples": len(lat),
            "tiers": self._tier_stats(),
            "phase_tiers": self.phase_tiers,
        }
        # The cost_ema cross-check is part of the
        # storm VERDICT: a storm that shed must have audited (or
        # explicitly skipped, taint recorded) at least one snapshot; a
        # server that stops shipping auditable snapshots fails loudly
        # instead of sailing through unchecked.
        if shed and not (self.ema_checks + self.ema_skips):
            raise AssertionError(
                f"{shed} shed verdict(s) carried no auditable admission "
                f"snapshot — the cost_ema cross-check never ran")
        out["ema_crosscheck"] = {
            "checks": self.ema_checks,
            "skipped": self.ema_skips,
            "tainted": self.ema_taint,
            "twin": {k: round(v, 6)
                     for k, v in sorted(self.ema_twin.items())},
        }
        if self.server is not None:
            out["admission"] = self.server.admission.snapshot()
            out["admission_control"] = \
                self.server.admission_control.snapshot()
        else:
            out["remote"] = dict(sorted(self.remote.items()))
        if self.streamfold is not None:
            out["streamfold"] = self.streamfold.stats()
        return out


class ClientSwarm:
    """The columnar client population plus the real service it drives.

    One instance = one run; :func:`run_swarm` is the entry point.

    ``device`` is where every catch-up fold of the run happens: the
    storm's ``OrderingServer``, the out-of-process shards (through the
    primary ``FrontDoor``) and the fold probe's ``CatchupService``.  It is
    checked first, before any server, shard or store exists: the default
    ``"cuda"`` raises without a card (pass ``device="cpu"`` for the plain
    folds).  It is not a spec field: the spec describes the run, the
    device only where its folds execute.
    """

    def __init__(self, spec: ScenarioSpec, *, device="cuda") -> None:
        self.device = resolve_device(device)
        self.spec = spec
        n, docs = spec.clients, spec.docs
        self.counters = CounterSet(
            "swarm.ops_submitted", "swarm.ops_stamped", "swarm.ops_deduped",
            "swarm.joins", "swarm.defers", "swarm.join_defers",
            "swarm.elections",
            "swarm.catchup_completions", "swarm.delivery_samples",
            "swarm.frames", "swarm.sink_fences", "swarm.kills",
            "swarm.replica_kills",
            # catch-up storm: deterministic for in-proc runs,
            # hence part of the replay-identity surface
            "swarm.storm_requests", "swarm.storm_served",
            "swarm.storm_warm", "swarm.storm_folds", "swarm.storm_shed",
            "swarm.storm_degraded", "swarm.storm_retries",
            "swarm.storm_fold_errors",
            # streaming-head serves: a catch-up answered from
            # the continuously-published summary index — no fold, no
            # admission
            "swarm.storm_stream",
        )
        # -- columnar per-client state (the whole point) ----------------
        idx = np.arange(n, dtype=np.int64)
        #: contiguous doc blocks: doc d owns clients [starts[d], starts[d+1])
        self.doc_of = (idx * docs // n).astype(np.int32)
        self.doc_starts = np.searchsorted(self.doc_of, np.arange(docs))
        self.state = np.zeros(n, dtype=np.int8)   # _UNBORN
        self.cursor = np.zeros(n, dtype=np.int64)
        self.client_seq = np.zeros(n, dtype=np.int64)
        self.op_count = np.zeros(n, dtype=np.int64)
        #: tree-collab: nodes each client has inserted so far — target
        #: ids for its sets/removes derive from this count, so every
        #: referenced id was inserted by the same client earlier in its
        #: own (sequencer-ordered) stream.
        self.tree_created = np.zeros(n, dtype=np.int64)
        self.next_fire = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        self.catchup_start = np.zeros(n, dtype=np.int64)
        self.lag_start = np.full(n, -1, dtype=np.int64)
        self.lag_end = np.full(n, -1, dtype=np.int64)
        # cadence: period ≈ active ticks / ops_per_client, jittered per
        # client so fires de-synchronize (independent of population)
        active = max(1, sum(p.ticks for p in self.spec.phases
                            if p.kind in ("steady", "herd", "laggards")))
        base = max(3, int(round(active / max(0.25, spec.ops_per_client))))
        jitter = _hash_clients(spec.seed, 11, idx) % np.uint64(base)
        self.period = (base + jitter.astype(np.int64)).astype(np.int64)
        # ramp schedule: spread connects over the FIRST ramp phase (or
        # connect everyone at tick 0 when the scenario has none)
        ramp_at, ramp_ticks = 0, 0
        at = 0
        for p in spec.phases:
            if p.kind == "ramp":
                ramp_at, ramp_ticks = at, p.ticks
                break
            at += p.ticks
        if ramp_ticks > 0:
            spread = _hash_clients(spec.seed, 13, idx) % np.uint64(ramp_ticks)
            self.connect_at = ramp_at + spread.astype(np.int64)
        else:
            self.connect_at = np.zeros(n, dtype=np.int64)
        #: precomputed wire client ids (also the JOIN batch payload)
        within = (idx - self.doc_starts[self.doc_of]).astype(np.int64)
        self.client_ids = [
            f"sw{spec.seed}-d{int(d):04d}-c{int(c)}"
            for d, c in zip(self.doc_of, within)
        ]
        # -- the real service -------------------------------------------
        self.injector = (FaultInjector(spec.plan)
                         if spec.plan is not None else None)
        self._cluster = None
        self._tmpdir = None
        #: attach-mode front doors over the primary's shard fleet
        #: (``spec.replicas`` > 1); the data path pins to the last one.
        self._replicas: list = []
        #: scheduled replica kills executed: ``(tick, door_index)``
        self.replica_kills: List[Tuple[int, int]] = []
        self._proc_taps: Dict[str, object] = {}
        self._proc_frames: Dict[str, set] = {}
        if spec.out_of_proc:
            # The REAL process tier: shard-host processes with per-shard
            # durable logs behind an in-process front door (the harness
            # drives its fault-plan tick and reads its stats directly).
            import os as _os
            import tempfile as _tempfile

            from ..drivers.network_driver import \
                NetworkDocumentServiceFactory
            from ..service.frontdoor import FrontDoor
            from ..service.procclient import ProcServiceClient

            base = spec.dir
            if base is None:
                self._tmpdir = _tempfile.mkdtemp(prefix="fluidproc-swarm-")
                base = self._tmpdir
            _os.makedirs(base, exist_ok=True)
            # Wire-clock admission: a storm's shards take the
            # virtual controller so every catchup verdict is a pure
            # function of request order + the vnow each request carries
            # — out-of-proc verdicts rejoin the replay-identity surface.
            shard_args: List[str] = []
            if spec.storm:
                max_inflight = (1 << 30 if spec.storm_never_shed
                                else spec.storm_max_inflight)
                shard_args += [
                    "--virtual-admission",
                    "--catchup-max-inflight", str(max_inflight),
                    "--catchup-degrade-after",
                    str(spec.storm_degrade_after)]
                if not spec.storm_never_shed:
                    shard_args += ["--catchup-hold",
                                   str(spec.storm_fold_ticks
                                       * spec.storm_tick_seconds)]
            self._cluster = FrontDoor(
                _os.path.join(base, "proc"), n_shards=spec.shards,
                spawn=spec.proc_spawn, faults=self.injector,
                shard_args=shard_args,
                request_timeout=5.0, device=self.device).start()
            try:
                # Additional front doors ATTACH to the primary's shard
                # fleet: shared-nothing replicas that agree on placement
                # only through the rendezvous router.  The primary stays
                # the supervisor (fault ticks, respawns); replicas never
                # terminate shards that are not theirs to stop.
                for _r in range(1, spec.replicas):
                    self._replicas.append(FrontDoor(
                        _os.path.join(base, "proc"), spawn="attach",
                        attach_addrs=self._cluster.shard_addrs(),
                        request_timeout=5.0, device=self.device).start())
                self.service = ProcServiceClient(
                    self._cluster, replicas=self._replicas)
                self.factory = NetworkDocumentServiceFactory(
                    port=self._cluster.port)
            except BaseException:
                # Construction failed AFTER the processes spawned: reap
                # them, or every failed setup leaks a live shard fleet.
                for door in self._replicas:
                    door.close()
                self._cluster.close()
                raise
        else:
            if spec.dir is not None:
                import os as _os

                _os.makedirs(spec.dir, exist_ok=True)
                oplog = OpLog(_os.path.join(spec.dir, "swarm-ops.jsonl"),
                              autoflush=True, faults=self.injector)
            else:
                oplog = OpLog(faults=self.injector)
            if spec.shards > 1:
                self.service = ShardedOrderingService(
                    n_shards=spec.shards, oplog=oplog,
                    faults=self.injector)
            else:
                self.service = LocalOrderingService(oplog=oplog)
            self.factory = LocalDocumentServiceFactory(self.service)
        self.loader = Loader(self.factory, clock=VirtualClock())
        self.broadcaster = Broadcaster()
        self._sink = _SwarmSink(self.counters)
        # -- per-doc bookkeeping ----------------------------------------
        self.doc_ids = [spec.doc_id(d) for d in range(docs)]
        self.head_arr = np.zeros(docs, dtype=np.int64)
        #: per doc: tick each seq was stamped at (index seq-1)
        self.stamp_ticks: List[List[int]] = [[] for _ in range(docs)]
        #: per doc: seqs (exclusive floor) already sampled for delivery
        self.delivered_floor = np.zeros(docs, dtype=np.int64)
        self.delivery_lat: List[int] = []
        self.catchup_lat: List[int] = []
        self.max_pending_depth = 0
        self.defers: List[tuple] = []
        self.join_defers: List[tuple] = []
        self.kills: List[tuple] = []
        self.pending: Dict[int, List[RawOperation]] = {}
        self._scripted = {(t, d): k for t, d, k in spec.scripted_defers}
        self._scripted_joins = {(t, d): k
                                for t, d, k in spec.scripted_join_defers}
        self.sampled = [d for d in range(docs)
                        if d % max(1, spec.sample_every) == 0]
        self._doc_index = {doc_id: d
                           for d, doc_id in enumerate(self.doc_ids)}
        #: ingress-stage wall/byte accounting (outside replay identity)
        self.ingress = IngressMeter()
        #: catch-up storm driver (None unless spec.storm)
        self._storm = _CatchupStorm(self) if spec.storm else None

    # -- setup -----------------------------------------------------------------

    def _build(self, rt) -> None:
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")
        ds.create_channel("counter-tpu", "count")
        if self.spec.tree_ops:
            ds.create_channel("tree-tpu", "tree")

    def setup(self) -> None:
        """Create every document through the real Loader (attach summary
        with the three channels), then close the boot client — swarm
        clients JOIN the quorum directly, they never materialize
        containers.  Broadcast sinks attach to the SAMPLED documents
        only (the per-message fan-out consumers the oracle verifies);
        the rest of the population models consumption columnar with no
        live subscribers — exactly the shape that lets the columnar
        ingress skip per-message materialization.  The topology is
        mode-independent, so columnar-on and columnar-off runs count
        identical frames."""
        sampled = set(self.sampled)
        for d, doc_id in enumerate(self.doc_ids):
            c = self.loader.create(doc_id, f"boot-{doc_id}", self._build)
            c.drain()
            c.close()
            if d in sampled:
                if self.spec.out_of_proc:
                    self._tap_proc_doc(doc_id)
                else:
                    self.broadcaster.attach(doc_id,
                                            self.service.endpoint(doc_id),
                                            self._sink)
        if isinstance(self.service, ShardedOrderingService):
            self.service.add_fence_listener(
                lambda _sid, docs, epoch: [
                    self.broadcaster.refence(
                        doc, self.service.endpoint(doc), epoch)
                    for doc in docs
                ]
            )
        self._sync_heads(range(self.spec.docs), tick=0)

    def _tap_proc_doc(self, doc_id: str) -> None:
        """Out-of-proc sampled doc: a LIVE broadcast tap through the
        front-door relay (the real per-message fan-out consumer — the
        shard serves these docs boxed, exactly the in-proc topology).
        Delivery is async wall-time, so the unique-seq accounting lands
        in ``shard_stats`` (outside replay identity)."""
        conn = self.factory.resolve(doc_id).connection()
        seen = self._proc_frames.setdefault(doc_id, set())
        conn.subscribe(lambda msg, s=seen: s.add(msg.seq))
        self._proc_taps[doc_id] = conn

    def _sync_heads(self, doc_indices, tick: int) -> None:
        """Record stamp ticks for every new seq and refresh head_arr.
        Out-of-proc services read heads in ONE bulk RPC (grouped by
        owning shard) instead of one round-trip per document."""
        doc_indices = list(doc_indices)
        ids = [self.doc_ids[d] for d in doc_indices]
        bulk = getattr(self.service, "heads", None)
        heads = (bulk(ids) if bulk is not None
                 else {i: self.service.oplog.head(i) for i in ids})
        for d, doc_id in zip(doc_indices, ids):
            head = heads[doc_id]
            ticks = self.stamp_ticks[d]
            if head > len(ticks):
                ticks.extend([tick] * (head - len(ticks)))
            self.head_arr[d] = head

    # -- per-tick steps --------------------------------------------------------

    def _defer_joins(self, t: int, d: int, members: np.ndarray,
                     joined: int) -> None:
        self.connect_at[members[joined:]] = t + 1
        self.join_defers.append((t, d, joined))
        self.counters.bump("swarm.join_defers")

    def _connect_due(self, t: int) -> None:
        """Batched JOINs for every client whose ramp slot is this tick,
        one ``connect_many`` per document.  A mid-batch failure (injected
        durable fault) defers the unjoined suffix to the next tick — the
        JOIN count is read back from the durable head (one message per
        JOIN), the same whole-truth the oracle twin's scripted mirror
        replays."""
        due = np.flatnonzero((self.state == _UNBORN)
                             & (self.connect_at == t))
        if due.size == 0:
            return
        touched = []
        joined_chunks = []
        session = f"sw{self.spec.seed}"
        # due is ascending and doc blocks are contiguous in client index,
        # so per-doc cohorts are contiguous runs — boundary scan instead
        # of a per-doc mask over the whole due set.
        docs_due = self.doc_of[due]
        cuts = np.flatnonzero(np.diff(docs_due)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [due.size]])
        with self.service.oplog.batch():  # JOINs group-commit like ops
            for s, e in zip(starts.tolist(), ends.tolist()):
                d = int(docs_due[s])
                members = due[s:e]
                ids = [self.client_ids[i] for i in members.tolist()]
                doc_id = self.doc_ids[d]
                endpoint = self.service.endpoint(doc_id)
                connect = (endpoint.connect_columns if self.spec.columnar
                           else endpoint.connect_many)
                k = self._scripted_joins.get((t, d))
                with self.ingress.timed():
                    if k is not None:
                        connect(ids[:k], session)
                        self._defer_joins(t, d, members, k)
                        joined = members[:k]
                    else:
                        before = self.service.oplog.head(doc_id)
                        try:
                            connect(ids, session)
                            joined = members
                        except (ConnectionError, OSError):
                            landed = (self.service.oplog.head(doc_id)
                                      - before)
                            self._defer_joins(t, d, members, landed)
                            joined = members[:landed]
                touched.append(d)
                if joined.size:
                    joined_chunks.append(joined)
                    self.counters.bump("swarm.joins", int(joined.size))
                    if self.spec.columnar:
                        self.ingress.columnar_ops += int(joined.size)
                    else:
                        self.ingress.boxed_ops += int(joined.size)
        self._sync_heads(touched, t)
        if not joined_chunks:
            return
        now = np.concatenate(joined_chunks)
        self.state[now] = _STEADY
        self.cursor[now] = self.head_arr[self.doc_of[now]]
        h = _hash_clients(self.spec.seed, 17, now)
        self.next_fire[now] = (
            t + 1 + (h % self.period[now].astype(np.uint64)).astype(np.int64)
        )

    def _fire(self, t: int):
        """Columnar decision core shared by both ingress modes: who fires
        this tick and what each op is — every column derived from the
        counter-based hash, population state stepped vectorized.  Returns
        ``None`` or ``(firing, kind_code, key_i, value, ch_i)`` where
        ``kind_code`` is the closed wire vocabulary and ``value`` carries
        the set value / increment delta."""
        firing = np.flatnonzero(
            ((self.state == _STEADY) | (self.state == _LAGGARD))
            & (self.next_fire <= t))
        if firing.size == 0:
            return None
        self.next_fire[firing] = t + self.period[firing]
        h = _hash_clients(self.spec.seed, 19, firing,
                          extra=self.op_count[firing])
        kind = (h % np.uint64(100)).astype(np.int64)
        key_i = ((h >> np.uint64(8)) % np.uint64(32)).astype(np.int64)
        val = ((h >> np.uint64(16)) % np.uint64(1000)).astype(np.int64)
        ch_i = ((h >> np.uint64(24)) % np.uint64(26)).astype(np.int64)
        self.op_count[firing] += 1
        self.client_seq[firing] += 1
        self.counters.bump("swarm.ops_submitted", int(firing.size))
        kind_code = np.where(
            kind < 60, COL_KIND_SET,
            np.where(kind < 85, COL_KIND_INCREMENT, COL_KIND_INSERT)
        ).astype(np.int8)
        delta = val % 7 - 3
        delta[delta == 0] = 1
        value = np.where(kind_code == COL_KIND_INCREMENT, delta, val)
        return firing, kind_code, key_i, value, ch_i

    def _tree_edit(self, i: int, k: int, key_i: int, value: int,
                   ch_i: int) -> dict:
        """One client's tree changeset for this fire: the columnar plan's
        (kind, key, value, char) columns mapped onto id-addressed edits.
        Inserts mint ``{client}-n{count}`` leaf ids (globally unique by
        construction); sets/removes target the client's OWN earlier
        inserts — removing an already-removed id is the first-remover-
        wins no-op, setting a purged id the oracle's silent drop, both
        byte-exact on the device fold."""
        created = int(self.tree_created[i])
        cid = self.client_ids[i]
        if k == COL_KIND_INSERT or created == 0:
            nid = f"{cid}-n{created}"
            self.tree_created[i] = created + 1
            return {"kind": "insert", "parent": "",
                    "field": f"f{ch_i % 2}", "anchor": None,
                    "content": [{"id": nid, "type": "n", "value": value}]}
        target = f"{cid}-n{key_i % created}"
        if k == COL_KIND_SET:
            return {"kind": "set", "id": target, "value": value}
        return {"kind": "remove", "ids": [target]}

    def _generate_ops(self, t: int) -> Dict[int, List[RawOperation]]:
        """Boxed ingress (``columnar=False`` — the parity oracle — and
        ALL ``tree_ops`` traffic, whose changesets live outside the
        closed columnar vocabulary): the same columnar plan,
        materialized per op into dict + RawOperation envelopes before
        submission."""
        out: Dict[int, List[RawOperation]] = {}
        fired = self._fire(t)
        if fired is None:
            return out
        firing, kind_code, key_i, value, ch_i = fired
        docs = self.doc_of[firing]
        seqs = self.client_seq[firing]
        refs = self.cursor[firing]
        tree_mode = self.spec.tree_ops
        for j, i in enumerate(firing.tolist()):
            k = int(kind_code[j])
            if tree_mode:
                contents = {"edits": [self._tree_edit(
                    i, k, int(key_i[j]), int(value[j]), int(ch_i[j]))]}
                channel = "tree"
            elif k == COL_KIND_SET:
                contents = {"kind": "set", "key": key_string(int(key_i[j])),
                            "value": int(value[j])}
                channel = "kv"
            elif k == COL_KIND_INCREMENT:
                contents = {"kind": "increment", "delta": int(value[j])}
                channel = "count"
            else:
                contents = {"kind": "insert", "pos": 0,
                            "text": CHAR_STRINGS[int(ch_i[j])]}
                channel = "text"
            sub = {"clientSeq": int(seqs[j]), "refSeq": int(refs[j]),
                   "ds": "ds", "channel": channel, "contents": contents}
            op = RawOperation(
                client_id=self.client_ids[i],
                client_seq=int(seqs[j]),
                ref_seq=int(refs[j]),
                type=MessageType.OP,
                contents={"type": "groupedBatch", "v": BATCH_WIRE_VERSION,
                          "ops": [sub]},
            )
            out.setdefault(int(docs[j]), []).append(op)
        return out

    def _plan_columns(self, t: int) -> Optional[ColumnBatch]:
        """Columnar ingress plan: this tick's ops as ONE
        :class:`ColumnBatch` over the swarm's shared doc/client tables —
        zero per-op Python objects.  Rows are client-index ascending, so
        ``doc_index`` is non-decreasing (contiguous per-doc runs)."""
        fired = self._fire(t)
        if fired is None:
            return None
        firing, kind_code, key_i, value, ch_i = fired
        return ColumnBatch(
            doc_index=self.doc_of[firing].astype(np.int32, copy=False),
            client_index=firing.astype(np.int32),
            client_seq=self.client_seq[firing],
            ref_seq=self.cursor[firing],
            kind=kind_code,
            key_index=key_i.astype(np.int16),
            value=value.astype(np.int64, copy=False),
            char_index=ch_i.astype(np.int16),
            doc_ids=self.doc_ids,
            client_ids=self.client_ids,
            v=BATCH_WIRE_VERSION,
        )

    def _tick_ingress(self, t: int) -> List[int]:
        """One tick's ingress through the mode-selected wire path.  The
        ingress meter covers the WHOLE swarm→sequencer leg — op
        planning/boxing, wire encode/decode, and batch stamping — which
        is the per-op cost the columnar path exists to kill."""
        if not self.spec.columnar or self.spec.tree_ops:
            # tree-collab always boxes: changesets are outside the
            # closed columnar vocabulary — the documented fallback.
            with self.ingress.timed():
                ops = self._generate_ops(t)
            return self._submit(t, ops)
        with self.ingress.timed():
            batch = self._plan_columns(t)
        if batch is None:
            return self._submit(t, {})
        # Ship through the REAL wire: struct-pack to framed bytes and
        # decode back (tables compacted to the referenced entries) — the
        # gated runs measure the full encode→bytes→decode→stamp path,
        # not an in-process shortcut.
        with self.ingress.timed():
            data = column_batch_to_bytes(batch)
            wire_batch = column_batch_from_bytes(data)
        self.ingress.encode_bytes += len(data)
        self.ingress.decode_bytes += len(data)
        self.ingress.batches += 1
        # Contiguous per-doc row runs (rows are client-index ascending).
        di = wire_batch.doc_index
        cuts = np.flatnonzero(np.diff(di)) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [di.shape[0]]])
        doc_rows = {
            wire_batch.doc_ids[int(di[s])]: np.arange(s, e, dtype=np.int64)
            for s, e in zip(starts.tolist(), ends.tolist())
        }
        return self._submit(t, {}, batch=wire_batch, doc_rows=doc_rows)

    def _submit(self, t: int, new_ops: Dict[int, List[RawOperation]],
                batch: Optional[ColumnBatch] = None,
                doc_rows: Optional[Dict[str, np.ndarray]] = None
                ) -> List[int]:
        """Submit this tick's batches (deferred batches first) through the
        service's batched ingress; record deferrals — from real mid-batch
        failures or from the oracle twin's scripted mirror — for the next
        tick's whole-batch resubmit.

        Columnar mode hands this tick's ops as ``(batch, doc_rows)``:
        documents with no complications ride ``submit_columns`` as raw
        row slices; a document that carries a deferred batch or a
        scripted split this tick MATERIALIZES its rows (boxed fallback)
        so the pending-first op order and the split bookkeeping stay
        byte-identical to the boxed mode.  Both submit calls share one
        group commit."""
        full: Dict[int, List[RawOperation]] = {}
        for d, ops in self.pending.items():
            full[d] = list(ops)
        for d, ops in new_ops.items():
            full.setdefault(d, []).extend(ops)
        col_rows: Dict[str, np.ndarray] = {}
        if doc_rows:
            for doc_id, rows in doc_rows.items():
                d = self._doc_index[doc_id]
                if d in full or (t, d) in self._scripted:
                    full.setdefault(d, []).extend(
                        batch.materialize(int(i)) for i in rows.tolist())
                else:
                    col_rows[doc_id] = rows
        if not full and not col_rows:
            self.pending = {}
            return []
        submit: Dict[str, List[RawOperation]] = {}
        defer_now: Dict[int, List[RawOperation]] = {}
        for d in sorted(full):
            k = self._scripted.get((t, d))
            if k is None:
                submit[self.doc_ids[d]] = full[d]
            else:
                # Oracle-twin mirror of a recorded deferral: stamp the
                # same prefix this tick, re-run the whole batch next tick
                # (dedup absorbs the prefix — identical to the faulted
                # run's recovery), so both logs split identically.
                submit[self.doc_ids[d]] = full[d][:k]
                defer_now[d] = full[d]
                self.defers.append((t, d, k))
                self.counters.bump("swarm.defers")
        with self.ingress.timed():
            # ONE service call, ONE group commit, ONE globally sorted
            # per-doc order across both shapes: occurrence-indexed fault
            # schedules must fire on the same op in either mode.
            outcomes = self.service.submit_mixed(submit, batch, col_rows)
        self.ingress.boxed_ops += sum(len(ops) for ops in submit.values())
        self.ingress.columnar_ops += sum(
            int(r.shape[0]) for r in col_rows.values())
        touched = sorted(set(full)
                         | {self._doc_index[x] for x in col_rows})
        for d in touched:
            doc_id = self.doc_ids[d]
            outcome = outcomes[doc_id]
            self.counters.bump("swarm.ops_stamped", outcome.n_stamped())
            self.counters.bump(
                "swarm.ops_deduped",
                outcome.consumed - outcome.n_stamped()
                if outcome.error is None else 0)
            if outcome.error is not None:
                if d in full:
                    defer_now[d] = full[d]
                else:
                    # Deferral recovery round-trips through the boxed
                    # fallback: the rows materialize ONCE here and
                    # resubmit as a plain pending batch next tick.
                    defer_now[d] = [batch.materialize(int(i))
                                    for i in col_rows[doc_id].tolist()]
                consumed = outcome.consumed
                if consumed < 0:
                    # Out-of-proc "shard died mid-batch": the exact
                    # consumed count died with the process — the durable
                    # head (read from the adopted owner) is the whole
                    # truth, same as the JOIN-deferral readback.
                    consumed = max(0, self.service.oplog.head(doc_id)
                                   - int(self.head_arr[d]))
                self.defers.append((t, d, consumed))
                self.counters.bump("swarm.defers")
        self.pending = defer_now
        self._sync_heads(touched, t)
        return touched

    def _drive_faults(self, t: int) -> None:
        """Scheduled fault execution: in-proc shard kills and (out of
        proc) real process kills/hangs both ride the service's ``tick``
        driver — the router diff is the mode-independent kill record."""
        if self.injector is None:
            return
        # Replica kills are the SWARM's to execute: the front-door fleet
        # is harness topology the primary's tick driver knows nothing
        # about.  SIGKILL semantics for an in-process door: kill() tears
        # the pump down with nothing flushed — wire-indistinguishable
        # from the process dying — and the newest LIVE replica is always
        # the victim, because that is the door the data path pins to.
        for point in self.injector.due("replica.kill", t):
            victim = next(
                (i for i in range(len(self._replicas) - 1, -1, -1)
                 if not self._replicas[i].killed), None)
            if victim is None:
                self.injector.mark_unfired(point)
                continue
            self._replicas[victim].kill()
            self.replica_kills.append((t, victim))
            self.counters.bump("swarm.replica_kills")
        router = getattr(self.service, "router", None)
        tick = getattr(self.service, "tick", None)
        if router is None or tick is None:
            return
        before = set(router.dead())
        affected = tick(t)
        newly = [s for s in router.dead() if s not in before]
        if newly:
            self.kills.append((t, newly[0], len(affected)))
            self.counters.bump("swarm.kills")

    def _election(self, t: int) -> None:
        """Service-side summarizer pass over the sampled documents: load
        read-only at the durable head, upload the summary — mid-run late
        joiners (and the final verification) then load summary + tail
        through the real catch-up path."""
        for d in self.sampled:
            doc_id = self.doc_ids[d]
            ro = self.loader.resolve(doc_id)
            self.service.storage.upload(doc_id, ro.runtime.summarize(),
                                        ro.runtime.ref_seq)
            ro.close()
            self.counters.bump("swarm.elections")

    def _consume(self, t: int, final: bool = False) -> None:
        """Columnar consumption: steady clients that fired this tick
        drain to the head; catch-up clients advance ``catchup_rate`` per
        tick and complete when they reach it.  ``final`` drains everyone
        (the end-of-run quiescence)."""
        heads = self.head_arr[self.doc_of]
        if final:
            drain = np.flatnonzero(self.state == _STEADY)
        else:
            drain = np.flatnonzero((self.state == _STEADY)
                                   & (self.next_fire == t + self.period))
        self.cursor[drain] = heads[drain]
        catching = np.flatnonzero(self.state == _CATCHUP)
        if catching.size:
            self.cursor[catching] = np.minimum(
                heads[catching],
                self.cursor[catching] + self.spec.catchup_rate)
            done = catching[self.cursor[catching] >= heads[catching]]
            if done.size:
                self.catchup_lat.extend(
                    (t - self.catchup_start[done]).tolist())
                self.state[done] = _STEADY
                h = _hash_clients(self.spec.seed, 23, done)
                self.next_fire[done] = (
                    t + 1
                    + (h % self.period[done].astype(np.uint64)).astype(
                        np.int64))
                self.counters.bump("swarm.catchup_completions",
                                   int(done.size))
        connected = self.state != _UNBORN
        if connected.any():
            depth = int((heads - self.cursor)[connected].max())
            self.max_pending_depth = max(self.max_pending_depth, depth)

    def _sample_delivery(self, t: int, final: bool = False) -> None:
        """Advance each document's delivered floor to the slowest steady
        client's cursor and sample one latency per newly-covered seq."""
        docs = self.spec.docs
        masked = np.where(self.state == _STEADY, self.cursor,
                          np.iinfo(np.int64).max)
        mins = np.minimum.reduceat(masked, self.doc_starts)
        counts = np.add.reduceat((self.state == _STEADY).astype(np.int64),
                                 self.doc_starts)
        floors = np.where(counts > 0, np.minimum(mins, self.head_arr),
                          self.delivered_floor)
        if final:
            floors = self.head_arr.copy()
        for d in range(docs):
            lo, hi = int(self.delivered_floor[d]), int(floors[d])
            if hi > lo:
                ticks = self.stamp_ticks[d]
                self.delivery_lat.extend(t - s for s in ticks[lo:hi])
                self.delivered_floor[d] = hi
                self.counters.bump("swarm.delivery_samples", hi - lo)

    def _phase_transitions(self, t: int, phase: Phase,
                           phase_start: int) -> None:
        n = self.spec.clients
        idx = np.arange(n, dtype=np.int64)
        if phase.kind == "herd":
            if t == phase_start and phase.frac > 0:
                h = _hash_clients(self.spec.seed, 29 + phase_start, idx)
                cohort = np.flatnonzero(
                    (self.state == _STEADY)
                    & ((h % np.uint64(1000)).astype(np.int64)
                       < int(phase.frac * 1000)))
                self.state[cohort] = _DARK
            if t == phase_start + phase.ticks - 1:
                dark = np.flatnonzero(self.state == _DARK)
                self.state[dark] = _CATCHUP
                self.catchup_start[dark] = t
                if self._storm is not None:
                    # THE storm: the whole re-entry herd forms at once —
                    # its elected real callers all fire next tick.
                    self._storm.enlist(t + 1, dark)
        elif phase.kind == "laggards":
            if t == phase_start and phase.frac > 0:
                h = _hash_clients(self.spec.seed, 31 + phase_start, idx)
                cohort = np.flatnonzero(
                    (self.state == _STEADY)
                    & ((h % np.uint64(1000)).astype(np.int64)
                       < int(phase.frac * 1000)))
                h2 = _hash_clients(self.spec.seed, 37, cohort)
                span = max(2, phase.ticks // 2)
                start = t + (h2 % np.uint64(span)).astype(np.int64)
                length = 1 + (
                    (h2 >> np.uint64(17)) % np.uint64(span)).astype(np.int64)
                self.lag_start[cohort] = start
                self.lag_end[cohort] = np.minimum(
                    start + length, t + phase.ticks - 1)
            starting = np.flatnonzero((self.state == _STEADY)
                                      & (self.lag_start == t))
            self.state[starting] = _LAGGARD
            ending = np.flatnonzero((self.state == _LAGGARD)
                                    & (self.lag_end == t))
            self.state[ending] = _CATCHUP
            self.catchup_start[ending] = t
            if self._storm is not None and ending.size:
                # Staggered re-entries storm too — smaller waves that
                # keep the fold lane warm between herd spikes.
                self._storm.enlist(t + 1, ending)

    # -- the run ---------------------------------------------------------------

    def run(self) -> SwarmResult:
        self.setup()
        t = 0
        phase_counters: Dict[str, Dict[str, int]] = {}
        for p_i, phase in enumerate(self.spec.phases):
            phase_start = t
            since = self.counters.snapshot()
            if phase.kind == "election":
                self._election(t)
            for _ in range(phase.ticks):
                self._phase_transitions(t, phase, phase_start)
                self._connect_due(t)
                self._tick_ingress(t)
                self._drive_faults(t)
                if self._storm is not None:
                    self._storm.step(t)
                self._consume(t)
                self._sample_delivery(t)
                t += 1
            phase_counters[f"{p_i}:{phase.kind}"] = \
                self.counters.delta(since)
            if self._storm is not None:
                self._storm.phase_mark(f"{p_i}:{phase.kind}")
        # Quiescence: land any deferred JOIN cohorts and batches
        # (fault-free tail), then drain every client to the head.
        for _round in range(8):
            if not self.pending and not np.any(self.state == _UNBORN):
                break
            t += 1
            self._connect_due(t)
            self._submit(t, {})
        if self.pending or np.any(self.state == _UNBORN):
            raise AssertionError(
                f"swarm never drained its deferred work: "
                f"pending={sorted(self.pending)} "
                f"unborn={int(np.count_nonzero(self.state == _UNBORN))}")
        catching = np.flatnonzero((self.state == _CATCHUP)
                                  | (self.state == _DARK)
                                  | (self.state == _LAGGARD))
        if catching.size:
            self.catchup_start[catching] = np.where(
                self.state[catching] == _CATCHUP,
                self.catchup_start[catching], t)
            self.state[catching] = _CATCHUP
        while int(np.count_nonzero(self.state == _CATCHUP)) \
                or (self._storm is not None and self._storm.pending()):
            t += 1
            if self._storm is not None:
                # Paced retries land beyond the scripted phases: keep
                # serving until the whole storm drained (bounded by the
                # driver's MAX_ATTEMPTS guard — zero unbounded queueing).
                self._storm.step(t)
            self._consume(t)
            self._sample_delivery(t)
        self._consume(t, final=True)
        self._sample_delivery(t, final=True)
        return self._result(t, phase_counters)

    def _result(self, t: int,
                phase_counters: Dict[str, Dict[str, int]]) -> SwarmResult:
        bulk = getattr(self.service, "heads", None)
        per_doc_head = (bulk(self.doc_ids) if bulk is not None
                        else {doc: self.service.oplog.head(doc)
                              for doc in self.doc_ids})
        # O(log entries), not O(messages): columnar segments verify by
        # boundary (their seqs are an arange by construction).  Out-of-
        # proc services answer in bulk RPCs grouped by owning shard.
        bulk_contig = getattr(self.service, "contiguous", None)
        if bulk_contig is not None:
            broken = sorted(doc for doc, ok in
                            bulk_contig(self.doc_ids).items() if not ok)
            if broken:
                raise AssertionError(
                    f"seq numbers not contiguous: {broken}")
        else:
            for doc in self.doc_ids:
                if not self.service.oplog.is_contiguous(doc):
                    raise AssertionError(
                        f"{doc} seq numbers not contiguous")
        digests = {}
        for d in self.sampled:
            ro = self.loader.resolve(self.doc_ids[d])
            digests[self.doc_ids[d]] = ro.runtime.summarize().digest()
            ro.close()
        counters = self.counters.snapshot()
        for k, v in sorted(self.broadcaster.stats().items()):
            counters[f"broadcast.{k}"] = v
        delivery = sorted(self.delivery_lat)
        catchup = sorted(self.catchup_lat)
        return SwarmResult(
            name=self.spec.name,
            seed=self.spec.seed,
            clients=self.spec.clients,
            docs=self.spec.docs,
            shards=self.spec.shards,
            ticks=t,
            sequenced_ops=sum(per_doc_head.values()),
            ops_stamped=counters["swarm.ops_stamped"],
            ops_submitted=counters["swarm.ops_submitted"],
            ops_deduped=counters["swarm.ops_deduped"],
            joins=counters["swarm.joins"],
            delivery_p50_ticks=float(percentile(delivery, 0.50)),
            delivery_p99_ticks=float(percentile(delivery, 0.99)),
            delivery_samples=len(delivery),
            catchup_p50_ticks=float(percentile(catchup, 0.50)),
            catchup_p99_ticks=float(percentile(catchup, 0.99)),
            catchup_samples=len(catchup),
            max_pending_depth=self.max_pending_depth,
            defers=tuple(self.defers),
            join_defers=tuple(self.join_defers),
            kills=tuple(self.kills),
            replica_kills=tuple(self.replica_kills),
            per_doc_head=per_doc_head,
            sampled_digests=digests,
            fault_counts=(self.injector.snapshot()
                          if self.injector is not None else {}),
            counters=counters,
            phase_counters=phase_counters,
            ingress=self.ingress.snapshot(),
            shard_stats=self._shard_stats(per_doc_head),
            fold_tier=(self._fold_probe()
                       if self.spec.fold_probe else {}),
            storm=(self._storm.summary()
                   if self._storm is not None else {}),
        )

    def _fold_probe(self) -> Dict[str, object]:
        """Close the loop between the swarm engine and the
        device fold — catch the SAMPLED documents up twice through a
        real CatchupService (tier 1 off, so the warm pass re-folds
        through the pack / device-resident / delta tiers instead of
        serving a memoized tree) and report the fold-tier counters.  The
        cold pass fills the tiers from the swarm's real op logs; the
        warm pass must serve resident (``device_cache["served"]``) and
        delta-download (``delta_cache["served"]``) hits with the h2d
        upload collapsed to zero pack bytes.  Wall-derived, hence
        outside replay identity."""
        if self._cluster is not None:
            return {"skipped": "out-of-proc"}
        from ..service.catchup import CatchupService

        svc = CatchupService(self.service, mesh=None, cache=None,
                             device=self.device)
        ids = [self.doc_ids[d] for d in self.sampled]
        svc.catch_up(ids, upload=False)  # cold: the tiers fill
        stats: dict = {}
        svc.catch_up(ids, upload=False, stats=stats)  # warm: tiers serve
        stage = svc.pipeline_stage
        return {
            "docs": len(ids),
            "device_cache": (svc.device_cache.stats()
                             if svc.device_cache is not None else None),
            "delta_cache": (svc.delta_cache.stats()
                            if svc.delta_cache is not None else None),
            "pack_cache": (svc._pack_cache.stats()
                           if svc._pack_cache is not None else None),
            # The second kernel family's tiers — live on
            # tree-collab runs, zero-traffic otherwise.
            "tree_device_cache": (
                svc.tree_device_cache.stats()
                if svc.tree_device_cache is not None else None),
            "tree_pack_cache": (
                svc.tree_pack_cache.stats()
                if svc.tree_pack_cache is not None else None),
            "host_channels": stats.get("hostChannels", 0),
            "fallback_channels": stats.get("fallbackChannels", 0),
            "h2d_bytes": int(stage.get("h2d_bytes", 0)),
            "d2h_bytes": int(stage.get("d2h_bytes", 0)),
        }

    def _shard_stats(self, per_doc_head: Dict[str, int]) -> Dict[str, object]:
        """Out-of-proc only: per-shard ``stats`` RPC pulls + the live-tap
        delivery audit (unique seqs relayed to the swarm's sampled-doc
        subscriptions — async wall-time, hence outside identity)."""
        if self._cluster is None:
            return {}
        return {
            "cluster": self.service.stats(),
            "doors": 1 + len(self._replicas),
            "door_failovers": self.service.door_failovers,
            "replica_pumps": [door.stats().get("pump")
                              for door in self._replicas],
            "tap_unique_frames": {doc: len(seen) for doc, seen
                                  in sorted(self._proc_frames.items())},
            "tap_heads": {doc: per_doc_head[doc]
                          for doc in sorted(self._proc_frames)},
        }

    def close(self) -> None:
        """Tear the run down: out-of-proc clusters terminate their shard
        processes (SIGTERM → drain-and-seal) and temp deployments are
        removed; in-proc runs have nothing to release."""
        if self._cluster is None:
            return
        try:
            self.factory.close()
        except OSError:
            pass
        self.service.close()
        for door in self._replicas:
            if not door.killed:
                door.close()
        self._replicas = []
        self._cluster.close()
        self._cluster = None
        if self._tmpdir is not None:
            import shutil

            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None


def run_swarm(spec: ScenarioSpec, *, device="cuda") -> SwarmResult:
    """Drive one scenario end to end; pure function of ``spec`` (modulo
    the wall-derived ``ingress``/``shard_stats`` fields), its folds on
    ``device`` (see :class:`ClientSwarm`).  Out-of-proc runs always
    release their shard processes, success or not."""
    swarm = ClientSwarm(spec, device=device)
    try:
        return swarm.run()
    finally:
        swarm.close()


def oracle_spec(spec: ScenarioSpec, result: SwarmResult) -> ScenarioSpec:
    """The fault-free single-shard IN-PROCESS twin of a completed run:
    same seed and phases, no faults, no processes, with the run's
    recorded op/JOIN deferrals replayed as scripted splits so both runs
    stamp byte-identical logs.  For an out-of-proc run this is the
    strongest cross-validation in the repo: a process tier under real
    SIGKILLs must land byte-identical per-document state to a single
    in-memory orderer."""
    return dataclasses.replace(
        spec,
        shards=1,
        plan=None,
        dir=None,
        out_of_proc=False,
        replicas=1,
        # The storm twin is the NEVER-SHED oracle: unlimited
        # admission, no modeled fold hold — every shed/degraded client
        # of the real run must converge byte-identically to it.
        storm_never_shed=True,
        scripted_defers=tuple(result.defers),
        scripted_join_defers=tuple(result.join_defers),
    )


def run_swarm_with_oracle(spec: ScenarioSpec, *, device="cuda"
                          ) -> Tuple[SwarmResult, SwarmResult]:
    """THE acceptance harness: run ``spec`` (shards, faults and all),
    then re-drive the identical scenario FAULT-FREE on a single shard —
    see :func:`oracle_spec` — and return ``(result, oracle)``.  Callers
    assert ``sampled_digests`` and ``per_doc_head`` equal: failovers and
    injected faults may cost deferrals and recoveries, never state.
    Both runs fold on ``device``, checked once before the first."""
    device = resolve_device(device)
    result = run_swarm(spec, device=device)
    return result, run_swarm(oracle_spec(spec, result), device=device)
