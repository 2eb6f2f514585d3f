"""faultline: deterministic fault injection across the serving stack.

The blueprint's core contract (PAPER.md §0) — ops are appended durably,
then broadcast; the log, not the live push, is the guarantee — is only as
real as the failure modes that have actually been exercised.  This module
is the substrate: a seeded, plan-driven injector whose hooks are threaded
through the REAL seams of the stack, so any failure scenario is a pure
function of ``(seed, plan)`` and replays bit-identically:

- ``OpLog.append``/``flush``        — fail, torn partial write, skipped
  fsync (``oplog.append`` / ``oplog.flush``);
- ``FileSummaryStorage`` store/read — fail, torn pre-rename tmp write,
  stale ``latest`` serve (``storage.store`` / ``storage.read``);
- ``_RpcClient`` send/recv          — fail, drop, delay (one-frame
  reorder), duplicate delivery, disconnect (``rpc.send`` / ``rpc.recv``);
- ``_ClientSession.write_frame``    — stall → broadcaster demotion
  (``session.write``);
- ``OrderingServer`` catchup fold   — fail, injected fold delay on the
  server's injected clock (``catchup.fail`` / ``catchup.slow``);
- ``ShardedOrderingService``        — shard kill at scheduled virtual
  ticks (``shard.kill``, driven by :meth:`FaultInjector.due`).

Matching is by **occurrence count** at a site (optionally scoped to one
document), never by wall clock: the Nth append is the Nth append on every
replay.  Every fire is counted in a thread-safe ``site:kind`` counter set
— the replay-identity surface the chaos oracle asserts on — and the plan
knows which of its points never fired (a scenario that claims coverage it
did not exercise fails loudly).

The injector raises :class:`FaultError` (an ``OSError``) for hard
failures, so every existing transient-transport path (the runtime
wire-drain's ConnectionError/OSError handling, ``RetryPolicy``'s default
retry set) treats injected faults exactly like real ones.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, List, Optional, Tuple

from ..utils.telemetry import LockedCounterSet


class FaultError(OSError):
    """An injected failure.  Subclasses OSError so the stack's existing
    transient-failure handling (wire-drain requeue, RetryPolicy's default
    ``retry_on``) takes it without special cases — the injected world must
    exercise the REAL recovery paths, not bespoke ones."""

    def __init__(self, site: str, kind: str, detail: str = "") -> None:
        super().__init__(
            f"injected fault at {site} ({kind})"
            + (f": {detail}" if detail else "")
        )
        self.site = site
        self.kind = kind


#: site -> kinds the seam at that site implements.  A plan naming an
#: unknown (site, kind) is a bug in the plan, not a silently-dead point.
SITES: Dict[str, Tuple[str, ...]] = {
    "oplog.append": ("fail", "torn"),
    "oplog.flush": ("fail", "skip_fsync"),
    "storage.store": ("fail", "torn"),
    "storage.read": ("fail", "stale"),
    "rpc.send": ("fail", "drop", "disconnect"),
    "rpc.recv": ("drop", "duplicate", "delay", "disconnect"),
    "session.write": ("stall",),
    "shard.kill": ("kill",),
    "client.stall": ("stall",),
    # fluidproc (out-of-process tier): the front door executes these
    # against REAL shard processes at scheduled virtual ticks —
    # ``proc.kill`` is SIGKILL (no drain, no seal; the per-shard log's
    # torn tail and the adoption path are the recovery under test),
    # ``proc.hang`` is SIGSTOP (the process is alive but silent; only
    # heartbeat-based death detection can notice, and the front door
    # SIGKILLs it before re-owning its documents — see SEMANTICS.md
    # "Deployment & migration").
    "proc.kill": ("kill",),
    "proc.hang": ("hang",),
    # ``replica.kill`` SIGKILLs a front-door REPLICA — the
    # door itself, not a shard — at a scheduled tick: every client
    # socket it held drops with nothing flushed, shards keep running,
    # and the swarm's adapter must fail over to a surviving door.  The
    # swarm executes this (the replica fleet is harness topology the
    # primary's tick driver never sees).
    "replica.kill": ("kill",),
    # Catch-up fold tier (the storm subsystem): fired by the
    # server's fold lane AFTER admission — ``catchup.fail`` raises out
    # of the fold (the single-flight finally-abandon, the admission
    # release, and the caller's retry policy are the recovery under
    # test), ``catchup.slow`` injects a fold delay of ``arg`` seconds
    # on the server's injected clock (virtual under a VirtualClock), so
    # the measured fold cost — and the load-derived shed pacing it
    # feeds — slows deterministically.
    "catchup.fail": ("fail",),
    "catchup.slow": ("delay",),
    # Streaming fold tier: ``stream.stall`` makes the
    # streaming service skip a whole poll round (the dirty docs stay
    # pending and the NEXT catch-up takes the ordinary cold-fold path —
    # the degradation under test), ``stream.crash`` raises out of the
    # per-doc fold mid-round (the service must swallow it, count it,
    # and leave the doc foldable later).  Log truncation crash points
    # mirror the shard migration style: ``oplog.truncate.seal`` fires
    # BEFORE the truncation marker is durable (a crash here leaves the
    # log byte-identical), ``oplog.truncate.drop`` fires AFTER the
    # marker is durable but BEFORE physical compaction (a crash here
    # must reopen to the same floor with the old bytes still present).
    "stream.stall": ("stall",),
    "stream.crash": ("fail",),
    "oplog.truncate.seal": ("fail",),
    "oplog.truncate.drop": ("fail",),
}

#: sites matched by occurrence count (the seam calls ``fire``); the rest
#: are schedule-driven (the harness calls ``due`` with the virtual tick).
SCHEDULED_SITES = ("shard.kill", "client.stall", "proc.kill", "proc.hang",
                   "replica.kill")


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One scheduled fault.

    ``at`` is the 1-based occurrence index at the site (scoped to ``doc``
    when set) for seam sites, or the virtual tick/step for scheduled
    sites (``shard.kill``, ``client.stall``).  ``count`` fires the fault
    for that many consecutive occurrences (seam sites only) — e.g. a
    3-append outage.  ``arg`` is kind-specific: the torn-write fraction,
    the stall length in steps."""

    site: str
    kind: str
    at: int = 1
    count: int = 1
    doc: Optional[str] = None
    shard: Optional[str] = None
    arg: float = 0.0

    def validate(self) -> None:
        kinds = SITES.get(self.site)
        if kinds is None:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in kinds:
            raise ValueError(
                f"site {self.site!r} does not implement kind "
                f"{self.kind!r} (has {kinds})")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"bad at/count on {self}")

    def label(self) -> str:
        scope = f"@{self.doc}" if self.doc else ""
        return f"{self.site}:{self.kind}{scope}#{self.at}x{self.count}"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A replayable fault schedule: ``(seed, points)`` fully determines
    every injected fault.  ``seed`` seeds nothing inside the injector —
    it names the scenario (the chaos harness derives its traffic schedule
    from the same seed) and rides the bench/telemetry output."""

    seed: int = 0
    points: Tuple[FaultPoint, ...] = ()

    def __post_init__(self) -> None:
        for p in self.points:
            p.validate()

    @staticmethod
    def generate(seed: int, docs: List[str], steps: int,
                 intensity: int = 2) -> "FaultPlan":
        """Seeded scenario generator covering every required fault class
        (ROADMAP's bursty-herd/laggard/failover scenario axis): oplog
        append failures, torn appends, a mid-run shard kill, stalled
        (laggard) clients, and stale summary reads — ``intensity`` scales
        the per-class point count.  Deterministic: same (seed, docs,
        steps) → same plan."""
        rng = random.Random(seed * 9176 + len(docs))
        points: List[FaultPoint] = []
        for _ in range(intensity):
            # Transient durable-append outages on specific documents: the
            # Nth append to that doc fails for 1-2 consecutive attempts
            # (strictly fewer than RetryPolicy.max_attempts, so inline
            # retries absorb the outage without reshaping the schedule).
            points.append(FaultPoint(
                "oplog.append", "fail", doc=rng.choice(docs),
                at=rng.randint(2, 6), count=rng.randint(1, 2)))
            # Torn partial writes (crash-shaped: bytes hit the disk, the
            # record does not) on the shared log.
            points.append(FaultPoint(
                "oplog.append", "torn", at=rng.randint(8, 12 + steps // 8),
                arg=round(rng.uniform(0.2, 0.8), 3)))
            # A laggard: one client stops draining for `arg` steps, then
            # resumes through gap repair.
            points.append(FaultPoint(
                "client.stall", "stall", doc=rng.choice(docs),
                at=rng.randint(steps // 4, steps // 2),
                arg=float(rng.randint(4, 10))))
        # Stale summary serves across one document's cold loads.  The
        # window spans the harness's whole resolve sequence (setup
        # resolve, the pre-late-join summarizer resolve, the late join
        # itself) so the LATE JOIN — which loads after a newer summary
        # was uploaded mid-run — really gets served the parent and
        # replays the longer tail; a single at=1 point would fire
        # vacuously at setup when only the attach summary exists.
        points.append(FaultPoint(
            "storage.read", "stale", doc=rng.choice(docs), at=1,
            count=3))
        # THE failover: one shard dies mid-run — pinned to a document so
        # the victim (that doc's current owner under rendezvous routing)
        # always holds live orderers worth failing over.
        points.append(FaultPoint(
            "shard.kill", "kill", doc=rng.choice(docs),
            at=rng.randint(steps // 3, 2 * steps // 3)))
        return FaultPlan(seed=seed, points=tuple(points))


class FaultInjector:
    """Threads a :class:`FaultPlan` through the stack's seams.

    Thread-safe: seams fire from client threads, the TCP reader thread,
    and server executor threads concurrently.  All state is occurrence
    counters — no wall clock, no PRNG — so a replay of the same driving
    schedule consults the same counters in the same order.
    """

    def __init__(self, plan: Optional[FaultPlan] = None) -> None:
        self.plan = plan if plan is not None else FaultPlan()
        self._lock = threading.Lock()
        #: occurrences per site and per (site, doc) — the matching keys
        self._counts: Dict[Tuple[str, Optional[str]], int] = {}  # guarded-by: _lock
        #: per-point fire tally (index into plan.points)  # guarded-by: _lock
        self._fired: Dict[int, int] = {}
        #: ``site:kind`` observation counters — the replay-identity
        #: surface (asserted identical across replays of one (seed, plan))
        self.observed = LockedCounterSet()

    # -- seam API --------------------------------------------------------------

    def fire(self, site: str, doc: Optional[str] = None,
             shard: Optional[str] = None) -> Optional[FaultPoint]:
        """One occurrence at ``site``: returns the matching plan point
        (the seam then implements the fault) or None.  At most one point
        fires per occurrence; a point whose start occurrence was claimed
        by an earlier-listed point fires on the NEXT eligible occurrences
        instead — every plan point eventually fires (given enough
        traffic), which is what lets the oracle assert full coverage."""
        with self._lock:
            n_global = self._counts[(site, None)] = \
                self._counts.get((site, None), 0) + 1
            n_doc = None
            if doc is not None:
                n_doc = self._counts[(site, doc)] = \
                    self._counts.get((site, doc), 0) + 1
            for idx, p in enumerate(self.plan.points):
                if p.site != site or p.site in SCHEDULED_SITES:
                    continue
                if p.doc is not None and p.doc != doc:
                    continue
                if p.shard is not None and p.shard != shard:
                    continue
                n = n_global if p.doc is None else n_doc
                if n is None or n < p.at:
                    continue
                if self._fired.get(idx, 0) >= p.count:
                    continue
                self._fired[idx] = self._fired.get(idx, 0) + 1
                self.observed.bump(f"{site}:{p.kind}")
                return p
        return None

    def due(self, site: str, tick: int) -> List[FaultPoint]:
        """Scheduled sites (``shard.kill``, ``client.stall``): the points
        of ``site`` whose tick has arrived and that have not fired yet.
        The harness drives this once per step with its own step index."""
        out: List[FaultPoint] = []
        with self._lock:
            for idx, p in enumerate(self.plan.points):
                if p.site != site or p.at > tick:
                    continue
                if self._fired.get(idx):
                    continue
                self._fired[idx] = 1
                self.observed.bump(f"{site}:{p.kind}")
                out.append(p)
        return out

    def mark_unfired(self, point: FaultPoint) -> None:
        """A scheduled point ``due()`` handed out could NOT be executed
        (e.g. its kill victim is the last live shard): roll back its
        fired mark and observation count so ``unfired()`` reports it —
        the coverage oracle must never claim coverage for a fault that
        did not happen."""
        with self._lock:
            for idx, p in enumerate(self.plan.points):
                if p == point and self._fired.get(idx):
                    self._fired[idx] = 0
                    self.observed.bump(f"{p.site}:{p.kind}", -1)
                    return

    # -- oracle surface --------------------------------------------------------

    def unfired(self) -> List[FaultPoint]:
        """Plan points that never triggered — a chaos run claiming this
        plan's coverage must end with an empty list, or the scenario did
        not exercise what it says it did."""
        with self._lock:
            return [p for idx, p in enumerate(self.plan.points)
                    if not self._fired.get(idx)]

    def snapshot(self) -> Dict[str, int]:
        """``site:kind`` observation counts — byte-comparable across
        replays of the same (seed, plan)."""
        return self.observed.snapshot()
