"""Statistical micro-benchmark harness.

Capability-equivalent of the reference's ``@fluid-tools/benchmark``
(SURVEY.md §2.4/§4: execution-time + memory modes with statistical
reporting, the ``.perf.spec`` convention).

    result = benchmark(lambda: replica.process(msg), min_runs=20)
    print(result.report())          # mean/p50/p95/stddev
    mem = benchmark_memory(build_big_state)
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
import tracemalloc
from typing import Callable, List, Optional


@dataclasses.dataclass
class BenchmarkResult:
    name: str
    runs: int
    #: per-run durations, seconds
    samples: List[float]

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples)

    @property
    def stddev(self) -> float:
        mean = self.mean
        if len(self.samples) < 2:
            return 0.0
        var = sum((s - mean) ** 2 for s in self.samples) \
            / (len(self.samples) - 1)
        return math.sqrt(var)

    def percentile(self, p: float) -> float:
        ordered = sorted(self.samples)
        idx = min(len(ordered) - 1, max(0, round(p / 100 * (len(ordered) - 1))))
        return ordered[idx]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def ops_per_sec(self) -> float:
        return 1.0 / self.mean if self.mean > 0 else float("inf")

    def report(self) -> str:
        return (
            f"{self.name}: {self.runs} runs | mean "
            f"{self.mean * 1e3:.3f}ms | p50 {self.p50 * 1e3:.3f}ms | "
            f"p95 {self.p95 * 1e3:.3f}ms | stddev {self.stddev * 1e3:.3f}ms"
        )


def benchmark(
    fn: Callable[[], object],
    name: str = "benchmark",
    min_runs: int = 10,
    max_runs: int = 1000,
    min_time_s: float = 0.5,
    warmup_runs: int = 2,
    setup: Optional[Callable[[], object]] = None,
) -> BenchmarkResult:
    """Timed mode: run until both min_runs and min_time_s are satisfied
    (or max_runs), measuring each run.  ``setup`` runs untimed before each
    measured run (fresh state per run)."""
    for _ in range(warmup_runs):
        arg = setup() if setup else None
        fn() if arg is None else fn(arg)  # type: ignore[call-arg]
    samples: List[float] = []
    total = 0.0
    while (len(samples) < min_runs or total < min_time_s) \
            and len(samples) < max_runs:
        arg = setup() if setup else None
        t0 = time.perf_counter()
        fn() if arg is None else fn(arg)  # type: ignore[call-arg]
        dt = time.perf_counter() - t0
        samples.append(dt)
        total += dt
    return BenchmarkResult(name=name, runs=len(samples), samples=samples)


def render_bench_json(report: dict, compact: bool = False) -> str:
    """THE one BENCH-JSON serialization: sorted keys, stable layout
    (indent-2 document, or one line for ``compact`` single-metric
    benches), trailing newline — so every ``BENCH_*.json`` in the
    trajectory diffs cleanly run over run.  Metrics a run skipped must
    already be present as ``None`` in ``report`` (schema-stable nulls);
    this is the serialization point, not a schema checker."""
    if compact:
        return json.dumps(report, sort_keys=True) + "\n"
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def write_bench_json(report: dict, out: Optional[str] = None,
                     compact: bool = False) -> str:
    """Render ``report`` (see :func:`render_bench_json`) and write it to
    the ``out`` path, or to stdout when ``out`` is None.  Returns the
    rendered text.  Shared by tools/service_e2e.py, tools/chaos.py and
    tools/loadgen.py — one writer, one schema discipline."""
    text = render_bench_json(report, compact=compact)
    if out is not None:
        with open(out, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return text


@dataclasses.dataclass
class ColdWarmResult:
    """Steady-state pair: the first (cold) run against the best of the
    following (warm) runs — the cache-amortization shape of serving
    workloads (catch-up re-reads, snapshot caches)."""

    name: str
    cold_s: float
    warm_s: float  # best warm run
    warm_runs: int
    #: d2h / h2d bytes the cold / per-warm run moved (from a pipeline
    #: ``stage`` dict's ``d2h_bytes``/``h2d_bytes`` counters) — None
    #: when no stage was attached, so JSON consumers see the fields
    #: null-stable, not absent.
    cold_d2h_bytes: Optional[int] = None
    warm_d2h_bytes: Optional[int] = None  # LAST warm run (deterministic)
    cold_h2d_bytes: Optional[int] = None
    warm_h2d_bytes: Optional[int] = None  # LAST warm run (deterministic)

    @property
    def speedup(self) -> float:
        return self.cold_s / self.warm_s if self.warm_s > 0 \
            else float("inf")

    def report(self) -> str:
        out = (
            f"{self.name}: cold {self.cold_s * 1e3:.3f}ms | warm "
            f"{self.warm_s * 1e3:.3f}ms (best of {self.warm_runs}) | "
            f"{self.speedup:.1f}x"
        )
        if self.cold_d2h_bytes is not None:
            out += (f" | d2h cold {self.cold_d2h_bytes} B, warm "
                    f"{self.warm_d2h_bytes} B | h2d cold "
                    f"{self.cold_h2d_bytes} B, warm "
                    f"{self.warm_h2d_bytes} B")
        return out


def benchmark_cold_warm(
    fn: Callable[[], object],
    name: str = "cold-warm",
    warm_runs: int = 3,
    stage: Optional[dict] = None,
) -> ColdWarmResult:
    """Cold/warm mode: time ``fn`` once cold, then ``warm_runs`` more
    times taking the best — no setup hook on purpose (the state carried
    between runs IS the measurement).  ``stage`` (a pipeline stage dict
    whose ``d2h_bytes``/``h2d_bytes`` counters ``fn`` advances)
    additionally attributes the cold run's and the last warm run's link
    bytes EACH WAY — the delta-download and resident-upload observables,
    deterministic where the timings are not."""

    def _bytes(key: str) -> int:
        return int(stage.get(key, 0)) if stage is not None else 0

    b0, u0 = _bytes("d2h_bytes"), _bytes("h2d_bytes")
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    cold_bytes = _bytes("d2h_bytes") - b0
    cold_up = _bytes("h2d_bytes") - u0
    warm = float("inf")
    warm_bytes = warm_up = 0
    for _ in range(max(1, warm_runs)):
        b0, u0 = _bytes("d2h_bytes"), _bytes("h2d_bytes")
        t0 = time.perf_counter()
        fn()
        warm = min(warm, time.perf_counter() - t0)
        warm_bytes = _bytes("d2h_bytes") - b0
        warm_up = _bytes("h2d_bytes") - u0
    return ColdWarmResult(
        name=name, cold_s=cold, warm_s=warm, warm_runs=max(1, warm_runs),
        cold_d2h_bytes=cold_bytes if stage is not None else None,
        warm_d2h_bytes=warm_bytes if stage is not None else None,
        cold_h2d_bytes=cold_up if stage is not None else None,
        warm_h2d_bytes=warm_up if stage is not None else None,
    )


@dataclasses.dataclass
class MemoryResult:
    name: str
    peak_bytes: int
    retained_bytes: int

    def report(self) -> str:
        return (f"{self.name}: peak {self.peak_bytes / 1e6:.2f}MB | "
                f"retained {self.retained_bytes / 1e6:.2f}MB")


def benchmark_memory(fn: Callable[[], object],
                     name: str = "memory") -> MemoryResult:
    """Memory mode: peak allocation during fn and bytes retained by its
    return value's lifetime (tracemalloc)."""
    tracemalloc.start()
    tracemalloc.reset_peak()
    before, _ = tracemalloc.get_traced_memory()
    result = fn()
    after, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    del result
    return MemoryResult(name=name, peak_bytes=peak - before,
                        retained_bytes=max(0, after - before))
