"""The card's idle time in a traced window, put down to the program's spans.

``portbench.trace.reduce_trace`` names each idle interval by where in a
pass it fell (``entry.head`` / ``entry.mid`` / ``entry.tail``, and
``harness`` outside the passes).  The port's pipeline opens a span
(``pipeline.<leg>``, through ``telemetry.span``) around each leg and each
wait of the thread that runs the pass, on the clock of the trace's device
events.  :func:`reduce_trace_by_span` reads the same Chrome trace and
returns ``reduce_trace``'s reduction with

- ``idle_by_span``: the idle seconds inside the passes by the innermost
  ``pipeline.*`` span on the pass's thread covering each idle instant
  (spans on one thread nest, so the innermost is the latest to start),
  ``(no span)`` where none does; a program without such spans reads
  ``(no span)`` alone;
- ``idle_gaps`` split the same way, as ``<position>/<span>``; what no span
  covers keeps the bare position, so each position's entries sum to its
  unsplit total.  Everything else is ``reduce_trace``'s, unchanged.

Spans on other threads are left out.  ``run.py`` does not call this yet
(it reduces with ``reduce_trace`` alone); run a traced cell with the split
breakdown by

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>

which prints ``run.py``'s traced result line, its breakdown split by span.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

from portbench import run, trace
from portbench.trace import (_DEVICE_CATS, PASS_SPAN, _clip, _merge,
                             reduce_trace)

#: the prefix of the program's spans (the port's ``pipeline.*``)
PROGRAM_SPANS = "pipeline."
NO_SPAN = "(no span)"


def _gaps(inside, ps, pe) -> Dict[str, List[Tuple[float, float]]]:
    """A pass's idle intervals by position, from its busy intervals."""
    if not inside:
        return {"entry.head": [(ps, pe)]}
    return {"entry.head": [(ps, inside[0][0])],
            "entry.mid": [(a[1], b[0]) for a, b in zip(inside, inside[1:])],
            "entry.tail": [(inside[-1][1], pe)]}


def _by_span(lo, hi, spans) -> Dict[str, float]:
    """Microseconds of ``[lo, hi]`` by the innermost of ``spans``
    (``(start, end, name)``, by start, the longer first among equal
    starts) covering each instant."""
    over = [sp for sp in spans if sp[0] < hi and sp[1] > lo]
    cuts = sorted({lo, hi} | {t for s, e, _n in over for t in (s, e)
                              if lo < t < hi})
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        name = NO_SPAN
        for s, e, n in over:  # the last to cover is the innermost
            if s <= mid < e:
                name = n
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def reduce_trace_by_span(path: str) -> Dict:
    """``reduce_trace(path)`` with its idle time put down to the
    program's spans (the module's docstring); ``{}`` without passes."""
    reduced = reduce_trace(path)
    if not reduced:
        return reduced
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device: List[Tuple[float, float]] = []
    passes: List[Tuple[float, float]] = []
    tids = set()
    program: List[Tuple[float, float, str, object]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur))
        elif cat == "user_annotation" and name == PASS_SPAN:
            passes.append((ts, ts + dur))
            tids.add(e.get("tid"))
        elif cat == "user_annotation" and name.startswith(PROGRAM_SPANS):
            program.append((ts, ts + dur, name, e.get("tid")))
    spans = sorted(((s, e, n) for s, e, n, tid in program if tid in tids),
                   key=lambda sp: (sp[0], -sp[1]))
    passes.sort()
    busy = _clip(_merge(device), passes[0][0], passes[-1][1])
    by_span = dict.fromkeys(sorted({n for _s, _e, n in spans}), 0.0)
    by_span[NO_SPAN] = 0.0
    gaps: Dict[str, float] = {}
    for ps, pe in passes:
        in_pass = [sp for sp in spans if sp[0] < pe and sp[1] > ps]
        for pos, intervals in _gaps(_clip(busy, ps, pe), ps, pe).items():
            for lo, hi in intervals:
                for name, us in _by_span(lo, hi, in_pass).items():
                    by_span[name] += us * 1e-6
                    key = pos if name == NO_SPAN else f"{pos}/{name}"
                    gaps[key] = gaps.get(key, 0.0) + us * 1e-6
    harness = dict(reduced["idle_gaps"]).get("harness", 0.0)
    if harness:
        gaps["harness"] = harness
    return dict(reduced, idle_by_span=by_span,
                idle_gaps=sorted(([k, v] for k, v in gaps.items() if v > 0),
                                 key=lambda kv: -kv[1]))


def idle_share(reduced: Dict, span: str):
    """Percent of the traced window the card sat idle inside ``span``;
    None where the program has no such span."""
    idle = (reduced or {}).get("idle_by_span", {}).get(span)
    if idle is None or not reduced.get("window_s"):
        return None
    return 100.0 * idle / reduced["window_s"]


def run_traced(spec, seed: int, seconds: float, device: str, t0: float,
               **pool):
    """``run.run_cell`` traced, its breakdown split by span and holding
    ``idle_by_span``: ``(result, notes)``.  ``pool`` shrinks the pool
    (``n_docs`` / ``n_ops``, tests on the CPU only)."""
    reduced: Dict = {}

    def reducing(path):
        reduced.update(reduce_trace_by_span(path))
        return reduced

    plain = trace.reduce_trace
    trace.reduce_trace = reducing  # run_cell imports it when it reduces
    try:
        result, notes = run.run_cell(spec, seed, seconds, True, device, t0,
                                     **pool)
    finally:
        trace.reduce_trace = plain
    result["breakdown"]["idle_by_span"] = reduced.get("idle_by_span", {})
    return result, notes


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device. No result.", file=sys.stderr)
        return 2
    result, notes = run_traced(run.load_cell(args.workload), args.seed,
                               args.seconds, "cuda", t0)
    print(f"portbench: passes ended at {notes['pass_ends_s']} s",
          file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
