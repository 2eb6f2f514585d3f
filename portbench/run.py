"""One run of one benchmark cell, on the card.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run

1. reads ``BENCHMARK.json`` and the cell's files: the configuration's file
   (sizes, the driver module that feeds and judges the system), the
   traffic mix ``portbench/traffic/<traffic>.json`` and one reader a
   metric, ``portbench/metrics/<metric>.py``;
2. generates the pool from ``--seed`` (the same seed, the same bytes),
   hands it to the system and runs the traffic's warm passes: set-up ends
   here (``setup_s`` counts from the process's start);
3. runs whole passes over the pool back to back until ``--seconds`` have
   passed (the window), under ``torch.profiler`` with ``--trace 1``;
4. judges what the window's passes returned (``judge``): every answer
   by the driver's checks (for SharedString its header against the
   generator's bookkeeping, and, for one slice of the pool a pass, a
   different slice each pass, its visible text against a plain splice of
   the tail), and a sample drawn from the seed (the document with the
   most text in it first) against the plain reference, byte for byte in
   every pass;
5. prints each number compared beside its limit on standard error, then
   one JSON line on standard output: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device`` (and ``breakdown`` when traced),
   and ``check`` last.

With no CUDA device, or fewer than the cell asks for, it prints no result
and exits 2; it exits 3 if JAX or the JAX package was loaded by the time
the window closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidframework_tpu")


def load_cell(name: str, root: str = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read: the
    configuration's file, the traffic mix and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def here(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in bench["end_to_end"] if here(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if here(m) and m["moves"] in reported]
    return SimpleNamespace(name=name, cell=cell, config=config,
                           traffic=traffic, end_to_end=end_to_end,
                           per_layer=per_layer)


def load_reader(metric: str):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), tag])


def draw_sample(n_docs: int, size: int, seed: int, always: int) -> List[int]:
    """``size`` documents drawn from the seed, ``always`` first."""
    others = np.array([d for d in range(n_docs) if d != always], np.int64)
    picked = _rng(seed, 0xC4EC).choice(
        others, size=min(size, n_docs) - 1, replace=False)
    return [always] + [int(d) for d in picked]


def draw_slices(n_docs: int, n_slices: int, seed: int) -> List[set]:
    """The pool cut into ``n_slices`` slices in an order drawn from the
    seed: pass ``p`` keeps the whole answers of slice ``p % n_slices``."""
    order = _rng(seed, 0x511CE).permutation(n_docs)
    return [set(int(d) for d in part)
            for part in np.array_split(order, n_slices)]


def judge(driver, pool, passes: List[dict], docs, sample: List[int]):
    """Every kept answer of ``docs`` in every pass against the driver's
    checks, and the sampled documents' against the plain reference, byte
    for byte.  ``passes`` holds one ``{doc: kept answer}`` a pass.
    Returns the check (each number beside its limit), the (pass, doc)
    pairs at fault, the ops whose answers came back, and how many
    answers were compared with the reference."""
    counts = dict.fromkeys(("missing",) + tuple(driver.CHECKS)
                           + ("sample_mismatch",), 0)
    bad = set()
    ops = compared = 0
    in_sample = set(sample)
    for d in docs:
        expect = driver.expected(pool, d)
        want = driver.reference(pool, d) if d in in_sample else None
        judged: List[tuple] = []  # (kept, faults) of each distinct answer
        for p, got in enumerate(passes):
            kept = got.get(d)
            if kept is None:
                counts["missing"] += 1
                bad.add((p, d))
                continue
            ops += driver.ops_of(pool, d)
            found = next((f for k, f in judged if k == kept), None)
            if found is None:
                found = driver.faults(expect, kept)
                judged.append((kept, found))
            if want is not None:
                compared += 1
                if kept != want:
                    found = found + ["sample_mismatch"]
            for name in found:
                counts[name] += 1
            if found:
                bad.add((p, d))
    check = {name: {"value": v, "limit": 0} for name, v in counts.items()}
    return check, bad, ops, compared


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool,
             device: str, t0: float, n_docs: Optional[int] = None,
             n_ops: Optional[int] = None) -> Tuple[Dict, Dict]:
    """Set up, measure and judge one run: the result line as a dict
    (``check`` its last key), and notes for standard error: when each
    step of set-up and each pass of the window ended, and how many
    sampled answers were compared with the reference.  ``n_docs`` /
    ``n_ops`` shrink the pool (tests on the CPU only)."""
    import torch

    driver = importlib.import_module(spec.config["driver"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    marks = {"imports": time.perf_counter() - t0}
    pool = driver.generate(spec.config, spec.traffic, seed, n_docs=n_docs,
                           n_ops=n_ops)
    marks["generate"] = time.perf_counter() - t0
    docs = driver.inputs(pool)
    run_pass = driver.entry(spec.traffic)
    marks["inputs"] = time.perf_counter() - t0
    for _ in range(int(spec.traffic["warm_passes"])):
        run_pass(docs, dev, None, None)
    sync()
    marks["warm"] = time.perf_counter() - t0
    sample = draw_sample(pool.n_docs, int(spec.config["check_sample_docs"]),
                         seed, driver.longest(pool))
    # the documents whose whole answers each pass keeps
    wholes = [part | set(sample) for part in draw_slices(
        pool.n_docs, int(spec.config["text_check_slices"]), seed)]
    gc.collect()
    setup_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    stage: dict = {}
    stats: dict = {}
    kept: List[dict] = []
    prof = None
    if trace:
        from .trace import PASS_SPAN

        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    t_start = time.perf_counter()
    pass_ends: List[float] = []
    while True:
        span = torch.profiler.record_function(PASS_SPAN) if trace \
            else contextlib.nullcontext()
        with span:
            answers = run_pass(docs, dev, stage, stats)
        whole = wholes[len(kept) % len(wholes)]
        kept.append({d: driver.keep(a, d in whole)
                     for d, a in enumerate(answers)})
        del answers
        pass_ends.append(time.perf_counter() - t_start)
        if pass_ends[-1] >= seconds:
            break
    sync()
    t_end = time.perf_counter()
    passes = len(kept)
    setup_s = t_start - t0
    window_s = t_end - t_start
    trace_path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, trace_path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
        del prof
    peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    peak = max(setup_peak, peak_window)
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    del docs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    check, bad, ops, compared = judge(driver, pool, kept, range(pool.n_docs),
                                      sample)
    correct = compared > 0 and all(c["value"] <= c["limit"]
                                   for c in check.values())

    # -- metrics -----------------------------------------------------------
    reduced = {}
    if trace_path is not None:
        from .trace import reduce_trace

        try:
            reduced = reduce_trace(trace_path)
        finally:
            os.unlink(trace_path)
    reading = SimpleNamespace(
        ops=ops, passes=passes, window_s=window_s, setup_s=setup_s,
        n_docs=pool.n_docs, stage=stage, stats=stats, trace=reduced,
        peak_window_bytes=peak_window, device_kind=kind, on_card=on_card,
        work=None)
    if trace:
        work_docs = _rng(seed, 0x3013).choice(
            pool.n_docs, size=min(int(spec.config["work_sample_docs"]),
                                  pool.n_docs), replace=False)
        reading.work = driver.work(pool, [int(d) for d in work_docs])
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = load_reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": int(spec.cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": passes * pool.n_docs,
              "failed": len(bad), "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = reduced.get("busy_s", 0.0)
        device_info["window_s"] = reduced.get("window_s", window_s)
        result["breakdown"] = {"device_ops": reduced.get("device_ops", []),
                               "idle_gaps": reduced.get("idle_gaps", [])}
    result["check"] = check
    return result, {"compared": compared, "pass_ends_s": pass_ends,
                    "setup_marks_s": marks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = int(spec.cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), {found} "
              "found. No result.", file=sys.stderr)
        return 2
    try:
        result, notes = run_cell(spec, args.seed, args.seconds,
                                 bool(args.trace), "cuda", _T0)
    except ImportError as exc:
        print(f"portbench: cannot load the system under test: {exc}",
              file=sys.stderr)
        return 2
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}. "
              "No result.", file=sys.stderr)
        return 3
    print(f"portbench: set-up reached {notes['setup_marks_s']} s",
          file=sys.stderr)
    print(f"portbench: passes ended at {notes['pass_ends_s']} s",
          file=sys.stderr)
    print(f"portbench: {result['attempted']} answers, {notes['compared']} "
          "sampled answers compared with the reference", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
