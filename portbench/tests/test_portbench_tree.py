"""The tree cell's harness (CPU): every seed does the same work, a run
loads no JAX, the new readers read None where the program keeps no such
counter, and the check calls the control and a fold that applies nothing
not correct.

    python3 -m pytest portbench/tests/test_portbench_tree.py -q -s
"""

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import control, run

CELL = "tree_long.forest_cold"
SEEDS = (1, 2 ** 31 + 11, 3_000_000_019, 77, 2 ** 32 - 5, 123_456_789)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READERS = ("tree_pack_busy_ms_per_kop", "tree_native_pack_doc_pct",
           "tree_extract_busy_us_per_node", "tree_fallback_doc_pct",
           "tree_fold_kernel_us_per_kop", "tree_fold_roofline_pct")


def _shape_of(spec, seed):
    from fluidframework_tpu_torch.ops.tree_kernel import pack_tree_batch

    driver = __import__(spec.config["driver"], fromlist=["inputs"])
    pool = driver.generate(spec.config, spec.traffic, seed)
    docs = driver.inputs(pool)
    chunks = []
    for lo in range(0, len(docs), 1024):
        state, edits, meta = pack_tree_batch(docs[lo:lo + 1024])
        chunks.append((state.next.shape, state.head.shape, edits.kind.shape,
                       int(np.asarray(meta["t_rows"]).sum()),
                       int(np.asarray(meta["n_nodes"]).sum())))
    return pool, chunks, driver.work(pool, range(8))["int_ops_per_op"]


def test_every_seed_does_the_same_work():
    spec = run.load_cell(CELL)
    first, shapes, per_edit = None, [], []
    for seed in SEEDS:
        pool, chunks, work = _shape_of(spec, seed)
        assert pool.n_docs == spec.config["docs"]
        assert pool.n_ops == spec.config["edits_per_doc"]
        layout = (pool.kind.tobytes(), pool.depth.tobytes(),
                  pool.n_nodes.tobytes(), pool.purged.tobytes(),
                  [len(b) for b in pool.blobs])
        if first is None:
            first = layout
        assert layout == first
        shapes.append(chunks)
        per_edit.append(work)
    assert all(s == shapes[0] for s in shapes[1:]), shapes
    spread = (max(per_edit) - min(per_edit)) / statistics.median(per_edit)
    print(f"\n{CELL}: chunks ([D, N], [D, C], [D, T], rows, nodes) "
          f"{shapes[0]}")
    print(f"{CELL}: fold work an edit over 8 documents, 6 seeds: "
          f"{[round(x, 2) for x in per_edit]}, spread {spread:.4f}")
    assert spread < 0.05


def test_one_seed_gives_the_same_bytes():
    spec = run.load_cell(CELL)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    a, b, c = (driver.generate(spec.config, spec.traffic, s, n_docs=64,
                               n_ops=400)
               for s in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4))
    assert a.blobs == b.blobs and a.values == b.values
    assert a.blobs != c.blobs
    assert np.array_equal(a.kind, c.kind)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        "from portbench import run\n"
        "spec = run.load_cell(%r)\n"
        "res, _ = run.run_cell(spec, 7, 0.0, True, 'cpu', "
        "time.perf_counter(), n_docs=12, n_ops=80)\n"
        "assert res['correct'], res\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} "
        "& set(run.FORBIDDEN))\n"
        "print(bad)\n" % CELL)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_their_counters(name):
    empty = SimpleNamespace(ops=0, passes=0, window_s=1.0, setup_s=1.0,
                            n_docs=0, stage={}, stats={}, trace={},
                            peak_window_bytes=0, device_kind="cpu",
                            on_card=False, work=None)
    assert run.load_reader(name)(empty) is None
    counted = SimpleNamespace(**{**vars(empty), "ops": 4000, "passes": 2,
                                 "n_docs": 2})
    assert run.load_reader(name)(counted) is None


def test_readers_read_their_counters():
    r = SimpleNamespace(
        ops=8000, passes=2, window_s=1.0, setup_s=1.0, n_docs=2,
        stage={"pack": 0.004, "extract": 0.5, "extract_nodes": 1000},
        stats={"native_pack_docs": 4, "device_docs": 3, "fallback_docs": 1},
        trace={"by_name": {"void tree_fold_kernel<false, false>": 0.002,
                           "mergetree_fold_kernel<true, true>": 9.0}},
        peak_window_bytes=0, device_kind="NVIDIA H100 80GB HBM3",
        on_card=True, work={"int_ops_per_op": 100.0, "bytes_per_op": 250.0})
    got = {n: run.load_reader(n)(r) for n in READERS}
    assert got["tree_pack_busy_ms_per_kop"] == pytest.approx(0.5)
    assert got["tree_native_pack_doc_pct"] == 100.0
    assert got["tree_extract_busy_us_per_node"] == pytest.approx(500.0)
    assert got["tree_fallback_doc_pct"] == 25.0
    assert got["tree_fold_kernel_us_per_kop"] == pytest.approx(250.0)
    least = max(100.0 * 8000 / (132 * 64 * 1.98e9), 250.0 * 8000 / 3.35e12)
    assert got["tree_fold_roofline_pct"] == pytest.approx(
        100.0 * least / 0.002)


def _run(seed):
    return run.run_cell(run.load_cell(CELL), seed, 0.0, False, "cpu",
                        time.perf_counter(), n_docs=16, n_ops=160)[0]


def test_the_program_reads_correct():
    res = _run(2 ** 31 + 5)
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["check"].values())


def test_the_control_reads_not_correct(monkeypatch):
    import portbench.sharedtree as driver

    spec = run.load_cell(CELL)
    pool = driver.generate(spec.config, spec.traffic, 41, n_docs=16,
                           n_ops=160)
    monkeypatch.setattr(driver, "entry",
                        lambda traffic: control.control_pass(driver, pool))
    res = _run(41)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == 16
    assert res["check"]["header_mismatch"]["value"] == 16
    assert res["check"]["forest_mismatch"]["value"] > 0


def test_a_fold_that_applies_nothing_reads_not_correct(monkeypatch):
    from fluidframework_tpu_torch.ops import tree_pipeline

    def unchanged(state, edits, meta, digest, aux_dev):
        return tuple(state)

    monkeypatch.setattr(tree_pipeline, "TREE_FAMILY", __import__(
        "dataclasses").replace(tree_pipeline.TREE_FAMILY, dispatch=unchanged))
    res = _run(2 ** 31 + 9)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == 16


def test_the_configuration_states_its_cut():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "tree_long")
    spec = run.load_cell(CELL)
    for key in entry["reduced"]:
        assert key in spec.config["reduced"]
        assert spec.config[key] < spec.config["source_values"][key]
