"""The matrix cell's harness (CPU): every seed does the same work, the
plain reference equals the port's oracle, a run loads no JAX, the new
readers read a number or None as documented, and the check calls the
control and a fold that applies nothing not correct.

    python3 -m pytest portbench/tests/test_portbench_matrix.py -q -s
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import control, matrixgen, run

CELL = "matrix_long.grid_cold"
SEEDS = (1, 2 ** 31 + 11, 3_000_000_019, 2 ** 32 - 5)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READERS = ("matrix_pack_busy_ms_per_kop", "matrix_native_pack_doc_pct",
           "matrix_extract_busy_ms_per_kop", "matrix_native_extract_doc_pct",
           "matrix_fallback_doc_pct", "matrix_fold_kernel_us_per_kop",
           "matrix_fold_roofline_pct")


def _pool(seed, n_docs=None, n_ops=None):
    spec = run.load_cell(CELL)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    return spec, driver, driver.generate(spec.config, spec.traffic, seed,
                                         n_docs=n_docs, n_ops=n_ops)


def test_every_seed_packs_to_the_same_buckets_and_kinds():
    """The layout fixes every message's kind but the policy slot's, which
    the seed's FWW documents take; each seed packs to the same T and S,
    and the fold's work a message moves by less than 5%."""
    from fluidframework_tpu_torch.ops.matrix_native import pack_records

    first, shapes, per_msg = None, [], []
    for seed in SEEDS:
        spec, driver, pool = _pool(seed, n_docs=96)
        assert pool.n_ops == spec.config["messages_per_doc"]
        assert pool.fww.sum() == 96 // spec.config["fww"]["every"]
        axis = np.where(pool.kind == matrixgen.SET_POLICY,
                        matrixgen.SET_CELL, pool.kind)
        layout = (axis.tobytes(), pool.rows.tobytes(), pool.cols.tobytes())
        if first is None:
            first = layout
        assert layout == first
        _n, ops, meta = pack_records(driver.inputs(pool))
        shapes.append((ops.kind.shape, meta["S"]))
        per_msg.append(driver.work(pool, range(8))["int_ops_per_op"])
    assert all(s == shapes[0] for s in shapes[1:]), shapes
    assert shapes[0] == ((192, 2048), 4096)
    spread = (max(per_msg) - min(per_msg)) / statistics.median(per_msg)
    print(f"\n{CELL}: [2D, T], S {shapes[0]}; fold work a message over 8 "
          f"documents, {len(SEEDS)} seeds: "
          f"{[round(x, 1) for x in per_msg]}, spread {spread:.4f}")
    assert spread < 0.05


def test_one_seed_gives_the_same_bytes():
    a, b, c = (_pool(s, n_docs=32, n_ops=300)[2]
               for s in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4))
    assert a.blobs == b.blobs and a.values == b.values
    assert a.blobs != c.blobs


def test_records_are_the_port_encoders_and_the_grid_is_the_oracles():
    """The generator's records, byte for byte what the port's encoder
    writes of the decoded messages; the plain reference's blobs and the
    generator's grid equal the port's dds/matrix.py oracle's."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_native as mn

    spec, driver, pool = _pool(2 ** 31 + 17, n_docs=24, n_ops=400)
    for doc in driver.inputs(pool):
        d = int(doc.doc_id[3:])
        msgs = mn.decode_matrix_ops(doc.records)
        assert mn.encode_matrix_ops(msgs) == doc.records
        oracle = mk.oracle_matrix_fallback(doc)
        ours = driver.reference(pool, d)
        assert ours == {n: oracle.blob_bytes(n) for n in ("header", "body")}
        assert driver.visible_grid(ours["body"]) == pool.final_grid(d)
        assert driver.facts(ours["header"]) == driver.expected(pool,
                                                               d).facts


def test_a_run_loads_no_jax():
    code = (
        "import sys, time\n"
        "from portbench import run\n"
        "spec = run.load_cell(%r)\n"
        "res, _ = run.run_cell(spec, 7, 0.0, True, 'cpu', "
        "time.perf_counter(), n_docs=12, n_ops=120)\n"
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
        stage={"pack": 0.004, "extract": 0.5, "extract_native_docs": 3},
        stats={"native_pack_docs": 4, "device_docs": 3, "fallback_docs": 1},
        trace={"by_name": {"void matrix_fold_kernel<1>(Args)": 0.002,
                           "mergetree_fold_kernel<true, true>": 9.0}},
        peak_window_bytes=0, device_kind="NVIDIA H100 80GB HBM3",
        on_card=True, work={"int_ops_per_op": 100.0, "bytes_per_op": 250.0})
    got = {n: run.load_reader(n)(r) for n in READERS}
    assert got["matrix_pack_busy_ms_per_kop"] == pytest.approx(0.5)
    assert got["matrix_native_pack_doc_pct"] == 100.0
    assert got["matrix_extract_busy_ms_per_kop"] == pytest.approx(62.5)
    assert got["matrix_native_extract_doc_pct"] == 100.0
    assert got["matrix_fallback_doc_pct"] == 25.0
    assert got["matrix_fold_kernel_us_per_kop"] == pytest.approx(250.0)
    least = max(100.0 * 8000 / (132 * 64 * 1.98e9), 250.0 * 8000 / 3.35e12)
    assert got["matrix_fold_roofline_pct"] == pytest.approx(
        100.0 * least / 0.002)


def _run(seed, trace=False):
    return run.run_cell(run.load_cell(CELL), seed, 0.0, trace, "cpu",
                        time.perf_counter(), n_docs=16, n_ops=240)[0]


def test_the_program_reads_correct_and_its_counters():
    res = _run(2 ** 31 + 5, trace=True)
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["check"].values())
    metrics = res["metrics"]
    assert metrics["matrix_native_pack_doc_pct"]["value"] == 100.0
    assert metrics["matrix_native_extract_doc_pct"]["value"] == 100.0
    assert metrics["matrix_fallback_doc_pct"]["value"] == 0.0
    assert metrics["matrix_pack_busy_ms_per_kop"]["value"] > 0
    assert metrics["matrix_extract_busy_ms_per_kop"]["value"] > 0
    # no device kernel ran: the device readers read nothing
    assert "matrix_fold_kernel_us_per_kop" not in metrics
    assert "matrix_fold_roofline_pct" not in metrics


def test_the_control_reads_not_correct(monkeypatch):
    import portbench.sharedmatrix as driver

    spec = run.load_cell(CELL)
    pool = driver.generate(spec.config, spec.traffic, 41, n_docs=16,
                           n_ops=240)
    monkeypatch.setattr(driver, "entry",
                        lambda traffic: control.control_pass(driver, pool))
    res = _run(41)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == 16
    assert res["check"]["header_mismatch"]["value"] == 16
    assert res["check"]["grid_mismatch"]["value"] > 0


def test_a_fold_that_resolves_nothing_reads_not_correct(monkeypatch):
    from fluidframework_tpu_torch.ops import matrix_pipeline

    real = matrix_pipeline.MATRIX_FAMILY.dispatch

    def unresolved(state, ops, meta, digest, aux_dev):
        out = list(real(state, ops, meta, digest, aux_dev))
        at = matrix_pipeline.EXPORT_FIELDS.index("resolved")
        out[at] = out[at] * 0 - 1
        return tuple(out)

    monkeypatch.setattr(matrix_pipeline, "MATRIX_FAMILY", dataclasses.replace(
        matrix_pipeline.MATRIX_FAMILY, dispatch=unresolved))
    res = _run(2 ** 31 + 9)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == 16
    assert res["check"]["grid_mismatch"]["value"] > 0


def test_the_configuration_states_its_cut():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == "matrix_long")
    spec = run.load_cell(CELL)
    assert spec.config["source"] == entry["source"]
    for key in entry["reduced"]:
        assert key in spec.config["reduced"]
        assert spec.config[key] < spec.config["source_values"][key]
