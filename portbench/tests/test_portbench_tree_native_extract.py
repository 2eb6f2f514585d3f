"""The tree cell's reader of the native summary writer (CPU): it reads 100
on a tiny tree cell, where the writer writes every header the device route
serves, and None without the counter.

    python3 -m pytest portbench/tests/test_portbench_tree_native_extract.py -q
"""

import time
from types import SimpleNamespace

from portbench import run

CELL = "tree_long.forest_cold"
NAME = "tree_native_extract_doc_pct"


def test_reads_100_on_a_tiny_tree_cell():
    spec = run.load_cell(CELL)
    assert NAME in [m["name"] for m in spec.per_layer]
    res, _notes = run.run_cell(spec, 2 ** 33 + 17, 0.0, True, "cpu",
                               time.perf_counter(), n_docs=20, n_ops=120)
    assert res["correct"] is True
    assert res["metrics"][NAME] == {"value": 100.0, "unit": "%"}


def test_reads_none_without_the_counter():
    read = run.load_reader(NAME)
    r = SimpleNamespace(stage={"extract": 0.5, "extract_nodes": 1000},
                        stats={"device_docs": 40, "native_pack_docs": 40})
    assert read(r) is None
    r.stage["extract_native_docs"] = 30
    assert read(r) == 75.0
    r.stats = {}
    assert read(r) is None
