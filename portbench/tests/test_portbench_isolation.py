"""What the benchmark may import, and a rehearsal of a run (CPU).

Every module under ``portbench/`` but its tests is read with ``ast``: no
import whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``fluidframework_tpu`` (whole names: the port's own name begins with the
JAX package's), and nothing of ``fluidframework_tpu_torch`` under
``portbench/reference/``.  Then one cell runs end to end at a tiny pool
through the entry with ``device="cpu"`` and comes out correct.

    python3 -m pytest portbench/tests/test_portbench_isolation.py -q
"""

import ast
import os
import time

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fluidframework_tpu"}


def _modules():
    for dirpath, dirnames, filenames in os.walk(HERE):
        dirnames[:] = [d for d in dirnames
                       if d not in ("tests", "__pycache__")]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_the_modules_are_read():
    paths = list(_modules())
    assert any(p.endswith("run.py") for p in paths)
    assert any(os.sep + "reference" + os.sep in p for p in paths)
    assert any(os.sep + "metrics" + os.sep in p for p in paths)


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_a_plain_reference(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "fluidframework_tpu_torch" not in names


def test_the_data_files_name_no_forbidden_module():
    import json

    for sub in ("configs", "traffic"):
        for name in os.listdir(os.path.join(HERE, sub)):
            with open(os.path.join(HERE, sub, name)) as f:
                data = json.load(f)
            for key in ("driver", "entry"):
                if key in data:
                    top = data[key].split(":")[0].split(".")[0]
                    assert top not in FORBIDDEN


def test_a_tiny_cell_runs_correct_on_the_cpu():
    spec = run.load_cell("string_long.cold")
    res, notes = run.run_cell(spec, 2 ** 31 + 99, 0.0, False, "cpu",
                              time.perf_counter(), n_docs=24, n_ops=96)
    assert notes["compared"] == 16 and len(notes["pass_ends_s"]) == 1
    assert res["correct"] is True
    assert res["attempted"] == 24 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert res["metrics"]["catchup_ops_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"catchup_ops_per_s", "setup_s"}
