"""The port stands alone: no JAX, nothing of the JAX package, and no
quiet fall back to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "fluidframework_tpu_torch"
# build/ (gitignored) holds build outputs, not the port's sources
PORT_FILES = sorted(p for p in PORT.rglob("*.py")
                    if PORT / "build" not in p.parents) \
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_fold_variants.py",
       ROOT / "tools" / "torch_pipeline_turns.py"]
FORBIDDEN = ("jax", "jaxlib", "fluidframework_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_replays_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fluidframework_tpu_torch.ops.mergetree_kernel import "
        "replay_mergetree_batch\n"
        "from fluidframework_tpu_torch.testing.workload import "
        "oracle_replay, synth_doc\n"
        "docs = [synth_doc(i, 24) for i in range(4)]\n"
        "got = replay_mergetree_batch(docs, device='cpu')\n"
        "want = [oracle_replay(d).summarize().digest() for d in docs]\n"
        "assert [s.digest() for s in got] == want\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.testing.workload import synth_doc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.replay_mergetree_batch([synth_doc(0, 8)])


def test_wrapper_refuses_non_cuda_non_cpu_tensors():
    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt

    ops = mt.MTOps(*[torch.zeros((1, 4), dtype=torch.int32, device="meta")
                     for _ in range(9)],
                   pvals=torch.zeros((1, 4, 1), dtype=torch.int32,
                                     device="meta"))
    state = mt.cold_start(ops, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fold_cuda.fold(state, ops)


def test_wrapper_checks_what_the_kernel_reads():
    """The launch-side validation runs on any device: well-formed packed
    tensors pass; a wrong dtype, shape or layout is refused."""
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.testing.workload import synth_doc

    st_np, ops_np, _meta = mt.pack_mergetree_batch(
        [synth_doc(i, 20) for i in range(3)])
    cpu = torch.device("cpu")
    state, ops = tensors_to(st_np, cpu), tensors_to(ops_np, cpu)
    assert fold_cuda._check(state, ops, cpu) == (
        3, st_np.tstart.shape[1], ops_np.kind.shape[1], 1)
    bad = [
        (state._replace(n=state.n.long()), ops, "state.n is torch.int64"),
        (state, ops._replace(tlen=ops.tlen[:, :8]), "ops.tlen has shape"),
        (state._replace(tstart=state.tstart.t().contiguous().t()), ops,
         "state.tstart is not contiguous"),
        (state, ops._replace(kind=ops.kind.to("meta")), "ops.kind lies on"),
    ]
    for st, op, msg in bad:
        with pytest.raises(ValueError, match=msg):
            fold_cuda._check(st, op, cpu)


def test_tree_port_replays_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fluidframework_tpu_torch.ops.tree_kernel import (\n"
        "    oracle_fallback_summary, replay_tree_batch)\n"
        "from fluidframework_tpu_torch.ops.tree_pipeline import (\n"
        "    pipelined_tree_replay)\n"
        "from fluidframework_tpu_torch.testing.tree_workload import (\n"
        "    tree_windows)\n"
        "base, grown = tree_windows(8, 24)\n"
        "want = [oracle_fallback_summary(d).digest() for d in grown]\n"
        "got = replay_tree_batch(grown, device='cpu')\n"
        "assert [s.digest() for s in got] == want\n"
        "got = pipelined_tree_replay(grown, chunk_docs=4, device='cpu')\n"
        "assert [s.digest() for s in got] == want\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["replay_tree_batch",
                                   "pipelined_tree_replay"])
def test_tree_entry_points_without_device_raise_when_no_cuda(monkeypatch,
                                                             entry):
    from fluidframework_tpu_torch.ops import tree_kernel, tree_pipeline
    from fluidframework_tpu_torch.testing.tree_workload import tree_windows

    fn = getattr(tree_kernel, entry, None) or getattr(tree_pipeline, entry)
    base, _grown = tree_windows(4, 24)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(base[3:])


def test_map_and_matrix_port_replay_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fluidframework_tpu_torch.ops import map_kernel as mp\n"
        "from fluidframework_tpu_torch.ops import matrix_kernel as mk\n"
        "from fluidframework_tpu_torch.testing import config_workloads as cw\n"
        "docs = cw.hard_map_docs() + [cw.gen_map_doc(i, 24) for i in range(4)]\n"
        "got = mp.replay_map_batch(docs, device='cpu')\n"
        "assert [s.digest() for s in got] == \\\n"
        "    [mp.oracle_map_summary(d).digest() for d in docs]\n"
        "docs = cw.hard_matrix_docs()[-3:] + \\\n"
        "    [cw.gen_matrix_doc(i, 24) for i in range(4)]\n"
        "got = mk.replay_matrix_batch(docs, device='cpu')\n"
        "assert [s.digest() for s in got] == \\\n"
        "    [mk.oracle_matrix_fallback(d).digest() for d in docs]\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
