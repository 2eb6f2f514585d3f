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
       ROOT / "tools" / "torch_kernel_turns.py"]
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
        "from fluidframework_tpu_torch.service import LocalOrderingService\n"
        "from fluidframework_tpu_torch.service.catchup import "
        "CatchupService\n"
        "from fluidframework_tpu_torch.testing import service_workload "
        "as sw\n"
        "service = LocalOrderingService()\n"
        "ids = sw.build_catchup_corpus(service, 3, 16)\n"
        "ids += sw.build_tree_catchup_corpus(service, 2, 16)\n"
        "import random\n"
        "sw.build_mixed_corpus(service, 2, random.Random(3), rounds=6)\n"
        "svc = CatchupService(service, device='cpu')\n"
        "res = svc.catch_up(upload=False)\n"
        "assert svc.cpu_docs == 0 and svc.device_docs == len(res) == 7\n"
        "assert all(res[d][0] == sw.catchup_oracle_digest(service, d)\n"
        "           for d in res)\n"
        "from fluidframework_tpu_torch.drivers.network_driver import (\n"
        "    NetworkDocumentServiceFactory)\n"
        "from fluidframework_tpu_torch.service.server import "
        "OrderingServer\n"
        "server = OrderingServer(service, device='cpu')\n"
        "thread = server.start_in_thread()\n"
        "factory = NetworkDocumentServiceFactory(port=server.port)\n"
        "out = factory._rpc.request('catchup', {})\n"
        "factory.close()\n"
        "server.loop.call_soon_threadsafe(server._server.close)\n"
        "thread.join(timeout=10)\n"
        "assert out['lane'] == 'fold' and out['deviceDocs'] == 7\n"
        "assert {d: s for d, (_h, s) in out['docs'].items()} == \\\n"
        "    {d: service.oplog.head(d) for d in res}\n"
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


def test_sharded_entries_and_front_door_with_jax_and_the_jax_package_blocked():
    """The doc-sharded entries of every family on a three-part CPU device
    list, and a front door over ``ThreadShard`` servers answering a
    ``catchup`` RPC, with JAX and the JAX package unimportable."""
    code = (
        "import sys, tempfile\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from fluidframework_tpu_torch.ops import map_kernel as mp\n"
        "from fluidframework_tpu_torch.ops import matrix_kernel as mk\n"
        "from fluidframework_tpu_torch.ops import mergetree_kernel as mt\n"
        "from fluidframework_tpu_torch.ops import tree_kernel as tk\n"
        "from fluidframework_tpu_torch.parallel import (doc_mesh,\n"
        "    replay_map_sharded, replay_matrix_sharded,\n"
        "    replay_mergetree_sharded, replay_tree_sharded)\n"
        "from fluidframework_tpu_torch.testing import config_workloads as cw\n"
        "from fluidframework_tpu_torch.testing.tree_workload import (\n"
        "    tree_windows)\n"
        "from fluidframework_tpu_torch.testing.workload import synth_doc\n"
        "mesh = doc_mesh(['cpu'] * 3)\n"
        "def same(a, b):\n"
        "    assert [s.digest() for s in a] == [s.digest() for s in b]\n"
        "docs = [synth_doc(i, 24) for i in range(5)]\n"
        "same(replay_mergetree_sharded(docs, mesh=mesh),\n"
        "     mt.replay_mergetree_batch(docs, device='cpu'))\n"
        "_base, grown = tree_windows(5, 24)\n"
        "same(replay_tree_sharded(grown, mesh=mesh),\n"
        "     tk.replay_tree_batch(grown, device='cpu'))\n"
        "docs = [cw.gen_map_doc(i, 24) for i in range(5)]\n"
        "same(replay_map_sharded(docs, mesh=mesh),\n"
        "     mp.replay_map_batch(docs, device='cpu'))\n"
        "docs = [cw.gen_matrix_doc(i, 24) for i in range(5)]\n"
        "same(replay_matrix_sharded(docs, mesh=mesh),\n"
        "     mk.replay_matrix_batch(docs, device='cpu'))\n"
        "from fluidframework_tpu_torch.drivers.network_driver import (\n"
        "    _RpcClient)\n"
        "from fluidframework_tpu_torch.service.frontdoor import FrontDoor\n"
        "from fluidframework_tpu_torch.testing import service_workload "
        "as sw\n"
        "door = FrontDoor(tempfile.mkdtemp(), n_shards=2, spawn='thread',\n"
        "                 device='cpu').start()\n"
        "rpc = _RpcClient('127.0.0.1', door.port, timeout=60)\n"
        "try:\n"
        "    ids = sw.write_catchup_corpus(rpc, 6, 24)\n"
        "    out = rpc.request('catchup', {'docs': ids}, timeout=60)\n"
        "finally:\n"
        "    rpc.close()\n"
        "    door.close()\n"
        "assert out['deviceDocs'] == 6 and out['cpuDocs'] == 0\n"
        "assert sorted(out['docs']) == sorted(ids)\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module,args", [
    ("shardhost", ["--shard-id", "s0"]),
    ("frontdoor", []),
])
def test_shard_tier_mains_default_to_the_card(tmp_path, module, args):
    """``shardhost`` and ``frontdoor`` default to ``--device cuda``: with
    no card they exit 2 naming the missing device before ``--dir`` is
    created; ``--device cpu`` passes the check."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default starts")
    target = tmp_path / "deploy"
    proc = subprocess.run(
        [sys.executable, "-m", f"fluidframework_tpu_torch.service.{module}",
         "--dir", str(target), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert not target.exists()


#: the modules of the last slice: the harnesses, the summarizer, the
#: framework layer and the tools
HOST_MODULES = (
    "testing", "testing.load", "testing.scenarios", "testing.fuzz",
    "testing.mocks", "runtime", "runtime.summarizer", "framework",
    "framework.data_object", "framework.fluid_static", "framework.presence",
    "framework.undo_redo", "tools", "tools.bench_harness", "tools.devtools",
    "tools.replay", "tools.loadgen")


def test_host_modules_and_the_swarm_with_jax_and_the_jax_package_blocked():
    """Every module of the harnesses, the summarizer, the framework layer
    and the tools imports with JAX and the JAX package unimportable, and
    a 100-client catch-up storm runs through the scenario engine with
    ``device="cpu"``, its oracle twin byte-identical."""
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"for name in {HOST_MODULES!r}:\n"
        "    importlib.import_module('fluidframework_tpu_torch.' + name)\n"
        "from fluidframework_tpu_torch.testing import (build_scenario,\n"
        "    run_swarm_with_oracle)\n"
        "spec = build_scenario('catchup-storm', seed=4, clients=100, docs=4,\n"
        "                      shards=2)\n"
        "result, twin = run_swarm_with_oracle(spec, device='cpu')\n"
        "assert result.joins == 100 and result.storm['requests'] > 0\n"
        "assert result.storm['served'] == result.storm['requests']\n"
        "assert result.sampled_digests == twin.sampled_digests\n"
        "assert result.per_doc_head == twin.per_doc_head\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_loadgen_lists_scenarios_with_jax_and_the_jax_package_blocked():
    """``python -m fluidframework_tpu_torch.tools.loadgen --list`` runs
    with JAX and the JAX package unimportable and prints every scenario."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'fluidframework_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['loadgen', '--list']\n"
        "try:\n"
        "    runpy.run_module('fluidframework_tpu_torch.tools.loadgen',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "assert not any(m.startswith(('jax', 'fluidframework_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from fluidframework_tpu_torch.testing.scenarios import scenario_docs

    for name in scenario_docs():
        assert name in proc.stdout


@pytest.mark.parametrize("entry", ["run_swarm", "run_swarm_with_oracle",
                                   "ClientSwarm"])
def test_swarm_without_device_raises_when_no_cuda(monkeypatch, entry):
    """The swarm's entries default to the card: with no CUDA device a
    call that names none raises before any server, shard or store is
    built."""
    from fluidframework_tpu_torch.testing import scenarios

    spec = scenarios.build_scenario("catchup-storm", seed=0, clients=16,
                                    docs=2, shards=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(scenarios, "LocalOrderingService",
                        lambda *a, **k: built.append(1))
    monkeypatch.setattr(scenarios, "ShardedOrderingService",
                        lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(scenarios, entry)(spec)
    assert built == []
