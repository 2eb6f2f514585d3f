"""The port's load-generator CLI (``fluidframework_tpu_torch.tools.loadgen``)
against the JAX package's (``tools/loadgen.py``): the same scenarios, the
same report schema and, at one seed, the same storm counters and verdict.
The port's CLI folds on ``--device`` (default ``cuda``) and refuses to
start without it."""

import json

import pytest
import torch

from fluidframework_tpu_torch.testing.scenarios import scenario_docs
from fluidframework_tpu_torch.tools import loadgen

#: a small storm both CLIs run at one seed; the rate floor is off, since
#: a wall-clock rate is no semantic (the reference's first folds compile)
STORM_ARGS = ["--storm", "--clients", "400", "--docs", "4", "--shards", "4",
              "--seed", "3", "--gate", "0"]
#: the storm record's keys that depend on the run's semantics alone (the
#: reference's storm server folds on the conftest's 8-device virtual
#: mesh, so its tier byte counters differ from the port's one device)
STORM_KEYS = ("mode", "requests", "served", "warm", "folds", "shed",
              "degraded", "retries", "fold_errors", "shed_rate",
              "latency_p50_ticks", "latency_p99_ticks", "latency_samples",
              "cache_hit_rate", "degraded_serves", "admission",
              "admission_balance_ok", "fault_coverage_ok", "gate_p99_ticks")
#: the scenario record's keys that depend on the seed alone
SCENARIO_KEYS = ("clients", "docs", "shards", "replicas", "ticks", "seed",
                 "sequenced_ops", "ops_stamped", "ops_deduped", "joins",
                 "gate_ops_per_sec", "delivery_p50_ticks",
                 "delivery_p99_ticks", "delivery_samples",
                 "catchup_p50_ticks", "catchup_p99_ticks",
                 "catchup_samples", "max_pending_depth", "defers",
                 "join_defers", "kills", "sampled_docs", "oracle_match",
                 "replay_identical", "fault_counts", "columnar",
                 "out_of_proc", "passed")


def _report(main, tmp_path, name, args):
    out = tmp_path / name
    rc = main([*args, "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_loadgen_list_prints_every_scenario(capsys):
    assert loadgen.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name, doc in scenario_docs().items():
        assert name in out
        assert doc.split()[0] in out


def test_loadgen_writes_schema_stable_bench_json(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc = loadgen.main(["--scenario", "steady-typing", "--clients", "400",
                       "--docs", "4", "--seed", "3", "--no-oracle",
                       "--device", "cpu", "--out", str(out)])
    capsys.readouterr()
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["platform"] == "cpu"
    scenario = doc["scenarios"]["steady-typing"]
    # schema-stable nulls: skipped checks are present, not absent
    assert scenario["oracle_match"] is None
    assert scenario["replay_identical"] is None
    assert scenario["passed"] is True
    assert scenario["ops_per_sec"] > 0
    # the shared writer sorts keys — the file round-trips canonically
    assert out.read_text() == json.dumps(doc, indent=2, sort_keys=True) + "\n"


def test_storm_verdict_and_counters_equal_the_reference_cli(tmp_path,
                                                            capsys):
    """``--storm --device cpu`` against the JAX package's CLI at the same
    seed: the same report keys, storm counters and verdict."""
    from tools.loadgen import main as ref_main

    rc, port = _report(loadgen.main, tmp_path, "port.json",
                       STORM_ARGS + ["--device", "cpu"])
    ref_rc, ref = _report(ref_main, tmp_path, "ref.json", STORM_ARGS)
    capsys.readouterr()
    assert rc == ref_rc == 0
    assert set(port) == set(ref)
    got = port["scenarios"]["catchup-storm"]
    want = ref["scenarios"]["catchup-storm"]
    assert set(got) == set(want)
    assert set(got["storm"]) == set(want["storm"])
    assert {k: got[k] for k in SCENARIO_KEYS} == \
        {k: want[k] for k in SCENARIO_KEYS}
    assert {k: got["storm"][k] for k in STORM_KEYS} == \
        {k: want["storm"][k] for k in STORM_KEYS}
    assert got["passed"] and got["storm"]["folds"] > 0


def test_verdict_names_each_storm_condition():
    """The gate the chip smoke reads: one named check a condition, and
    ``passed`` only when every one holds."""
    from fluidframework_tpu_torch.testing.scenarios import (
        build_scenario, oracle_spec, run_swarm)

    spec = build_scenario("catchup-storm", seed=3, clients=400, docs=4,
                          shards=4)
    result = run_swarm(spec, device="cpu")
    twin = run_swarm(oracle_spec(spec, result), device="cpu")
    report = loadgen.storm_record(spec, result)
    same = (result.sampled_digests == twin.sampled_digests
            and result.per_doc_head == twin.per_doc_head)
    gate = loadgen.GATES_OPS_PER_SEC["catchup-storm"]
    checks = loadgen.verdict(result, 1.0, gate, oracle_match=same,
                             storm_report=report)
    assert checks == {"rate_ok": True, "oracle_ok": True, "replay_ok": True,
                      "boxed_ok": True, "served_all": True,
                      "admission_balance_ok": True,
                      "fault_coverage_ok": True, "p99_ok": True,
                      "passed": True}
    slow = loadgen.verdict(result, result.sequenced_ops / gate * 2, gate,
                           oracle_match=same, storm_report=report)
    assert not slow["rate_ok"] and not slow["passed"]
    late = dict(report, latency_p99_ticks=loadgen.STORM_GATE_P99_TICKS + 1)
    assert not loadgen.verdict(result, 1.0, gate,
                               storm_report=late)["p99_ok"]
    unserved = dict(report, served=report["requests"] - 1)
    assert not loadgen.verdict(result, 1.0, gate,
                               storm_report=unserved)["passed"]
    assert not loadgen.verdict(result, 1.0, gate, oracle_match=False,
                               storm_report=report)["passed"]


def test_out_of_proc_storm_runs_its_shards_on_the_cpu(tmp_path, capsys):
    """``--out-of-proc --device cpu``: the shard processes start with
    ``--device cpu``, fold every elected catch-up and match the
    in-process twin (the rate floor is off: at this size the two shard
    processes' start dominates the wall)."""
    rc, report = _report(
        loadgen.main, tmp_path, "proc.json",
        ["--storm", "--out-of-proc", "--clients", "200", "--docs", "4",
         "--shards", "2", "--seed", "3", "--gate", "0", "--device", "cpu"])
    capsys.readouterr()
    assert rc == 0
    scenario = report["scenarios"]["catchup-storm"]
    assert scenario["out_of_proc"] is True
    assert scenario["oracle_match"] is True
    assert scenario["storm"]["served"] == scenario["storm"]["requests"] > 0
    assert scenario["passed"] is True


def test_loadgen_without_device_exits_when_no_cuda(capsys):
    """With no card the default ``--device cuda`` exits 2 naming the
    missing device before any run starts; ``--list`` needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default starts")
    with pytest.raises(SystemExit) as exc:
        loadgen.main(["--storm", "--clients", "200", "--docs", "4"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
