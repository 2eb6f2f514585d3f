"""The port's developer tools (``fluidframework_tpu_torch.tools``) against
the JAX package's: twins of tests/test_tools_and_load.py's replay tool and
its CLI (``python -m fluidframework_tpu_torch.tools.replay``), the bench
harness (statistics, the untimed setup, memory mode, the BENCH-JSON
writer, cold / warm mode) and the devtools runtime inspector.

The replay tool and the inspector run the same store or session on both
packages and their reports must be equal; the bench harness measures
wall time, so its twins hold the port to the reference's contract (run
counts, statistics over the samples, report text) and feed both the
same samples where a value is compared.
"""

import json
import os
import subprocess
import sys
import types

import pytest

import fluidframework_tpu.drivers as ref_drivers
import fluidframework_tpu.loader as ref_loader
import fluidframework_tpu.runtime.container as ref_container
import fluidframework_tpu.runtime.summarizer as ref_summarizer
import fluidframework_tpu.service as ref_service
import fluidframework_tpu.tools.bench_harness as ref_bench
import fluidframework_tpu.tools.devtools as ref_devtools
import fluidframework_tpu.tools.replay as ref_replay
import fluidframework_tpu_torch.drivers as port_drivers
import fluidframework_tpu_torch.loader as port_loader
import fluidframework_tpu_torch.runtime.container as port_container
import fluidframework_tpu_torch.runtime.summarizer as port_summarizer
import fluidframework_tpu_torch.service as port_service
import fluidframework_tpu_torch.tools.bench_harness as port_bench
import fluidframework_tpu_torch.tools.devtools as port_devtools
import fluidframework_tpu_torch.tools.replay as port_replay

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name, drivers, loader, container, summarizer, service, replay,
         devtools):
    return types.SimpleNamespace(
        name=name, drivers=drivers, Loader=loader.Loader,
        ContainerRuntime=container.ContainerRuntime,
        SummaryManager=summarizer.SummaryManager,
        SummarizerOptions=summarizer.SummarizerOptions,
        LocalOrderingService=service.LocalOrderingService,
        replay=replay.replay, inspect_runtime=devtools.inspect_runtime)


REF = _pkg("fluidframework_tpu", ref_drivers, ref_loader, ref_container,
           ref_summarizer, ref_service, ref_replay, ref_devtools)
PORT = _pkg("fluidframework_tpu_torch", port_drivers, port_loader,
            port_container, port_summarizer, port_service, port_replay,
            port_devtools)


# --- replay tool ----------------------------------------------------------------


def _make_store(pkg, root):
    factory = pkg.drivers.FileDocumentServiceFactory(root)
    loader = pkg.Loader(factory)

    def build(rt):
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")

    a = loader.create("doc", "alice", build)
    text = a.runtime.get_datastore("ds").get_channel("text")
    seqs = []
    for i in range(5):
        text.insert_text(0, f"[{i}]")
        a.drain()
        seqs.append((a.runtime.ref_seq, text.text))
    factory.close()
    return seqs


def _reports(pkg, root, seqs):
    out = []
    for seq, expected_text in seqs:
        report = pkg.replay(root, "doc", to_seq=seq)
        runtime = report.pop("_runtime")
        assert report["seq"] == seq
        channel = runtime.get_datastore("ds").get_channel("text")
        assert channel.text == expected_text
        out.append(report)
    head = pkg.replay(root, "doc")
    head.pop("_runtime")
    assert head["seq"] == seqs[-1][0]
    assert head["datastores"] == {"ds": {"text": "sequence-tpu"}}
    return out + [head]


def test_replay_tool_reconstructs_history(tmp_path):
    records = []
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg.name / "store")
        seqs = _make_store(pkg, root)
        records.append((seqs, _reports(pkg, root, seqs)))
    assert records[1] == records[0]


def test_replay_tool_reads_the_reference_store(tmp_path):
    """The file store's layout is shared: the port's tool replays a store
    the JAX package wrote, report for report."""
    root = str(tmp_path / "store")
    seqs = _make_store(REF, root)
    assert _reports(PORT, root, seqs) == _reports(REF, root, seqs)


def _cli(pkg, *args):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg.name}.tools.replay", *args],
        capture_output=True, text=True, check=True, cwd=REPO,
        timeout=120)


def test_replay_cli(tmp_path):
    root = str(tmp_path / "store")
    seqs = _make_store(PORT, root)
    out = _cli(PORT, root, "doc", "--json")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["seq"] == seqs[-1][0]
    assert report["summaryDigest"]
    shown = _cli(PORT, root, "doc", "--show", "ds/text")
    assert seqs[-1][1] in shown.stdout
    history = _cli(PORT, root, "doc", "--history", "--json")
    want = _cli(REF, root, "doc", "--json")
    assert out.stdout == want.stdout
    assert shown.stdout == _cli(REF, root, "doc", "--show",
                                "ds/text").stdout
    assert history.stdout == _cli(REF, root, "doc", "--history",
                                  "--json").stdout


# --- bench harness ----------------------------------------------------------------


@pytest.mark.parametrize("bench", [ref_bench, port_bench],
                         ids=["ref", "port"])
def test_benchmark_statistics(bench):
    calls = []
    result = bench.benchmark(lambda: calls.append(1), name="noop",
                             min_runs=5, min_time_s=0.0, warmup_runs=1)
    assert result.runs >= 5
    assert len(calls) == result.runs + 1  # warmup included
    assert result.mean >= 0
    assert result.p50 <= result.p95 or result.runs < 3
    assert "noop" in result.report()


def test_benchmark_statistics_over_the_same_samples():
    samples = [0.003, 0.001, 0.004, 0.001, 0.005, 0.009, 0.002]
    ref = ref_bench.BenchmarkResult("s", len(samples), list(samples))
    port = port_bench.BenchmarkResult("s", len(samples), list(samples))
    for attr in ("mean", "stddev", "p50", "p95", "ops_per_sec"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.report() == ref.report()
    cw = dict(name="cw", cold_s=0.5, warm_s=0.1, warm_runs=3,
              cold_d2h_bytes=10, warm_d2h_bytes=2, cold_h2d_bytes=7,
              warm_h2d_bytes=0)
    assert port_bench.ColdWarmResult(**cw).report() \
        == ref_bench.ColdWarmResult(**cw).report()
    mem = dict(name="m", peak_bytes=5_000_000, retained_bytes=10)
    assert port_bench.MemoryResult(**mem).report() \
        == ref_bench.MemoryResult(**mem).report()


@pytest.mark.parametrize("bench", [ref_bench, port_bench],
                         ids=["ref", "port"])
def test_benchmark_setup_untimed(bench):
    def setup():
        return list(range(1000))

    timed = bench.benchmark(lambda data: sum(data), min_runs=3,
                            min_time_s=0, warmup_runs=0, setup=setup)
    assert timed.runs == 3


@pytest.mark.parametrize("bench", [ref_bench, port_bench],
                         ids=["ref", "port"])
def test_benchmark_memory(bench):
    result = bench.benchmark_memory(lambda: bytearray(5_000_000),
                                    name="alloc")
    assert result.peak_bytes > 4_000_000
    assert "alloc" in result.report()


def test_cold_warm_attributes_stage_bytes():
    def run(bench):
        stage = {"d2h_bytes": 0, "h2d_bytes": 0}

        def fn():
            stage["d2h_bytes"] += 100 if stage["h2d_bytes"] == 0 else 8
            stage["h2d_bytes"] += 50
        r = bench.benchmark_cold_warm(fn, name="cw", warm_runs=2,
                                      stage=stage)
        return (r.warm_runs, r.cold_d2h_bytes, r.warm_d2h_bytes,
                r.cold_h2d_bytes, r.warm_h2d_bytes)

    assert run(port_bench) == run(ref_bench) == (2, 100, 8, 50, 50)


def test_bench_json_writer(tmp_path, capsys):
    report = {"b": 1, "a": {"y": None, "x": [1, 2]}}
    for compact in (False, True):
        assert port_bench.render_bench_json(report, compact) \
            == ref_bench.render_bench_json(report, compact)
    out = tmp_path / "bench.json"
    text = port_bench.write_bench_json(report, str(out))
    assert out.read_text() == text \
        == json.dumps(report, indent=2, sort_keys=True) + "\n"
    assert port_bench.write_bench_json(report, compact=True) \
        == capsys.readouterr().out


# --- devtools -------------------------------------------------------------------


def test_devtools_inspector_snapshot():
    """The runtime inspector renders live state read-only (channels,
    quorum, proposals, summarizer stats), the same snapshot in both
    packages, and inspecting twice gives the same snapshot."""
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        ep = service.create_document("doc")
        rt = pkg.ContainerRuntime()
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")
        ds.create_channel("counter-tpu", "n")
        rt.connect(ep, "alice")
        rt.drain()
        mgr = pkg.SummaryManager(rt, service.storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=1000))
        rt.get_datastore("ds").get_channel("text").insert_text(0, "hello")
        rt.get_datastore("ds").get_channel("kv").set("k", 1)
        rt.get_datastore("ds").get_channel("n").increment(2)
        rt.propose("code", "v1")
        rt.drain()
        snap = pkg.inspect_runtime(rt, summary_manager=mgr)
        json.dumps(snap)  # JSON-safe
        assert snap["clientId"] == "alice"
        assert snap["quorum"] == ["alice"]
        channels = snap["datastores"]["ds"]["channels"]
        assert channels["text"]["preview"] == "hello"
        assert channels["kv"]["preview"] == {"k": 1}
        assert channels["n"]["value"] == 2
        assert snap["proposals"]["pending"] or snap["proposals"]["accepted"]
        assert snap["summarizer"]["isSummarizer"] is True
        assert pkg.inspect_runtime(rt, summary_manager=mgr) == snap
        return snap

    assert scenario(PORT) == scenario(REF)
