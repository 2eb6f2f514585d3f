"""The idle time of a traced window put down to the program's spans
(``portbench.spans``), and the pipeline's off-CPU readers, over a
hand-built Chrome trace (CPU).

    python3 -m pytest portbench/tests/test_portbench_trace.py -q
"""

import json
import os
import time
from types import SimpleNamespace

import pytest

from portbench import run, spans, trace

#: the pass's thread, and another whose spans are left out
MAIN, POOL = 11, 12
FOLD = "mergetree_fold_kernel<true, true, false>"


def _x(name, cat, ts, end, tid=MAIN):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts,
            "pid": 1, "tid": tid}


def _events(program=True):
    """Two passes, device work inside and between them, nested program
    spans on the pass's thread (microseconds)."""
    ev = [
        _x(trace.PASS_SPAN, "user_annotation", 0, 1000),
        _x(trace.PASS_SPAN, "user_annotation", 1100, 1600),
        _x(FOLD, "kernel", 300, 500, tid=7),
        _x("Memcpy HtoD", "gpu_memcpy", 600, 650, tid=8),
        _x("Memcpy HtoD", "gpu_memcpy", 1020, 1040, tid=8),  # between
        _x(FOLD, "kernel", 1200, 1300, tid=7),
        _x("aten::copy_", "cpu_op", 0, 1600),
        {"ph": "i", "name": "pipeline.wait_pack", "cat": "user_annotation",
         "ts": 5, "pid": 1, "tid": MAIN},
    ]
    if program:
        ev += [
            _x("pipeline.replay", "user_annotation", 10, 990),
            _x("pipeline.wait_pack", "user_annotation", 20, 290),
            _x("pipeline.upload", "user_annotation", 290, 295),
            _x("pipeline.download", "user_annotation", 500, 560),
            _x("pipeline.wait_extract", "user_annotation", 700, 980),
            _x("pipeline.replay", "user_annotation", 1100, 1590),
            _x("pipeline.wait_pack", "user_annotation", 1105, 1195),
            _x("pipeline.wait_extract", "user_annotation", 1300, 1580),
            # another thread's span, and the device-side twin of a span
            _x("pipeline.wait_extract", "user_annotation", 0, 1600,
               tid=POOL),
            _x("pipeline.upload", "gpu_user_annotation", 0, 1600, tid=7),
        ]
    return ev


@pytest.fixture
def trace_path(tmp_path):
    def write(program=True):
        path = tmp_path / f"trace-{program}.json"
        path.write_text(json.dumps({"traceEvents": _events(program)}))
        return str(path)
    return write


#: the idle microseconds of ``_events()``, worked by hand
IDLE_BY_SPAN_US = {"pipeline.replay": 135, "pipeline.wait_pack": 360,
                   "pipeline.upload": 5, "pipeline.download": 60,
                   "pipeline.wait_extract": 560, spans.NO_SPAN: 30}
IDLE_GAPS_US = {"entry.head": 10, "entry.head/pipeline.replay": 25,
                "entry.head/pipeline.wait_pack": 360,
                "entry.head/pipeline.upload": 5,
                "entry.mid/pipeline.download": 60,
                "entry.mid/pipeline.replay": 40,
                "entry.tail/pipeline.replay": 70,
                "entry.tail/pipeline.wait_extract": 560,
                "entry.tail": 20, "harness": 80}


def _approx_us(us):
    return {k: pytest.approx(v * 1e-6, abs=1e-12) for k, v in us.items()}


def test_idle_by_span_takes_the_innermost_span_of_the_pass_thread(
        trace_path):
    got = spans.reduce_trace_by_span(trace_path())
    assert got["idle_by_span"] == _approx_us(IDLE_BY_SPAN_US)
    assert dict(got["idle_gaps"]) == _approx_us(IDLE_GAPS_US)
    # with the harness's idle, every idle second of the window
    idle = got["window_s"] - got["busy_s"]
    assert sum(got["idle_by_span"].values()) \
        + dict(got["idle_gaps"])["harness"] == pytest.approx(idle)


@pytest.mark.parametrize("program", [True, False],
                         ids=["with-spans", "without-spans"])
def test_split_gaps_sum_to_the_positional_totals(trace_path, program):
    path = trace_path(program)
    plain = dict(trace.reduce_trace(path)["idle_gaps"])
    assert plain == _approx_us({"entry.head": 400, "entry.mid": 100,
                                "entry.tail": 650, "harness": 80})
    split = spans.reduce_trace_by_span(path)["idle_gaps"]
    totals = {}
    for key, seconds in split:
        pos = key.split("/")[0]
        totals[pos] = totals.get(pos, 0.0) + seconds
    assert totals == {k: pytest.approx(v, abs=1e-12)
                      for k, v in plain.items()}


def test_a_program_without_spans_reads_no_span_alone(trace_path):
    """The parent's program opens no ``pipeline.*`` span: everything
    reads ``(no span)``, the breakdown as ``reduce_trace`` gives it."""
    path = trace_path(program=False)
    got = spans.reduce_trace_by_span(path)
    assert got["idle_by_span"] == _approx_us({spans.NO_SPAN: 1150})
    assert got["idle_gaps"] == [
        [k, pytest.approx(v, abs=1e-12)]
        for k, v in trace.reduce_trace(path)["idle_gaps"]]
    assert spans.idle_share(got, "pipeline.wait_pack") is None


def test_the_rest_is_reduce_trace_unchanged(trace_path):
    path = trace_path()
    plain, split = trace.reduce_trace(path), spans.reduce_trace_by_span(path)
    for key in ("window_s", "busy_s", "by_name", "device_ops"):
        assert split[key] == plain[key], key
    assert plain["window_s"] == pytest.approx(1600e-6)
    assert plain["busy_s"] == pytest.approx(370e-6)
    assert spans.reduce_trace_by_span(_empty(path)) == {}


def _empty(path):
    empty = path + ".empty.json"
    with open(empty, "w") as f:
        json.dump({"traceEvents": [_x("k", "kernel", 0, 5)]}, f)
    return empty


def test_idle_shares(trace_path):
    got = spans.reduce_trace_by_span(trace_path())
    assert spans.idle_share(got, "pipeline.wait_pack") == \
        pytest.approx(100.0 * 360 / 1600)
    assert spans.idle_share(got, "pipeline.wait_extract") == \
        pytest.approx(100.0 * 560 / 1600)
    assert spans.idle_share(got, "pipeline.dispatch") is None
    assert spans.idle_share({}, "pipeline.wait_pack") is None


def _reading(trace=None, **kw):
    base = dict(ops=4_096_000, passes=2, window_s=2.0, setup_s=1.0,
                n_docs=2048, stage={}, stats={"fallback_docs": 0},
                trace=trace or {}, peak_window_bytes=2 ** 20,
                device_kind="NVIDIA H100 80GB HBM3", on_card=True,
                work={"int_ops_per_op": 100.0, "bytes_per_op": 40.0})
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("leg", ["pack", "extract"])
def test_offcpu_readers(leg):
    read = run.load_reader(f"{leg}_offcpu_ms_per_kop")
    stage = {leg: 2.0, f"{leg}_cpu": 1.5}
    assert read(_reading(stage=stage)) == pytest.approx(0.5e3 / 4096)
    assert read(_reading(stage={leg: 2.0})) is None  # no CPU twin
    assert read(_reading(stage={})) is None
    assert read(_reading(stage=stage, ops=0)) is None


def test_existing_readers_read_the_same_on_either_reduction(trace_path):
    """Every metric the benchmark had reads the same off ``reduce_trace``
    and off its split by span, on the same trace."""
    path = trace_path()
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [m["name"] for m in bench["per_layer"] + bench["end_to_end"]
             if "offcpu" not in m["name"]]
    assert len(names) == 11
    stage = {"pack": 1.0, "extract": 2.0, "h2d_bytes": 10, "d2h_bytes": 20}
    for name in names:
        read = run.load_reader(name)
        plain = read(_reading(trace.reduce_trace(path), stage=stage))
        split = read(_reading(spans.reduce_trace_by_span(path), stage=stage))
        assert plain == split, name
        assert plain is not None, name


def test_a_tiny_traced_cell_puts_its_idle_down_to_the_spans():
    """The CPU rehearsal of a traced run: every pipeline span of the pass
    thread is read, the off-CPU metrics are reported, and
    ``reduce_trace`` is left as it was."""
    plain = trace.reduce_trace
    spec = run.load_cell("string_long.cold")
    res, _notes = spans.run_traced(spec, 2 ** 31 + 77, 0.0, "cpu",
                                   time.perf_counter(), n_docs=24, n_ops=96)
    assert trace.reduce_trace is plain
    assert res["correct"] is True
    by_span = res["breakdown"]["idle_by_span"]
    assert {"pipeline.replay", "pipeline.wait_pack", "pipeline.upload",
            "pipeline.dispatch", "pipeline.wait_extract"} <= set(by_span)
    assert by_span["pipeline.replay"] > 0
    for name in ("pack_offcpu_ms_per_kop", "extract_offcpu_ms_per_kop"):
        assert name in res["metrics"], name
