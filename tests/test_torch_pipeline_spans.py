"""The pipeline's spans and CPU-time counters.

While a ``torch.profiler`` session runs, the calling (device) thread's
legs of ``pipelined_family_replay`` are ``record_function`` spans named
``pipeline.<leg>``, nested in ``pipeline.replay``; with no session they
cost a guard and return one shared null context.  The pack and extract
legs, which run on pool threads, report thread CPU seconds beside their
wall seconds (``pack_cpu`` / ``extract_cpu``)."""

import collections
import json
import threading

import pytest
import torch

from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.parallel import doc_mesh
from fluidframework_tpu_torch.parallel.shard import replay_mergetree_sharded
from fluidframework_tpu_torch.service.catchup_cache import DeltaExportCache
from fluidframework_tpu_torch.testing.workload import oracle_replay, synth_doc
from fluidframework_tpu_torch.utils import telemetry
from tests.torch_corpora import port_docs
from tests.torch_tiers import corpus, streams

#: the calling thread's spans inside ``pipeline.replay``, once a chunk
CHUNK_SPANS = ("pipeline.wait_pack", "pipeline.upload", "pipeline.dispatch",
               "pipeline.device_wait", "pipeline.download",
               "pipeline.wait_extract")


def _docs(n, n_ops=32):
    return [synth_doc(i, n_ops) for i in range(n)]


def _traced(tmp_path, fn):
    """``fn()``'s result and the ``pipeline.*`` spans of the profiled run
    as ``(name, tid, start, end)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["tid"], float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("pipeline.")]
    return out, spans


def _assert_oracle(docs, got):
    assert [s.digest() for s in got] == \
        [oracle_replay(d).summarize().digest() for d in docs]


def _pipelined(docs, stage):
    return pipeline.pipelined_mergetree_replay(docs, chunk_docs=8,
                                               stage=stage, device="cpu")


def _sharded(docs, stage):
    return replay_mergetree_sharded(docs, mesh=doc_mesh(["cpu"] * 2),
                                    stage=stage)


def test_spans_nest_in_the_replay_on_the_calling_thread(tmp_path):
    docs = _docs(24)
    stage = {}
    got, spans = _traced(tmp_path, lambda: _pipelined(docs, stage))
    _assert_oracle(docs, got)
    me = threading.get_native_id()
    assert {tid for _n, tid, _s, _e in spans} == {me}
    [(_, _, lo, hi)] = [s for s in spans if s[0] == "pipeline.replay"]
    counts = collections.Counter(name for name, *_ in spans)
    assert counts == {"pipeline.replay": 1, **dict.fromkeys(CHUNK_SPANS, 3)}
    for name, _tid, s, e in spans:
        assert lo <= s <= e <= hi, name
    # spans on one thread nest: none straddles another's end
    for a in spans:
        for b in spans:
            if a[2] < b[2] < a[3]:
                assert b[3] <= a[3], (a, b)


def test_delta_route_spans_its_digest_fetch_and_serves_no_extract(tmp_path):
    """Tier 0: the cold call downloads the digest plane and the export
    (two download spans a chunk), the warm exact call only the plane and
    serves every document without an extract: 0 wall, 0 CPU seconds."""
    docs = port_docs(corpus(streams(16, 32), lo=32))
    cache = DeltaExportCache()
    cold, warm, stats = {}, {}, {}
    _got, spans = _traced(
        tmp_path, lambda: pipeline.pipelined_mergetree_replay(
            docs, chunk_docs=8, stage=cold, delta_cache=cache,
            device="cpu"))
    counts = collections.Counter(name for name, *_ in spans)
    assert counts["pipeline.download"] == 4
    assert cold["extract_cpu"] > 0
    got = pipeline.pipelined_mergetree_replay(
        docs, chunk_docs=8, stage=warm, stats=stats, delta_cache=cache,
        device="cpu")
    _assert_oracle(docs, got)
    assert stats["delta_docs"] == len(docs)
    assert warm["extract"] == warm["extract_cpu"] == 0.0


def test_no_profiler_no_span(monkeypatch):
    """Without a profiler ``span`` hands back the one shared null context
    and ``record_function`` is never made; under one it is."""
    made = []
    real = torch.profiler.record_function

    def recording(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    assert not torch.autograd._profiler_enabled()
    assert telemetry.span("pipeline.replay") is telemetry.NULL_SPAN
    docs = _docs(16)
    _assert_oracle(docs, pipeline.pipelined_mergetree_replay(
        docs, chunk_docs=8, device="cpu"))
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert telemetry.span("pipeline.replay") is not telemetry.NULL_SPAN
        pipeline.pipelined_mergetree_replay(docs, chunk_docs=8, device="cpu")
    assert made.count("pipeline.replay") == 2
    assert made.count("pipeline.wait_pack") == 2


@pytest.mark.parametrize("run", [_pipelined, _sharded],
                         ids=["pipelined", "sharded"])
def test_cpu_twins_are_within_their_wall_time(run):
    docs = _docs(24)
    stage = {}
    _assert_oracle(docs, run(docs, stage))
    assert set(pipeline.HOST_CPU_KEYS) <= set(stage)
    for leg in ("pack", "extract"):
        assert 0 < stage[f"{leg}_cpu"] <= stage[leg] + 1e-3, leg


def test_sharded_legs_are_spans_on_the_calling_thread(tmp_path):
    docs = _docs(12)
    got, spans = _traced(tmp_path, lambda: _sharded(docs, {}))
    _assert_oracle(docs, got)
    assert {tid for _n, tid, _s, _e in spans} == \
        {threading.get_native_id()}
    assert collections.Counter(name for name, *_ in spans) == {
        f"pipeline.{leg}": 1 for leg in pipeline.STAGE_KEYS}
