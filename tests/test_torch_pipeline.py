"""The slice as a whole: the port's ``replay_mergetree_batch`` and
``pipelined_mergetree_replay`` on the CPU against the JAX package's and
the oracle's summaries, byte for byte, with the reference's stage schema
and byte counts."""

import pytest

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.ops import pipeline as ref_pipeline
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import (bench_docs, hard_docs, interval_docs,
                                 overflow_doc, port_docs, reference_doc,
                                 warm_doc)

PIPELINE_CORPORA = {
    "bench-64x96": lambda: bench_docs(64, 96),
    "hard": hard_docs,
    "intervals": lambda: interval_docs(range(4)),
    "warm": lambda: [warm_doc()],
    "overflow": lambda: [overflow_doc()],
    "mixed": lambda: hard_docs() + [warm_doc(), overflow_doc()]
    + bench_docs(8, 32),
}


@pytest.mark.parametrize("corpus", sorted(PIPELINE_CORPORA))
def test_port_summaries_match_jax_and_oracle(corpus):
    ref_docs = PIPELINE_CORPORA[corpus]()
    r_stats, p_stats = {}, {}
    ref = ref_mt.replay_mergetree_batch(ref_docs, stats=r_stats)
    got = mt.replay_mergetree_batch(port_docs(ref_docs), stats=p_stats,
                                    device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in ref]
    oracle = [ref_mt.oracle_fallback_summary(d).digest() for d in ref_docs]
    assert [s.digest() for s in got] == oracle
    assert p_stats == r_stats
    assert p_stats["device_docs"] + p_stats.get("fallback_docs", 0) == \
        len(ref_docs)


def test_overflow_doc_falls_back_to_the_oracle():
    stats = {}
    [summary] = mt.replay_mergetree_batch([workload.overflow_doc()],
                                          stats=stats, device="cpu")
    assert stats == {"fallback_docs": 1, "device_docs": 0}
    oracle = workload.oracle_replay(workload.overflow_doc()).summarize()
    assert summary.digest() == oracle.digest()


def test_port_oracle_matches_jax_oracle_on_fixture():
    for doc in workload.hard_docs():
        ref = ref_mt.oracle_fallback_summary(reference_doc(doc))
        assert workload.oracle_replay(doc).summarize().digest() == \
            ref.digest(), doc.doc_id


def test_attribution_docs_raise_not_implemented():
    doc = workload.synth_doc(0, 8)
    doc.attribution = True
    with pytest.raises(NotImplementedError, match="later slice"):
        mt.replay_mergetree_batch([doc], device="cpu")


def test_python_extraction_matches_native_bodies():
    """Without liboppack the port extracts bodies in Python; the bytes
    equal the C++ extractor's."""
    from fluidframework_tpu_torch.ops import native_pack

    docs = hard_docs() + bench_docs(12, 48)
    native = mt.replay_mergetree_batch(port_docs(docs), device="cpu")
    saved = native_pack.extract_bodies
    native_pack.extract_bodies = lambda *a, **k: None
    try:
        python = mt.replay_mergetree_batch(port_docs(docs), device="cpu")
    finally:
        native_pack.extract_bodies = saved
    assert [s.digest() for s in python] == [s.digest() for s in native]


#: batches for the pipelined path: several chunks each (chunk_docs=8),
#: cold and warm, props-free and annotating, with fallbacks
PIPELINED_CORPORA = {
    "bench-40x32": lambda: bench_docs(40, 32),
    "mixed": lambda: hard_docs() + [warm_doc(), overflow_doc()]
    + bench_docs(20, 24) + interval_docs(range(2)),
}


@pytest.fixture
def _xla_fold(monkeypatch):
    monkeypatch.delenv("FF_PALLAS_FOLD", raising=False)


@pytest.mark.parametrize("corpus", sorted(PIPELINED_CORPORA))
def test_pipelined_matches_jax_pipeline_and_oracle(corpus, _xla_fold):
    ref_docs = PIPELINED_CORPORA[corpus]()
    r_stage, p_stage, r_stats, p_stats = {}, {}, {}, {}
    ref = ref_pipeline.pipelined_mergetree_replay(
        ref_docs, chunk_docs=8, stage=r_stage, stats=r_stats)
    got = pipeline.pipelined_mergetree_replay(
        port_docs(ref_docs), chunk_docs=8, stage=p_stage, stats=p_stats,
        device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in ref]
    oracle = [ref_mt.oracle_fallback_summary(d).digest() for d in ref_docs]
    assert [s.digest() for s in got] == oracle
    assert p_stats == r_stats
    assert set(p_stage) == set(r_stage)
    for key in ("h2d_bytes", "d2h_bytes"):
        assert p_stage[key] == r_stage[key] > 0, key


def test_stage_schema_matches_reference():
    assert pipeline.STAGE_KEYS == ref_pipeline.STAGE_KEYS
    port, ref = {}, {}
    pipeline.seed_stage(port)
    ref_pipeline.seed_stage(ref)
    assert port == ref


def test_all_fallback_batch_still_reports_every_stage():
    """A batch that routes entirely to the oracle never reaches the
    device, and the stage dict still carries every key."""
    import dataclasses

    family = dataclasses.replace(pipeline.MERGETREE_FAMILY,
                                 known_fallback=lambda doc: True)
    stage, stats = {}, {}
    [summary] = pipeline.pipelined_family_replay(
        family, [workload.overflow_doc()], stage=stage, stats=stats,
        device="cpu")
    assert stats == {"fallback_docs": 1}
    assert set(stage) == set(pipeline.STAGE_KEYS) | {"h2d_bytes",
                                                     "d2h_bytes"}
    assert stage["h2d_bytes"] == stage["d2h_bytes"] == 0
    assert summary.digest() == \
        workload.oracle_replay(workload.overflow_doc()).summarize().digest()


def test_schedule_keeps_the_callers_order():
    """Annotating documents interleaved with text-only ones: scheduling
    groups them into props-free and annotating chunks, and the results
    still come back in the caller's order, equal to the unscheduled run."""
    docs = [workload.synth_doc(i, 24) for i in range(30)]
    order = pipeline._mt_order(docs, True)
    assert order != list(range(len(docs)))
    packed = []
    scheduled = pipeline.pipelined_mergetree_replay(
        docs, chunk_docs=8, packed_out=packed, device="cpu")
    plain = pipeline.pipelined_mergetree_replay(
        docs, chunk_docs=8, schedule=False, device="cpu")
    assert [s.digest() for s in scheduled] == [s.digest() for s in plain]
    want = [workload.oracle_replay(d).summarize().digest() for d in docs]
    assert [s.digest() for s in scheduled] == want
    assert [m["has_props"] for _st, _ops, m, _tag in packed][0] is False
    # packed_out holds the uploaded (narrowed) host arrays, per chunk
    assert len(packed) == 4
    for state, ops, meta, tag in packed:
        assert state is None and tag == meta["_S"]
        assert ops.seq.dtype.itemsize == 2


def test_device_handle_on_cpu_returns_numpy_views():
    """The handle's CPU leg: nothing to wait for or copy; the fetch gives
    numpy leaves in the export's structure."""
    import torch

    core = (torch.arange(6, dtype=torch.int16).reshape(1, 2, 3),
            torch.ones((1, 4), dtype=torch.int32))
    handle = pipeline.DeviceExport(core)
    handle.block_until_ready()
    handle.copy_to_host_async()
    rows, misc = mt.export_to_numpy(handle)
    assert rows.dtype.name == "int16" and rows.shape == (1, 2, 3)
    assert misc.tolist() == [[1, 1, 1, 1]]


def test_pinned_host_slots_refuse_reuse_while_busy():
    """The pinned ring guards its own invariant: a slot is handed out
    again only after its chunk's extraction released it (checked here
    without pinning, which needs a card)."""
    slots = pipeline._HostSlots(2)
    slots._busy = [True, False]
    with pytest.raises(RuntimeError, match="still in use"):
        slots.take([])
