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
from tests.torch_corpora import (bench_docs, fuzz_doc, hard_docs,
                                 interval_docs, overflow_doc, port_docs,
                                 port_stage_keys, reference_doc, twinned,
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
    """Attribution documents are served now (they raised before the port
    had them): the pinned stream with the flag set folds to the JAX
    package's and the attributed oracle's bytes, through both entries.
    The name is the one the refusal test had; it is kept so that the
    test stays the same test across the change, though it no longer
    describes the check."""
    ref_docs = bench_docs(6, 24)
    for doc in ref_docs:
        doc.attribution = True
    ref = ref_mt.replay_mergetree_batch(ref_docs)
    oracle = [ref_mt.oracle_fallback_summary(d).digest() for d in ref_docs]
    assert [s.digest() for s in ref] == oracle
    got = mt.replay_mergetree_batch(port_docs(ref_docs), device="cpu")
    assert [s.digest() for s in got] == oracle
    got = pipeline.pipelined_mergetree_replay(port_docs(ref_docs),
                                              chunk_docs=4, device="cpu")
    assert [s.digest() for s in got] == oracle


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
    assert set(p_stage) == port_stage_keys(r_stage)
    for key in ("h2d_bytes", "d2h_bytes"):
        assert p_stage[key] == r_stage[key] > 0, key


def test_stage_schema_matches_reference():
    assert pipeline.STAGE_KEYS == ref_pipeline.STAGE_KEYS
    port, ref = {}, {}
    pipeline.seed_stage(port)
    ref_pipeline.seed_stage(ref)
    assert port == {**ref, **dict.fromkeys(pipeline.HOST_CPU_KEYS, 0.0),
                    "extract_tasks": 0, "extract_nodes": 0,
                    "extract_native_docs": 0, "pack_tasks": 0}


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
    ref = {}
    ref_pipeline.seed_stage(ref)
    assert stage == {**ref, **dict.fromkeys(pipeline.HOST_CPU_KEYS, 0.0),
                     "extract_tasks": 0, "extract_nodes": 0,
                     "extract_native_docs": 0, "pack_tasks": 0}
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


def _short_fuzz_doc(**spec):
    """One short fuzz log (4 rounds, about 30 ops), so the chunk's op-row
    bucket stays small."""
    [doc] = port_docs(twinned(lambda gen: [fuzz_doc(
        gen, "fz-short", gen.fuzz.StringFuzzSpec(**spec), seed=900,
        n_clients=3, rounds=4)]))
    return doc


def _sliced_corpus(n_docs, k):
    """``n_docs`` short documents with the special ones (annotating, warm,
    a pack-time fallback, a forced overflow, an attribution and an
    interval document) on both sides of every boundary of ``k`` slices.
    The long fixture logs stay out: they would widen every row."""
    attributed = port_docs(bench_docs(1, 24))[0]
    attributed.attribution = True
    fallback = _short_fuzz_doc(intervals=True, obliterate=True)
    assert mt.known_oracle_fallback(fallback)
    special = [d for d in port_docs(hard_docs()) if len(d.ops) < 40] + [
        fallback, workload.overflow_doc(), attributed,
        _short_fuzz_doc(intervals=True)]
    docs = port_docs(bench_docs(n_docs, 12))
    cuts = [n_docs * j // k for j in range(k + 1)]
    at = sorted({0, n_docs - 1, n_docs // 2, n_docs // 2 + 1}
                | {c for lo in cuts[1:-1] for c in (lo - 1, lo)})
    for i, pos in enumerate(at):
        docs[pos] = special[i % len(special)]
    free = (pos for pos in range(2, n_docs, 5) if pos not in at)
    for pos, doc in zip(free, special[len(at):]):
        docs[pos] = doc
    return docs


@pytest.mark.parametrize("n_docs, k", [(64, 1), (128, 2), (192, 3),
                                       (448, 7)])
def test_document_slices_extract_the_unsliced_bytes(monkeypatch, n_docs, k):
    """A chunk extracted as ``k`` document slices on the pools' workers
    gives every summary of the unsliced extraction, in the caller's order,
    with the same ``device_docs`` / ``fallback_docs``; each Python branch
    of ``summaries_from_export`` sits on a slice boundary.  The family
    lets known fallbacks into the chunk, so ``needs_fallback`` is read
    after the fold."""
    import dataclasses

    docs = _sliced_corpus(n_docs, k)
    family = dataclasses.replace(pipeline.MERGETREE_FAMILY,
                                 known_fallback=lambda doc: False)

    def run():
        stage, stats = {}, {}
        got = pipeline.pipelined_family_replay(
            family, docs, chunk_docs=n_docs, stage=stage, stats=stats,
            device="cpu")
        return [s.digest() for s in got], stage["extract_tasks"], stats

    sliced, tasks, stats = run()
    monkeypatch.setattr(pipeline, "MIN_SLICE_DOCS", n_docs + 1)
    whole, whole_tasks, whole_stats = run()
    assert (tasks, whole_tasks) == (k, 1)
    assert sliced == whole
    assert stats == whole_stats
    assert stats["fallback_docs"] >= 2 and stats["device_docs"] > 0
    assert sliced == [s.digest() for s in mt.replay_mergetree_batch(
        docs, device="cpu")]


@pytest.mark.parametrize("chunk_docs, fetch_depth, tasks", [
    (112, 2, [1] * 8),   # chunks under 128 documents: one task each
    (448, 0, [3, 7]),    # extract_threads while a pack remains, then all
    (448, 2, [7, 7]),    # every chunk packed before the first fetch
], ids=["small-chunks", "packs-remain", "all-packed"])
def test_extract_tasks_follow_the_chunk_and_the_free_workers(
        chunk_docs, fetch_depth, tasks):
    """``stage["extract_tasks"]`` and the slices each chunk was cut into:
    a chunk of fewer than two slices' documents is one task; while chunks
    remain to be packed a chunk takes the extract pool's 3 workers, once
    every chunk is packed the pack pool's 4 as well.  The summaries are
    the one-batch entry's."""
    import collections
    import dataclasses
    import threading

    docs = port_docs(bench_docs(896, 8))
    arenas, lock = collections.Counter(), threading.Lock()

    def extract(meta, arr, st):
        with lock:
            arenas[id(meta["arena"])] += 1
        return pipeline.MERGETREE_FAMILY.extract(meta, arr, st)

    family = dataclasses.replace(pipeline.MERGETREE_FAMILY, extract=extract)
    stage, packed = {}, []
    got = pipeline.pipelined_family_replay(
        family, docs, chunk_docs=chunk_docs, fetch_depth=fetch_depth,
        stage=stage, packed_out=packed, device="cpu")
    assert [arenas[id(meta["arena"])] for _s, _o, meta, _t in packed] == \
        tasks
    assert stage["extract_tasks"] == sum(tasks)
    # binary chunks of two slices' documents or more pack in ranges, one
    # task each, as many as both pools have workers
    assert stage["pack_tasks"] == sum(
        max(1, min(7, len(meta["docs"]) // 64)) for _s, _o, meta, _t in packed)
    assert [s.digest() for s in got] == \
        [s.digest() for s in mt.replay_mergetree_batch(docs, device="cpu")]


def test_arena_finalizers_take_turns_and_keep_every_append():
    """A chunk's extract slices finalize its arena at once, while a suffix
    extension of the cached chunk may append to the same arena: under a
    short switch interval, with more finalizing threads than cores, every
    appended text survives."""
    import sys
    import threading

    from fluidframework_tpu_torch.ops.interning import TextArena

    texts = [f"<{i}>" for i in range(4000)]
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _trial in range(5):
            arena, stop = TextArena(), threading.Event()

            def finalize():
                while not stop.is_set():
                    arena.finalize()

            finalizers = [threading.Thread(target=finalize)
                          for _ in range(16)]
            for thread in finalizers:
                thread.start()
            for text in texts:
                arena.append(text)
            stop.set()
            for thread in finalizers:
                thread.join(timeout=30)
                assert not thread.is_alive()
            assert arena.finalize() == "".join(texts)
    finally:
        sys.setswitchinterval(saved)
