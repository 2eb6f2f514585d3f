"""SharedMatrix on the generic catch-up pipeline: ``pipelined_matrix_replay
(device="cpu")`` against ``replay_matrix_batch`` and the ``dds/matrix.py``
oracle, byte for byte, for documents carrying records, messages or both,
over one chunk and several, sliced packs, pre-pack and post-fold
fallbacks (the fixture's two overlap removers and its third remover, an
overflowed axis); its counters; a violated fact raising; and the
one-device service's matrix route, which calls it and returns what the
one-shot call returned."""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import matrix_kernel as mk
from fluidframework_tpu_torch.ops import matrix_native as mn
from fluidframework_tpu_torch.ops import matrix_pipeline as mp
from fluidframework_tpu_torch.ops.pipeline import seed_stage
from fluidframework_tpu_torch.testing import config_workloads as cw

torch.set_num_threads(1)


def _records(docs):
    return [dataclasses.replace(d, ops=[],
                                records=mn.encode_matrix_ops(d.ops))
            if d.base_summary is None else d for d in docs]


def _oracle(docs):
    return [mk.oracle_matrix_fallback(d).digest() for d in docs]


def _digests(trees):
    return [t.digest() for t in trees]


def _fixture():
    return cw.hard_matrix_docs() + [cw.crafted_matrix_doc(c)
                                    for c in cw.CRAFTED_MATRIX]


POOLS = {
    "workload": lambda: [cw.gen_matrix_doc(i, 120) for i in range(20)],
    "fixture": _fixture,
    "mixed": lambda: _fixture() + [cw.gen_matrix_doc(i, 90)
                                   for i in range(7)],
}


@pytest.mark.parametrize("form", ["records", "messages", "half"])
@pytest.mark.parametrize("chunk_docs", [1024, 6])
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pipeline_equals_one_shot_and_oracle(pool, chunk_docs, form):
    docs = POOLS[pool]()
    want = _oracle(docs)
    r_stats = {}
    assert _digests(mk.replay_matrix_batch(docs, stats=r_stats,
                                           device="cpu")) == want
    inputs = {"messages": docs, "records": _records(docs),
              "half": [r if i % 2 else d for i, (d, r) in
                       enumerate(zip(docs, _records(docs)))]}[form]
    stats, stage = {}, {}
    got = mp.pipelined_matrix_replay(inputs, chunk_docs=chunk_docs,
                                     stats=stats, stage=stage, device="cpu")
    assert _digests(got) == want
    native = stats.pop("native_pack_docs", 0)
    assert stats == r_stats
    assert stage["pack_tasks"] > 0 and stage["extract_tasks"] > 0
    assert stage["resolve_rows"] > 0 and stage["extract_cells"] > 0
    if form == "messages":
        assert native == 0 and stage["extract_native_docs"] == 0
    if form == "records" and pool == "workload":
        assert native == stage["extract_native_docs"] == len(docs)


def test_fixture_routes_by_reason_as_the_one_shot_call():
    """Per-reason counts equal the one-shot call's; a chunk that holds a
    base summary packs in Python (no native count), one of records alone
    natively."""
    fixture = _fixture()
    ref = {}
    mk.replay_matrix_batch(fixture, stats=ref, device="cpu")
    for chunk_docs, native in ((1024, 0), (4, 4)):
        stats = {}
        mp.pipelined_matrix_replay(_records(fixture), chunk_docs=chunk_docs,
                                   stats=stats, device="cpu")
        assert stats.pop("native_pack_docs", 0) >= native
        assert stats == ref and ref["fallback_docs"] == 2


@pytest.mark.parametrize("n_docs", [130, 200])
def test_sliced_native_pack_in_the_pipeline(n_docs):
    """A chunk of 128 documents or more packs as ranges on both pools;
    the cells, resolve rows and native counts cover every document."""
    docs = [cw.gen_matrix_doc(i, 40) for i in range(n_docs)]
    stats, stage = {}, {}
    got = mp.pipelined_matrix_replay(_records(docs), stats=stats,
                                     stage=stage, device="cpu")
    assert _digests(got) == _oracle(docs)
    assert stage["pack_tasks"] == min(7, n_docs // 64)
    assert stats == {"native_pack_docs": n_docs, "device_docs": n_docs}
    assert stage["extract_native_docs"] == n_docs
    _s, ops, _m = mk.pack_matrix_batch(docs)
    assert stage["resolve_rows"] == int((ops.kind == mk.K_RESOLVE).sum())
    assert stage["extract_cells"] == sum(
        len(json.loads(t.blob_bytes("body"))["cells"]) for t in got)


def test_overflowed_axis_takes_the_oracle_through_the_python_route():
    docs = [cw.gen_matrix_doc(i, 60) for i in range(5)]
    recs = _records(docs)
    real = mp.MATRIX_FAMILY.dispatch

    def overflow_doc_two(state, ops, meta, digest, aux):
        out = list(real(state, ops, meta, digest, aux))
        at = mp.EXPORT_FIELDS.index("overflow")
        out[at] = out[at].clone()
        out[at][2, 0] = True
        return tuple(out)

    family = dataclasses.replace(mp.MATRIX_FAMILY, dispatch=overflow_doc_two)
    stats, stage = {}, {}
    seed_stage(stage)
    from fluidframework_tpu_torch.ops.pipeline import pipelined_family_replay
    got = pipelined_family_replay(family, recs, stats=stats, stage=stage,
                                  device="cpu")
    assert _digests(got) == _oracle(docs)
    assert stats["fallback_docs"] == 1 and stats["device_docs"] == 4
    assert stage["extract_native_docs"] == 4


def test_a_violated_fact_raises():
    docs = [cw.gen_matrix_doc(i, 40) for i in range(3)]
    real = mp.MATRIX_FAMILY.pack

    def obliterating(chunk):
        state, ops, meta = real(chunk)
        kind = np.where(ops.kind == mk.K_REMOVE, 4, ops.kind)
        return state, ops._replace(kind=kind), meta

    family = dataclasses.replace(mp.MATRIX_FAMILY, pack=obliterating)
    from fluidframework_tpu_torch.ops.pipeline import pipelined_family_replay
    with pytest.raises(ValueError, match="facts"):
        pipelined_family_replay(family, docs, device="cpu")


def test_string_and_tree_stage_schema_keeps_no_matrix_count():
    stage = {}
    seed_stage(stage)
    assert "extract_cells" not in stage and "resolve_rows" not in stage


def _mixed_service(n_docs=4):
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.testing import service_workload as sw

    service = LocalOrderingService()
    sw.build_mixed_corpus(service, n_docs, random.Random("matrix-route"))
    return service


def test_service_matrix_route_calls_the_pipeline_and_answers_as_before(
        monkeypatch):
    from fluidframework_tpu_torch.service.catchup import CatchupService

    service = _mixed_service()
    calls = []
    real = mp.pipelined_matrix_replay

    def spy(docs, **kwargs):
        calls.append((len(docs), sorted(kwargs)))
        return real(docs, **kwargs)

    monkeypatch.setattr(mp, "pipelined_matrix_replay", spy)
    now_stats = {}
    now = CatchupService(service, device="cpu").catch_up(
        stats=now_stats, upload=False)
    assert calls == [(4, ["device", "stats"])]

    def one_shot(docs, stats=None, device="cuda"):
        return mk.replay_matrix_batch(docs, stats=stats, device=device)

    monkeypatch.setattr(mp, "pipelined_matrix_replay", one_shot)
    before_stats = {}
    before = CatchupService(service, device="cpu").catch_up(
        stats=before_stats, upload=False)
    assert now == before and now_stats == before_stats
