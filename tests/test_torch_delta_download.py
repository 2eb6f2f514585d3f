"""Tier 0 of the catch-up cache in the port: the digest-gated delta
download (``DeltaExportCache``, ``delta_route`` and its helpers,
``gather_export_rows``), held against the JAX package's on the CPU.

Every call of every sequence runs through both pipelines with matching
tiers (tests/torch_tiers.py): equal summary bytes, ``delta_docs``,
``h2d_bytes`` / ``d2h_bytes`` and ``stats()`` of every tier."""

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.service.catchup_cache import (
    tree_nbytes as ref_tree_nbytes)
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.ops.interning import next_bucket_fine
from fluidframework_tpu_torch.ops.pipeline import pipelined_mergetree_replay
from fluidframework_tpu_torch.service.catchup_cache import (
    DeltaExportCache, tree_nbytes)
from tests.torch_corpora import port_docs
from tests.torch_tiers import TierPair, corpus, streams


@pytest.fixture(autouse=True)
def _xla_fold(monkeypatch):
    monkeypatch.delenv("FF_PALLAS_FOLD", raising=False)
    monkeypatch.delenv("FF_UPLOAD_NARROW", raising=False)


#: 10 streams of 32 ops; 26 -> 32 stays inside the T = 32 / S = 64 buckets
SEQUENCES = {
    "cold-exact": [dict(lo=26), dict(lo=26)],
    "grown-in-bucket": [dict(lo=26), dict(lo=26, hi=32, grown={0, 5})],
    "grown-all": [dict(lo=26), dict(lo=26, hi=32, grown=set(range(10)))],
    "bucket-crossing": [dict(lo=12), dict(lo=12, hi=32, grown={3})],
}


@pytest.mark.parametrize("with_pack", [True, False],
                         ids=["pack-cache", "no-pack-cache"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_delta_sequence_matches_reference(name, with_pack):
    s = streams(10, 32)
    pair = TierPair(pack=with_pack, delta=True)
    for call in SEQUENCES[name]:
        docs = corpus(s, **call)
        got, _stage, _stats = pair.run(docs)
    assert got == [x.digest() for x in ref_mt.replay_mergetree_batch(docs)]


def test_exact_rerun_downloads_only_the_digest_plane():
    s = streams(10, 32)
    pair = TierPair(pack=True, delta=True)
    docs = corpus(s, lo=26)
    _got, cold, _ = pair.run(docs)
    _got, warm, stats = pair.run(docs)
    assert cold["d2h_bytes"] > 8 * len(docs)
    assert warm["d2h_bytes"] == 8 * len(docs)
    assert stats["delta_docs"] == len(docs)
    assert warm["extract"] == 0.0


def test_grown_run_gathers_only_changed_rows():
    s = streams(10, 32)
    pair = TierPair(pack=True, delta=True)
    _got, cold, _ = pair.run(corpus(s, lo=26))
    _got, warm, stats = pair.run(corpus(s, lo=26, hi=32, grown={0, 5}))
    assert stats["delta_docs"] == 8
    assert 8 * 10 < warm["d2h_bytes"] < cold["d2h_bytes"]
    assert pair.port["delta_cache"].stats()["bytes_saved"] > 0


def test_forced_digest_mismatch_falls_back_to_the_download():
    """A poisoned digest in both caches: that document downloads again
    (counted ``changed``), bytes unchanged, and the next run serves it."""
    s = streams(9, 32)
    pair = TierPair(pack=True, delta=True)
    docs = corpus(s, lo=26)
    pair.run(docs)
    for side in (pair.ref, pair.port):
        cache = side["delta_cache"]
        with cache._lock:
            token = docs[3].cache_token
            cache._entries[token] = cache._entries[token]._replace(
                digest=(1, 2))
    _got, _stage, stats = pair.run(docs)
    assert stats["delta_docs"] == len(docs) - 1
    assert pair.port["delta_cache"].stats()["changed"] == 1
    _got, _stage, stats = pair.run(docs)
    assert stats["delta_docs"] == len(docs)


def test_epoch_bump_invalidates_tier_zero():
    s = streams(6, 32)
    pair = TierPair(pack=True, delta=True)
    pair.run(corpus(s, lo=26, epoch="e1"))
    for side in (pair.ref, pair.port):
        assert side["delta_cache"].invalidate_epoch("e2") == 6
        assert side["delta_cache"].invalidate_epoch("e2") == 0
    _got, _stage, stats = pair.run(corpus(s, lo=26, epoch="e2"))
    assert "delta_docs" not in stats
    _got, _stage, stats = pair.run(corpus(s, lo=26, epoch="e2"))
    assert stats["delta_docs"] == 6


def test_byte_bound_evicts_like_the_reference():
    s = streams(8, 32)
    pair = TierPair(pack=True, delta=True, delta_kw={"max_bytes": 4000})
    pair.run(corpus(s, lo=26))
    pair.run(corpus(s, lo=26))
    st = pair.port["delta_cache"].stats()
    assert st["evictions"] > 0 and st["bytes"] <= 4000


def test_tree_nbytes_matches_the_reference():
    s = streams(4, 32)
    docs = corpus(s, lo=26)
    ref = ref_mt.replay_mergetree_batch(docs)
    pair = TierPair(pack=False, delta=True)
    pair.run(docs)
    port_trees = [e.tree for e in pair.port["delta_cache"]._entries.values()]
    assert [tree_nbytes(t) for t in port_trees] == \
        [ref_tree_nbytes(t) for t in ref]


#: export leaves at the shapes the pipeline downloads: int32, int16, and
#: the i8 layout's (rows, misc) pair
LEAVES = {
    "int32": lambda rng: rng.integers(-9, 9, (24, 5, 16), np.int32),
    "int16": lambda rng: rng.integers(-9, 9, (24, 4, 32), np.int16),
    "i8-pair": lambda rng: (rng.integers(-9, 9, (24, 3, 16), np.int16),
                            rng.integers(0, 9, (24, 4), np.int32)),
}


def _as(fn, leaf):
    return tuple(fn(x) for x in leaf) if isinstance(leaf, tuple) \
        else fn(leaf)


@pytest.mark.parametrize("idx", [[3], [0, 5, 9], list(range(0, 24, 2)),
                                 list(range(20))],
                         ids=["one", "three", "twelve", "twenty"])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
@pytest.mark.parametrize("where", ["host", "device"])
def test_gather_export_rows_byte_rule_matches_reference(monkeypatch, where,
                                                        leaf, idx):
    """Host-readable buffers copy exactly the requested rows; device
    buffers (the host view turned off on both sides) gather a
    fine-bucketed, padded index — or fetch the whole buffer once the
    bucket reaches it — and count what crossed.  Rows and counts equal
    the reference's."""
    import jax.numpy as jnp

    data = LEAVES[leaf](np.random.default_rng(len(idx)))
    rows = np.asarray(idx, np.int32)
    fetched = []
    if where == "device":
        monkeypatch.setattr(ref_mt, "_host_view", lambda a: None)
        monkeypatch.setattr(mt, "_host_view", lambda a: None)

        def fetch(xs):
            fetched.append([tuple(x.shape) for x in xs])
            return [x.numpy() for x in xs]
    else:
        fetch = None
    want, want_moved = ref_mt.gather_export_rows(_as(jnp.asarray, data),
                                                 rows)
    got, moved = mt.gather_export_rows(_as(torch.from_numpy, data), rows,
                                       fetch=fetch)
    assert moved == want_moved
    for w, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    if where == "device":
        bucket = next_bucket_fine(len(idx), floor=8)
        lead = 24 if bucket >= 24 else bucket
        assert fetched and all(shape[0] == lead for shape in fetched[0])


@pytest.mark.parametrize("n_docs, k", [(192, 3), (448, 7)])
def test_full_route_publishes_per_slice_the_unsliced_entries(monkeypatch,
                                                             n_docs, k):
    """Tier 0's cold fill with a chunk extracted as ``k`` document
    slices: each slice publishes its own documents, and the entries (and
    the tier's counters) equal the unsliced extraction's; the exact rerun
    serves every document from them."""
    docs = port_docs(corpus(streams(n_docs, 16), lo=12))

    def run():
        cache, stage, warm = DeltaExportCache(), {}, {}
        cold = pipelined_mergetree_replay(docs, chunk_docs=n_docs,
                                          delta_cache=cache, stage=stage,
                                          device="cpu")
        entries = {token: (e.anchor, e.digest, e.tree.digest(), e.nbytes)
                   for token, e in cache._entries.items()}
        served = pipelined_mergetree_replay(docs, chunk_docs=n_docs,
                                            delta_cache=cache, stats=warm,
                                            device="cpu")
        assert warm["delta_docs"] == n_docs
        assert [s.digest() for s in served] == [s.digest() for s in cold]
        return ([s.digest() for s in cold], stage["extract_tasks"],
                entries, cache.stats())

    sliced, tasks, entries, stats = run()
    monkeypatch.setattr(pipeline, "MIN_SLICE_DOCS", n_docs + 1)
    whole, whole_tasks, whole_entries, whole_stats = run()
    assert (tasks, whole_tasks) == (k, 1)
    assert sliced == whole == [
        s.digest() for s in mt.replay_mergetree_batch(docs, device="cpu")]
    assert len(entries) == n_docs
    assert entries == whole_entries
    assert stats == whole_stats
