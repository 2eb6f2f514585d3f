"""Tier 2 of the catch-up cache in the port: ``PackCache`` and the
merge-tree suffix extension, held against the JAX package's on the CPU.

Every call of every sequence runs through the reference's pipeline and the
port's on the same documents, each with its own pack cache: summaries,
``h2d_bytes`` / ``d2h_bytes`` and the caches' ``stats()`` must be equal
(tests/torch_tiers.py).  Sizes are small; equality is exact."""

import dataclasses

import numpy as np
import pytest

import bench
from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.ops import pipeline as ref_pipeline
from fluidframework_tpu_torch.ops import pipeline
from tests.torch_corpora import port_docs
from tests.torch_tiers import TierPair, corpus, streams, window


@pytest.fixture(autouse=True)
def _xla_fold(monkeypatch):
    monkeypatch.delenv("FF_PALLAS_FOLD", raising=False)
    monkeypatch.delenv("FF_UPLOAD_NARROW", raising=False)


#: the call sequences: (name, windows per call) over 12 streams of 32 ops;
#: 26 -> 32 ops stays inside the T = 32 / S = 64 buckets (suffix hits),
#: 12 -> 32 crosses them (a repack)
SEQUENCES = {
    "cold-exact": [dict(lo=26), dict(lo=26)],
    "grown-in-bucket": [dict(lo=26), dict(lo=26, hi=32, grown={0, 5, 9})],
    "grown-twice": [dict(lo=26), dict(lo=26, hi=29, grown={1, 2}),
                    dict(lo=26, hi=32, grown={1, 2, 3})],
    "bucket-crossing": [dict(lo=12), dict(lo=12, hi=32, grown={4})],
    "shrunk-window": [dict(lo=26), dict(lo=20)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_pack_cache_sequence_matches_reference(name):
    s = streams(12, 32)
    pair = TierPair(pack=True)
    for call in SEQUENCES[name]:
        docs = corpus(s, **call)
        got, stage, _stats = pair.run(docs)
        assert stage["h2d_bytes"] > 0 and stage["d2h_bytes"] > 0
    want = [s_.digest() for s_ in ref_mt.replay_mergetree_batch(docs)]
    assert got == want


def test_suffix_and_exact_hits_are_counted_per_chunk():
    """Two chunks: cold (2 misses), exact (2 hits), then one document of
    the first chunk grows (a suffix hit) and the second stays (a hit)."""
    s = streams(12, 32)
    pair = TierPair(pack=True)
    pair.run(corpus(s, lo=26))
    pair.run(corpus(s, lo=26))
    pair.run(corpus(s, lo=26, hi=32, grown={3}))
    st = pair.port["pack_cache"].stats()
    assert (st["misses"], st["exact_hits"], st["suffix_hits"]) == (2, 3, 1)


def _lineages(pair, docs, chunk_docs=8):
    """The ``_pack_lineage`` stamps of each chunk, reference and port."""
    ref_out, port_out = [], []
    ref_pipeline.pipelined_mergetree_replay(
        docs, chunk_docs=chunk_docs, packed_out=ref_out, **pair.ref)
    pipeline.pipelined_mergetree_replay(
        port_docs(docs), chunk_docs=chunk_docs, packed_out=port_out,
        device="cpu", **pair.port)
    return ([m["_pack_lineage"] for _s, _o, m, _t in ref_out],
            [m["_pack_lineage"] for _s, _o, m, _t in port_out])


def test_pack_lineage_stamps_match_the_reference():
    """The stamps tier 2.5 reads: the same kind per chunk and the same
    parent structure (a suffix names the generation the chunk held)."""
    s = streams(12, 32)
    pair = TierPair(pack=True)
    rounds = [_lineages(pair, corpus(s, lo=26)),
              _lineages(pair, corpus(s, lo=26)),
              _lineages(pair, corpus(s, lo=26, hi=32, grown={2}))]
    for ref, port in rounds:
        assert [x[0] for x in port] == [x[0] for x in ref]
        assert [len(x) for x in port] == [len(x) for x in ref]
    (_r0, p0), (_r1, p1), (_r2, p2) = rounds
    assert [x[0] for x in p0] == ["full", "full"]
    assert [x[0] for x in p1] == ["exact", "exact"]
    assert p1[0][1] == p0[0][1]          # exact names the stored gen
    assert p2[0] == ("suffix", p0[0][1], p2[0][2])
    assert p2[1][0] == "exact"


def test_suffix_extension_equals_the_reference_arrays():
    """``_extend_mergetree`` on the port's cached entry produces the same
    arrays and layout facts as the reference's on its own."""
    s = streams(8, 32)
    ref_cache, port_cache = ref_pipeline.PackCache(), pipeline.PackCache()
    cold = corpus(s, lo=26)
    ref_cache.pack(cold)
    port_cache.pack(port_docs(cold))
    grown = corpus(s, lo=26, hi=32, grown={0, 6})
    r_state, r_ops, r_meta = ref_cache.pack(grown)
    p_state, p_ops, p_meta = port_cache.pack(port_docs(grown))
    assert r_meta["_pack_lineage"][0] == p_meta["_pack_lineage"][0] == \
        "suffix"
    for f in p_ops._fields:
        np.testing.assert_array_equal(getattr(p_ops, f),
                                      getattr(r_ops, f), err_msg=f)
    for f in p_state._fields:
        np.testing.assert_array_equal(getattr(p_state, f),
                                      getattr(r_state, f), err_msg=f)
    for key in ("i16_ok", "i8_ok", "sequential", "ob_rows", "ov_rows",
                "has_props", "prop_keys", "_S", "props_K"):
        assert p_meta[key] == r_meta[key], key
    assert p_meta["arena"].finalize() == r_meta["arena"].finalize()


def test_tokenless_and_binary_documents_bypass():
    """Binary streams (bench.synth_doc) and token-less message documents
    never enter the cache, and both pipelines count them alike."""
    pair = TierPair(pack=True)
    binary = [bench.synth_doc(i, 16) for i in range(4)]
    pair.run(binary, chunk_docs=4)
    tokened_binary = [dataclasses.replace(d, cache_token=("ep", d.doc_id))
                      for d in binary]
    pair.run(tokened_binary, chunk_docs=4)
    s = streams(4, 16)
    tokenless = [dataclasses.replace(window(s, i, 12), cache_token=None)
                 for i in range(4)]
    pair.run(tokenless, chunk_docs=4)
    st = pair.port["pack_cache"].stats()
    assert st["bypass"] == 3 and st["entries"] == 0


def test_byte_bound_evicts_like_the_reference():
    """A budget of about two chunks: the LRU evicts as the reference's
    does (same inserts, evictions, entries and bytes), and an entry
    larger than the whole budget is never admitted."""
    s = streams(8, 24)
    probe = pipeline.PackCache()
    probe.pack(port_docs(corpus(s, lo=20)[:2]))
    per_entry = probe.stats()["bytes"]
    pair = TierPair(pack=True, pack_kw={"max_bytes": 2 * per_entry + 8})
    pair.run(corpus(s, lo=20), chunk_docs=2)
    pair.run(corpus(s, lo=20), chunk_docs=2)
    st = pair.port["pack_cache"].stats()
    assert st["evictions"] >= 2 and st["bytes"] <= 2 * per_entry + 8
    tiny = TierPair(pack=True, pack_kw={"max_bytes": 16})
    tiny.run(corpus(s, lo=20)[:2], chunk_docs=2)
    assert tiny.port["pack_cache"].stats()["entries"] == 0


@pytest.mark.parametrize("case", ["exact", "suffix", "mismatch", "shrink",
                                  "reseq"])
def test_match_windows_matches_the_reference(case):
    s = streams(4, 16)
    cached = corpus(s, lo=10)
    n_ops = [len(d.ops) for d in cached]
    first = [d.ops[0].seq for d in cached]
    last = [d.ops[-1].seq for d in cached]
    docs = {
        "exact": cached,
        "suffix": corpus(s, lo=10, hi=14, grown={1}),
        "mismatch": [dataclasses.replace(cached[0], ops=s[0][1:11])]
        + cached[1:],
        "shrink": corpus(s, lo=10, hi=8, grown={2}),
        "reseq": [dataclasses.replace(
            cached[0], ops=list(s[0][:10]) + [s[0][9]])] + cached[1:],
    }[case]
    got = pipeline.match_windows(n_ops, first, last, port_docs(docs))
    assert got == ref_pipeline.match_windows(n_ops, first, last, docs)
