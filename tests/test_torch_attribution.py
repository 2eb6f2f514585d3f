"""Attribution-enabled merge-tree documents on the port: the summary's
"attribution" blob of pre-clamp insert seqs, per author run, through
``replay_mergetree_batch``, ``pipelined_mergetree_replay`` (tiers on and
off, a grown window served by tier 0) and ``oracle_fallback_summary``,
each byte for byte against the JAX package's function and the oracle
(``SharedString`` with an ``Attributor``)."""

import dataclasses
import json

import pytest

import bench
from fluidframework_tpu.dds.merge_tree import MergeTreeOracle
from fluidframework_tpu.dds.sequence import SharedString
from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.ops.mergetree_kernel import MergeTreeDocInput
from fluidframework_tpu.protocol.messages import MessageType, SequencedMessage
from fluidframework_tpu.runtime.attributor import Attributor
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import pipeline
from tests.torch_corpora import overflow_doc, port_docs
from tests.torch_tiers import TierPair

#: how far each op's minimum sequence number trails it: older inserts
#: clamp to seq 0 in the body and keep their author in the key blob.
LAG = 16


def _msg(seq, client, contents, min_seq=0):
    return SequencedMessage(
        seq=seq, client_id=client, client_seq=seq, ref_seq=seq - 1,
        min_seq=min_seq, type=MessageType.OP, contents=contents)


def clamp_doc():
    """Two authors' adjacent inserts clamped under the window and merged
    into one record (tests/test_attribution.py's direct parity case)."""
    ops = [
        _msg(1, "alice", {"kind": "insert", "pos": 0, "text": "foo"}),
        _msg(2, "bob", {"kind": "insert", "pos": 3, "text": "bar"}),
        _msg(3, "alice", {"kind": "insert", "pos": 6, "text": "."}, 2),
        _msg(4, "bob", {"kind": "insert", "pos": 7, "text": "!"}, 3),
    ]
    return MergeTreeDocInput(doc_id="clamp", ops=ops, final_seq=4,
                             final_msn=3, attribution=True)


def fallback_doc():
    """Interval ops mixed with an obliterate: a known oracle fallback."""
    ops = [
        _msg(1, "alice", {"kind": "insert", "pos": 0, "text": "abcdef"}),
        _msg(2, "bob", {"kind": "obliterate", "start": 4, "end": 6}),
        _msg(3, "alice", {"kind": "intervalAdd", "label": "c", "id": "iv0",
                          "start": 0, "end": 2, "props": {}}, 2),
        _msg(4, "bob", {"kind": "insert", "pos": 2, "text": "zz"}, 3),
    ]
    return MergeTreeDocInput(doc_id="fb", ops=ops, final_seq=4, final_msn=3,
                             attribution=True)


def stream(i, n_ops):
    """The pinned stream of document ``i`` with a trailing window."""
    return [dataclasses.replace(m, min_seq=max(0, m.seq - LAG))
            for m in bench.doc_ops(bench.synth_doc(i, n_ops))]


def window_doc(i, n_ops, stream_ops=None, attribution=True):
    msgs = stream(i, stream_ops or n_ops)[:n_ops]
    return MergeTreeDocInput(
        doc_id=f"a{i}", ops=msgs, final_seq=msgs[-1].seq,
        final_msn=msgs[-1].min_seq, attribution=attribution,
        cache_token=("ep", f"a{i}", 0, ""))


def keyed_base_doc(i=3, n_ops=48):
    """A warm document whose base summary carries a key blob: the base
    records are split back per author (as the service's warm pack does)
    and the tail folds on top."""
    msgs = stream(i, n_ops)
    half = n_ops // 2
    base = SharedString("base")
    base._attributor = Attributor()
    for m in msgs[:half]:
        base.process(m, local=False)
    summary = base.summarize()
    assert "attribution" in summary.children
    records = json.loads(summary.blob_bytes("body"))
    MergeTreeOracle.split_records_by_attribution_keys(
        records, json.loads(summary.blob_bytes("attribution")))
    return MergeTreeDocInput(
        doc_id="keyed", ops=msgs[half:], base_records=records,
        base_seq=base.tree.current_seq, base_msn=base.tree.min_seq,
        final_seq=msgs[-1].seq, final_msn=msgs[-1].min_seq,
        attribution=True)


CORPORA = {
    "clamp": lambda: [clamp_doc()],
    "windows": lambda: [window_doc(i, 40) for i in range(6)],
    "keyed-base": lambda: [keyed_base_doc()],
    "fallback": lambda: [fallback_doc()],
    "mixed-chunk": lambda: [clamp_doc(), window_doc(0, 32),
                            fallback_doc(), overflow_doc(),
                            window_doc(1, 24, attribution=False),
                            dataclasses.replace(overflow_doc(),
                                                doc_id="ov-attr",
                                                attribution=True),
                            keyed_base_doc()],
}


def _oracle(doc):
    """The JAX package's oracle replay, with an attributor when the
    document is attribution-enabled."""
    return ref_mt.oracle_fallback_summary(doc)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_replay_batch_matches_jax_and_oracle(corpus):
    docs = CORPORA[corpus]()
    r_stats, p_stats = {}, {}
    ref = ref_mt.replay_mergetree_batch(docs, stats=r_stats)
    got = mt.replay_mergetree_batch(port_docs(docs), stats=p_stats,
                                    device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in ref]
    assert [s.digest() for s in got] == [_oracle(d).digest() for d in docs]
    assert p_stats == r_stats
    for doc, summary in zip(docs, got):
        if doc.attribution and doc.doc_id != "ov-attr":
            assert ("attribution" in summary.children) == \
                ("attribution" in _oracle(doc).children)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_oracle_fallback_summary_matches_jax(corpus):
    for doc in CORPORA[corpus]():
        got = mt.oracle_fallback_summary(port_docs([doc])[0])
        assert got.digest() == _oracle(doc).digest(), doc.doc_id


def test_clamped_author_runs_emit_their_keys():
    """The clamp merges foo (alice), bar (bob) and alice's "." into one
    record; the key blob splits it back per run, as the oracle's."""
    [got] = mt.replay_mergetree_batch(port_docs([clamp_doc()]), device="cpu")
    body = json.loads(got.blob_bytes("body"))
    assert body[0]["t"].startswith("foobar") and body[0]["s"] == 0
    assert json.loads(got.blob_bytes("attribution")) == \
        [[0, [[3, 1], [3, 2], [1, 3]]]]
    assert got.blob_bytes("attribution") == \
        _oracle(clamp_doc()).blob_bytes("attribution")


def test_fallback_doc_keeps_its_keys_blob():
    """tests/test_attribution.py::
    test_catchup_device_attribution_fallback_doc_keeps_keys on the port."""
    summary = mt.oracle_fallback_summary(port_docs([fallback_doc()])[0])
    assert "attribution" in summary.children


def test_body_skip_leaves_fallback_stats_alone():
    """Attribution documents skip the C++ body pass without counting as
    fallbacks: a mixed chunk's stats equal those of the same chunk with
    every attribution flag off."""
    docs = CORPORA["mixed-chunk"]()
    plain = [dataclasses.replace(d, attribution=False) for d in docs]
    with_attr, without = {}, {}
    mt.replay_mergetree_batch(port_docs(docs), stats=with_attr, device="cpu")
    mt.replay_mergetree_batch(port_docs(plain), stats=without, device="cpu")
    assert with_attr == without
    assert with_attr["fallback_docs"] == 3  # fb, and both overflow docs


def test_python_extraction_matches_native_bodies_with_attribution():
    """Without liboppack the bodies come from Python for every document;
    attribution documents take that path either way."""
    from fluidframework_tpu_torch.ops import native_pack

    docs = CORPORA["mixed-chunk"]()
    native = mt.replay_mergetree_batch(port_docs(docs), device="cpu")
    saved = native_pack.extract_bodies
    native_pack.extract_bodies = lambda *a, **k: None
    try:
        python = mt.replay_mergetree_batch(port_docs(docs), device="cpu")
    finally:
        native_pack.extract_bodies = saved
    assert [s.digest() for s in python] == [s.digest() for s in native]


@pytest.mark.parametrize("tiers", ["on", "off"])
def test_pipeline_serves_attribution_windows(tiers):
    """Cold 26-op windows, then every 4th grown to 32 ops along the same
    stream: the pipeline with every tier on (the unchanged documents
    served by tier 0, the grown ones spliced) or off equals the JAX
    package's pipeline with the same tiers, and the oracle."""
    on = tiers == "on"
    pair = TierPair(pack=on, delta=on, device=on)
    cold = [window_doc(i, 26, 32) for i in range(12)] + [clamp_doc()]
    grown = [window_doc(i, 32 if i % 4 == 0 else 26, 32)
             for i in range(12)] + [clamp_doc()]
    for docs in (cold, grown):
        digests, _stage, stats = pair.run(docs, chunk_docs=8)
        assert digests == [_oracle(d).digest() for d in docs]
    if on:
        assert stats["delta_docs"] == 9
        assert pair.port["delta_cache"].stats()["served"] == 9
        assert pair.port["device_cache"].stats()["spliced"] > 0


def test_tier0_anchor_separates_attribution():
    """Tier 0 keys its served summaries by the attribution flag too: the
    same window re-folded with attribution on re-extracts (it needs the
    key blob) instead of serving the plain summary."""
    pair = TierPair(pack=True, delta=True, device=True)
    plain = [window_doc(i, 26, attribution=False) for i in range(4)]
    keyed = [window_doc(i, 26) for i in range(4)]
    pair.run(plain, chunk_docs=4)
    digests, _stage, stats = pair.run(keyed, chunk_docs=4)
    assert stats.get("delta_docs", 0) == 0
    assert digests == [_oracle(d).digest() for d in keyed]


def test_pipeline_entry_matches_one_batch():
    docs = CORPORA["mixed-chunk"]()
    got = pipeline.pipelined_mergetree_replay(port_docs(docs), chunk_docs=3,
                                              device="cpu")
    one = mt.replay_mergetree_batch(port_docs(docs), device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in one]
