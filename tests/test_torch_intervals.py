"""BASELINE.json config #3 (SharedString with interval collections) in the
port against the JAX package, byte for byte: the workload generators,
the interval stabbing workload's five passes through the cache tiers, a
tail of interval ops alone, the pre-pack oracle route of a document that
mixes intervals with an obliterate, and the catch-up seam over interval
containers whose base summaries carry an ``intervals`` blob."""

import importlib.util

import pytest

import tools.bench_configs as ref_configs
import tools.bench_kernels as ref_kernels
from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.testing import config_workloads as cw
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import ROOT, fuzz_doc, port_docs, twinned
from tests.torch_service import ServicePair, reference_service
from tests.torch_tiers import TierPair

#: the stabbing workload at test size: 24 documents in chunks of 8, base
#: windows of 84 ops, every 8th grown to 96 (``run_interval_stabbing``'s
#: shape)
IV_DOCS, IV_OPS, GROW_EVERY, CHUNK = 24, 96, 8, 8


def _messages(doc):
    return [m.to_dict() for m in doc.ops]


@pytest.mark.parametrize("idx,n_ops", [(0, 96), (3, 96), (17, 48),
                                       (101, 24), (2047, 96)])
def test_gen_interval_doc_matches_the_reference(idx, n_ops):
    want = ref_configs.gen_interval_doc(idx, n_ops)
    got = cw.gen_interval_doc(idx, n_ops)
    assert (got.doc_id, got.final_seq, got.final_msn, got.cache_token) == \
        (want.doc_id, want.final_seq, want.final_msn, want.cache_token)
    assert _messages(got) == _messages(want)


@pytest.mark.parametrize("idx,n_ops,n_msgs", [(0, 96, None), (5, 96, 84),
                                              (8, 96, 96), (33, 48, 40),
                                              (10239, 96, 84)])
def test_synth_interval_doc_matches_the_reference(idx, n_ops, n_msgs):
    want = ref_kernels.synth_interval_doc(idx, n_ops, n_msgs=n_msgs)
    got = cw.synth_interval_doc(idx, n_ops, n_msgs=n_msgs)
    assert (got.doc_id, got.final_seq, got.final_msn, got.cache_token) == \
        (want.doc_id, want.final_seq, want.final_msn, want.cache_token)
    assert _messages(got) == _messages(want)


def _stabbing_windows(n_docs, grown_idx):
    """The reference's base and grown windows, each carrying the port's
    own build of it as ``port_twin``."""
    grow = IV_OPS // 8

    def both(i, n_msgs):
        ref = ref_kernels.synth_interval_doc(i, IV_OPS, n_msgs=n_msgs)
        ref.port_twin = cw.synth_interval_doc(i, IV_OPS, n_msgs=n_msgs)
        return ref

    base = [both(i, IV_OPS - grow) for i in range(n_docs)]
    grown = [both(i, IV_OPS) if i in grown_idx else base[i]
             for i in range(n_docs)]
    return base, grown


def test_stabbing_passes_equal_the_reference():
    """``run_interval_stabbing``'s five passes (cold, exact, grown, tiers
    off, post-invalidation) through both pipelines: equal summaries,
    ``h2d`` / ``d2h`` bytes, stats and tier counters at every pass, each
    pass equal to the one it is checked against, and the grown summaries
    equal to the oracle's."""
    grown_idx = set(range(0, IV_DOCS, GROW_EVERY))
    base, grown = _stabbing_windows(IV_DOCS, grown_idx)
    on = TierPair(pack=True, delta=True, device=True)
    off = TierPair(pack=False)
    cold, cold_stage, cold_stats = on.run(base, chunk_docs=CHUNK)
    exact, exact_stage, exact_stats = on.run(base, chunk_docs=CHUNK)
    got, grown_stage, grown_stats = on.run(grown, chunk_docs=CHUNK)
    plain, _stage, plain_stats = off.run(grown, chunk_docs=CHUNK)
    for side in (on.ref, on.port):
        side["delta_cache"].invalidate_epoch("other-epoch")
        side["device_cache"].invalidate_epoch("other-epoch")
    inval, inval_stage, _stats = on.run(grown, chunk_docs=CHUNK)
    assert exact == cold
    assert plain == got == inval
    assert cold_stats == plain_stats == {"device_docs": IV_DOCS,
                                         "fallback_docs": 0}
    assert (exact_stage["h2d_bytes"], exact_stage["d2h_bytes"]) == \
        (0, 8 * IV_DOCS)
    assert exact_stats == {"delta_docs": IV_DOCS}
    assert grown_stats == {"delta_docs": IV_DOCS - len(grown_idx),
                           "device_docs": len(grown_idx),
                           "fallback_docs": 0}
    assert 0 < grown_stage["h2d_bytes"] < cold_stage["h2d_bytes"]
    assert (inval_stage["h2d_bytes"], inval_stage["d2h_bytes"]) == \
        (cold_stage["h2d_bytes"], cold_stage["d2h_bytes"])
    assert on.port["device_cache"].stats()["spliced"] == IV_DOCS // CHUNK
    assert got == [workload.oracle_replay(d).summarize().digest()
                   for d in port_docs(grown)]


def test_a_tail_of_interval_ops_alone_is_served_exactly():
    """Grown windows whose new ops are all interval ops leave the text
    (and so the device state and its digest) unchanged, but not the
    ``intervals`` blob: with all three tiers on, tier 0 serves none of
    them, and every grown summary is the oracle's."""
    grow = IV_OPS // 8
    picked = [i for i in range(64) if all(
        m.contents["kind"].startswith("interval")
        for m in cw.synth_interval_doc(i, IV_OPS).ops[IV_OPS - grow:])]
    picked = picked[:CHUNK]
    assert len(picked) == CHUNK
    base, grown = [], []
    for i in picked:
        for out, n_msgs in ((base, IV_OPS - grow), (grown, IV_OPS)):
            ref = ref_kernels.synth_interval_doc(i, IV_OPS, n_msgs=n_msgs)
            ref.port_twin = cw.synth_interval_doc(i, IV_OPS, n_msgs=n_msgs)
            out.append(ref)
    pair = TierPair(pack=True, delta=True, device=True)
    before, _stage, _stats = pair.run(base, chunk_docs=CHUNK)
    after, _stage, stats = pair.run(grown, chunk_docs=CHUNK)
    assert stats == {"device_docs": CHUNK, "fallback_docs": 0}
    assert pair.port["pack_cache"].stats()["suffix_hits"] == 1
    assert pair.port["device_cache"].stats()["spliced"] == 1
    assert after == [workload.oracle_replay(d).summarize().digest()
                     for d in port_docs(grown)]
    assert all(a != b for a, b in zip(after, before))


def test_intervals_mixed_with_obliterate_take_the_oracle_route():
    """A log that mixes interval ops with an obliterate is routed to the
    oracle before packing in both packages, and both give its bytes."""
    def build(gen):
        spec = gen.fuzz.StringFuzzSpec(intervals=True, obliterate=True)
        return [fuzz_doc(gen, f"ivob{seed}", spec, seed=900 + seed,
                         n_clients=3, rounds=25) for seed in range(6)]

    docs = [d for d in twinned(build) if any(
        m.contents["kind"] == "obliterate" for m in d.ops) and any(
        m.contents["kind"].startswith("interval") for m in d.ops)]
    assert docs
    for doc in docs:
        assert ref_mt.known_oracle_fallback(doc)
        assert mt.known_oracle_fallback(doc.port_twin)
    got, _stage, stats = TierPair(pack=False).run(docs, chunk_docs=CHUNK)
    assert stats == {"fallback_docs": len(docs)}
    assert got == [mt.oracle_fallback_summary(d).digest()
                   for d in port_docs(docs)]
    batch_stats = {}
    batch = mt.replay_mergetree_batch(port_docs(docs), stats=batch_stats,
                                      device="cpu")
    assert [s.digest() for s in batch] == got
    assert batch_stats["fallback_docs"] == len(docs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_seam_over_interval_containers_equals_the_reference():
    """The chip smoke's I4 corpus at test size: containers whose base
    summary, uploaded mid-stream, carries an ``intervals`` blob, then more
    ops.  One ``catch_up`` of the port (``device="cpu"``) equals the JAX
    package's ``CatchupService(mesh=None)`` (results, stats, routes,
    bytes, tiers), every document on the device route, every summary the
    container fold's."""
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.testing import service_workload as sw

    port_service = LocalOrderingService()
    ids, with_blob = _chip_smoke().build_interval_containers(
        port_service, 12, IV_OPS, 48)
    assert with_blob == len(ids)
    pair = ServicePair(reference_service(port_service))
    got = pair.catch_up(ids, upload=False)
    assert pair.port.device_docs == len(ids) and pair.port.cpu_docs == 0
    assert all(got[d][0] == sw.catchup_oracle_digest(port_service, d)
               for d in ids)
