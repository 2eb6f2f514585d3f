"""SharedTree through the port's generic pipeline and its cache tiers
(``ops/tree_pipeline.py``), held against the JAX package's on the CPU.

The call sequences of tests/test_tree_pipeline.py run through both
pipelines with matching tiers (tests/torch_tiers.py, ``tree=True``):
every call asserts equal summary bytes, equal ``stats`` (``device_docs``,
per-reason fallbacks, ``delta_docs``), equal ``h2d_bytes`` /
``d2h_bytes`` and an equal ``stats()`` dict for every tier.  Also here:
the three repairs that let a second family ride the port's tiers (the
family's ``device_ops``, a plain-tuple aux through tier 2.5 and its
spill, and the untiered aux upload leaf by leaf)."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.tree import SharedTree as RefTree
from fluidframework_tpu.ops import tree_kernel as ref_tk
from fluidframework_tpu.protocol.messages import (MessageType,
                                                  SequencedMessage)
from fluidframework_tpu_torch.convert import tree_doc_input_from
from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops import tree_pipeline as tp
from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
from tests.test_tree_kernel import run_fuzz_doc
from tests.torch_tiers import TierPair
from tools.bench_kernels import synth_tree_messages, tree_doc, tree_shape


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fuzz_docs(seed, n=6, steps=40, cut=0):
    docs = []
    for k in range(n):
        _f, _t, log, fs, fm = run_fuzz_doc(seed * 100 + k, steps=steps,
                                           with_moves=(k % 2 == 0))
        window = log[:len(log) - cut] if cut else log
        docs.append(ref_tk.TreeDocInput(
            f"d{seed}-{k}", ops=window, final_seq=window[-1].seq,
            final_msn=(fm if not cut else 0),
            cache_token=("ep", f"d{seed}-{k}", 0, "")))
    return docs


def _oracle(docs):
    return [ref_tk.oracle_fallback_summary(d).digest() for d in docs]


def _all():
    return TierPair(pack=True, delta=True, device=True, tree=True)


#: (tiers, windows per call) over 16 pinned streams of 40 edits: 34 of
#: them, then every 3rd document grown (in bucket: splices)
STREAMS = [synth_tree_messages(i, 40) for i in range(16)]


def _windows(cut_grown, cut_rest=6, every=3):
    return [tree_doc(i, s, len(s) - (cut_grown if i % every == 0
                                     else cut_rest))
            for i, s in enumerate(STREAMS)]


SEQUENCES = {
    "cold-exact-grown": [6, 6, 0],
    "grown-twice": [6, 3, 0],
    "exact-only": [6, 6],
}
TIERS = {
    "pack": dict(pack=True),
    "device+pack": dict(pack=True, device=True),
    "all": dict(pack=True, delta=True, device=True),
}


@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_tier_sequence_matches_reference(name, tiers):
    pair = TierPair(tree=True, **TIERS[tiers])
    for cut in SEQUENCES[name]:
        docs = _windows(cut)
        got, stage, _stats = pair.run(docs)
        assert stage["h2d_bytes"] >= 0
    assert got == _oracle(docs)


def test_golden_parity_every_shape():
    """The workload's five shapes: tiers on == tiers off == one batch ==
    oracle, with the per-reason fallback split live."""
    docs = [tree_doc(i, synth_tree_messages(i, 40), 40) for i in range(32)]
    assert {tree_shape(i) for i in range(32)} == {
        "deep-move", "wide-container", "revive", "multi_id_move",
        "max_depth"}
    on, _stage, stats = _all().run(docs)
    off, _stage2, _stats2 = TierPair(pack=False, tree=True).run(docs)
    oracle = _oracle(docs)
    assert on == oracle and off == oracle
    batch = tk.replay_tree_batch([tree_doc_input_from(d) for d in docs],
                                 device="cpu")
    assert [s.digest() for s in batch] == oracle
    assert stats["fallback_docs"] == sum(
        v for k, v in stats.items()
        if k.startswith("fallback_") and k != "fallback_docs")
    for reason in ("revive", "multi_id_move", "max_depth"):
        assert stats[f"fallback_{reason}"] >= 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_parity_tiers_on_and_off(seed):
    docs = _fuzz_docs(seed)
    on, _st, _s = _all().run(docs)
    off, _st2, _s2 = TierPair(pack=False, tree=True).run(docs)
    assert on == off == _oracle(docs)


def test_warm_summary_reentry_through_the_tiers():
    """Warm bases re-enter as packed base state; the warm window serves
    exact from tiers 2 / 2.5 / 0 with zero upload and only the digest
    plane downloaded."""
    docs = []
    for k in range(4):
        _f, _t, log, fs, fm = run_fuzz_doc(7000 + k, steps=36,
                                           with_moves=(k % 2 == 0))
        mid = len(log) // 2
        base = RefTree("t")
        for m in log[:mid]:
            base.process(m, local=False)
        docs.append(ref_tk.TreeDocInput(
            f"w{k}", ops=log[mid:], base_summary=base.summarize(),
            final_seq=fs, final_msn=fm,
            cache_token=("ep", f"w{k}", 0, "")))
    pair = _all()
    cold, _stage, _stats = pair.run(docs)
    warm, stage, stats = pair.run(docs)
    assert cold == warm == _oracle(docs)
    assert stats.get("delta_docs", 0) >= 1
    assert stage["h2d_bytes"] == 0
    port = pair.tier_stats("port")
    assert port["pack_cache"]["exact_hits"] >= 1
    assert port["device_cache"]["served"] >= 1


def test_grown_tail_suffix_hits_and_splice():
    base = _fuzz_docs(31, cut=3)
    full = _fuzz_docs(31, cut=0)
    pair = _all()
    pair.run(base)
    grown, stage, _stats = pair.run(full)
    assert grown == _oracle(full)
    port = pair.tier_stats("port")
    assert port["pack_cache"]["suffix_hits"] >= 1
    assert port["device_cache"]["spliced"] >= 1
    _off, stage_off, _s = TierPair(pack=False, tree=True).run(full)
    assert stage["h2d_bytes"] < stage_off["h2d_bytes"]


def test_second_splice_advances_the_watermark():
    """Two grown-tail splices in a row: the resident entry's edit-row
    watermark advances with each, and the resident planes equal a fresh
    pack of the combined windows (all three splice axes in place)."""
    pair = _all()
    pair.run(_fuzz_docs(31, cut=4))
    pair.run(_fuzz_docs(31, cut=2))
    full = _fuzz_docs(31, cut=0)
    grown, _stage, _stats = pair.run(full)
    assert grown == _oracle(full)
    dev = pair.port["device_cache"]
    assert dev.stats()["spliced"] == 2
    (entry,) = dev._entries.values()
    np.testing.assert_array_equal(entry.t_rows,
                                  tp.TreeDeviceOps.t_rows(entry.ops))
    state, edits, meta = pair.port["pack_cache"].pack(
        [tree_doc_input_from(d) for d in full])
    for f in tk.TreeEdits._fields:
        np.testing.assert_array_equal(getattr(entry.ops, f).numpy(),
                                      getattr(edits, f), err_msg=f)
    for f in tk.TreeState._fields:
        np.testing.assert_array_equal(getattr(entry.state, f).numpy(),
                                      getattr(state, f), err_msg=f)
    assert [x.tolist() for x in entry.base] == \
        [meta["n_nodes"].tolist(), meta["n_cont"].tolist()]


def test_forced_repack_on_bucket_growth_still_byte_identical():
    msgs = synth_tree_messages(3, 120)  # wide-container shape
    pair = _all()
    pair.run([tree_doc(3, msgs, 30)])    # edit bucket 32
    grown, _stage, _stats = pair.run([tree_doc(3, msgs, 120)])  # 128
    assert grown == _oracle([tree_doc(3, msgs, 120)])
    port = pair.tier_stats("port")
    assert port["pack_cache"]["suffix_hits"] == 0
    assert port["pack_cache"]["misses"] >= 2
    assert port["device_cache"]["spliced"] == 0


def test_duplicate_id_suffix_forces_repack_never_corrupts():
    def msg(seq, edits):
        return SequencedMessage(
            seq=seq, client_id="c0", client_seq=seq, ref_seq=seq - 1,
            min_seq=0, type=MessageType.OP, contents={"edits": edits})

    def ins(nid, value, field="a"):
        return {"kind": "insert", "parent": "", "field": field,
                "anchor": None,
                "content": [{"id": nid, "type": "n", "value": value}]}

    log = [msg(1, [ins("n1", 1)]), msg(2, [ins("n2", 2)]),
           msg(3, [ins("n1", 99)]),           # the duplicate-id suffix
           msg(4, [ins("n3", 3, field="b")])]

    def doc(n):
        window = log[:n]
        return ref_tk.TreeDocInput(
            "dupdoc", ops=window, final_seq=window[-1].seq,
            cache_token=("ep", "dupdoc", 0, ""))

    pair = _all()
    pair.run([doc(2)])
    grown, _stage, _stats = pair.run([doc(4)])
    assert grown == _oracle([doc(4)])
    port = pair.tier_stats("port")
    assert port["pack_cache"]["suffix_hits"] == 0
    assert port["device_cache"]["spliced"] == 0


def test_partial_delta_gather_serves_unchanged_docs():
    streams = [synth_tree_messages(100 + i, 40) for i in range(8)]
    streams = [s for i, s in enumerate(streams)
               if tree_shape(100 + i) in ("deep-move", "wide-container")]
    base = [tree_doc(i, s, len(s) - 2) for i, s in enumerate(streams)]
    grown = [tree_doc(i, s, len(s) if i % 2 else len(s) - 2)
             for i, s in enumerate(streams)]
    pair = _all()
    pair.run(base)
    got, stage, stats = pair.run(grown)
    assert got == _oracle(grown)
    delta = pair.tier_stats("port")["delta_cache"]
    assert delta["served"] >= 1 and delta["misses"] >= 1
    assert stats.get("delta_docs", 0) >= 1


def test_epoch_invalidation_refills_and_stays_identical():
    docs = _windows(6)
    pair = _all()
    pair.run(docs)
    for side in (pair.ref, pair.port):
        side["delta_cache"].invalidate_epoch("other-epoch")
        side["device_cache"].invalidate_epoch("other-epoch")
    got, stage, _stats = pair.run(docs)
    assert got == _oracle(docs)
    assert pair.tier_stats("port")["device_cache"]["invalidations"] >= 1
    assert stage["h2d_bytes"] > 0


def test_pinned_resident_tier_spills_and_restores_tuple_aux():
    """The pinned tier below its working set: entries (whose aux is the
    family's plain tuple of row counts) spill to host copies and are
    restored on their next acquire."""
    docs = _windows(6)
    pair = _all()
    pair.run(docs)
    budget = pair.tier_stats("port")["device_cache"]["bytes"] // 2
    for side in (pair.ref, pair.port):
        side["device_cache"].pin_max_bytes = budget
    pair.run(docs, pin_resident=True)
    spilled = [e for e in pair.port["device_cache"]._entries.values()
               if e.spilled]
    assert spilled and all(type(e.base) is tuple and len(e.base) == 2
                           for e in spilled)
    got, _stage, _stats = pair.run(_windows(0), pin_resident=True)
    assert got == _oracle(_windows(0))
    st = pair.tier_stats("port")["device_cache"]
    assert st["spills"] >= 1 and st["unspills"] >= 1


# -- the repairs ------------------------------------------------------------


def _recording(family, seen):
    def dispatch(state, ops, meta, digest, aux_dev):
        seen.append(aux_dev)
        return family.dispatch(state, ops, meta, digest, aux_dev)
    return dataclasses.replace(family, dispatch=dispatch)


@pytest.mark.parametrize("delta", [False, True])
def test_untiered_upload_maps_a_two_array_aux_leaf_by_leaf(delta):
    """Without tier 2.5 the family's aux is uploaded leaf by leaf: the
    tree's two count arrays reach the dispatch as two ``[D]`` int32
    tensors, not one ``[2, D]`` tensor."""
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)

    seen = []
    docs = [tree_doc_input_from(d) for d in _windows(6)[3:8]]
    out = pipeline.pipelined_family_replay(
        _recording(tp.TREE_FAMILY, seen), docs, chunk_docs=8,
        delta_cache=DeltaExportCache() if delta else None, device="cpu")
    assert [s.digest() for s in out] == _oracle(_windows(6)[3:8])
    (aux,) = seen
    assert type(aux) is tuple and len(aux) == 2
    for leaf in aux:
        assert isinstance(leaf, torch.Tensor)
        assert leaf.shape == (5,) and leaf.dtype == torch.int32


def test_untiered_upload_keeps_a_single_array_aux_one_tensor():
    from fluidframework_tpu_torch.testing import workload

    seen = []
    docs = [workload.synth_doc(i, 16) for i in range(3)]
    pipeline.pipelined_family_replay(
        _recording(pipeline.MERGETREE_FAMILY, seen), docs, device="cpu")
    (aux,) = seen
    assert isinstance(aux, torch.Tensor) and aux.shape == (3,)


def test_device_cache_takes_the_family_device_ops_and_a_tuple_aux():
    """``DevicePackCache(device_ops=...)`` serves that family: a tree
    chunk's full upload stores its aux as a plain tuple of two tensors
    (``put_tree``), and an exact re-acquire serves it with no upload."""
    calls = collections.Counter()

    class Counting(tp.TreeDeviceOps):
        def sig(self, state, edits):
            calls["sig"] += 1
            return super().sig(state, edits)

    cache = DevicePackCache(device="cpu", device_ops=Counting())
    docs = [tree_doc_input_from(d) for d in _windows(6)[:4]]
    state, edits, meta = tk.pack_tree_batch(docs)
    st, ed, base, up = cache.acquire(state, edits, meta)
    assert calls["sig"] == 1
    assert type(base) is tuple and len(base) == 2
    assert [x.tolist() for x in base] == \
        [meta["n_nodes"].tolist(), meta["n_cont"].tolist()]
    assert type(st) is tk.TreeState and type(ed) is tk.TreeEdits
    assert up == sum(x.nbytes for x in state) + sum(
        x.nbytes for x in edits) + 2 * meta["n_nodes"].nbytes
    _st, _ed, base2, up2 = cache.acquire(state, edits, meta)
    assert up2 == 0 and base2 is base
    assert cache.stats()["served"] == 1


def test_map_leaves_keeps_the_tree_shape():
    arr = np.arange(3)
    double = lambda x: x * 2  # noqa: E731
    assert pipeline.map_leaves(double, None) is None
    assert pipeline.map_leaves(double, arr).tolist() == [0, 2, 4]
    pair = pipeline.map_leaves(double, (arr, arr + 1))
    assert type(pair) is tuple and pair[1].tolist() == [2, 4, 6]
    edits = tk.TreeEdits(*([arr] * 8))
    mapped = pipeline.map_leaves(double, edits)
    assert type(mapped) is tk.TreeEdits and mapped.seq.tolist() == [0, 2, 4]


@pytest.mark.parametrize("n_docs, k", [(160, 2), (560, 7)])
def test_document_slices_extract_the_unsliced_bytes(monkeypatch, n_docs, k):
    """A tree chunk extracted as ``k`` document slices (``n_nodes`` /
    ``n_cont`` / ``t_rows`` sliced beside the documents) gives the
    unsliced extraction's summaries in the caller's order, the one-batch
    entry's and the oracle's, with the same per-reason fallback counts.
    Known fallbacks route around the chunk, so it holds fewer than
    ``n_docs``."""
    docs = [tree_doc_input_from(tree_doc(i, STREAMS[i % 16], 34))
            for i in range(n_docs)]
    folded = sum(not tp.TREE_FAMILY.known_fallback(d) for d in docs)
    assert min(7, folded // pipeline.MIN_SLICE_DOCS) == k

    def run():
        stage, stats = {}, {}
        got = tp.pipelined_tree_replay(docs, chunk_docs=n_docs, stage=stage,
                                       stats=stats, device="cpu")
        return [s.digest() for s in got], stage["extract_tasks"], stats

    sliced, tasks, stats = run()
    monkeypatch.setattr(pipeline, "MIN_SLICE_DOCS", n_docs + 1)
    whole, whole_tasks, whole_stats = run()
    assert (tasks, whole_tasks) == (k, 1)
    assert sliced == whole
    assert stats == whole_stats and stats["device_docs"] > 0
    assert any(v for key, v in stats.items()
               if key.startswith("fallback_") and key != "fallback_docs")
    assert sliced == [s.digest() for s in tk.replay_tree_batch(
        docs, device="cpu")]
    assert sliced == [tk.oracle_fallback_summary(d).digest() for d in docs]


def _record_pool(n_docs, n_ops, seed):
    from portbench import run, sharedtree

    spec = run.load_cell("tree_long.forest_cold")
    pool = sharedtree.generate(spec.config, spec.traffic, seed,
                               n_docs=n_docs, n_ops=n_ops)
    return pool, sharedtree.inputs(pool)


def test_a_record_chunk_packs_in_ranges_on_both_pools():
    """A 1,024-document chunk of record documents packs as 7 ranges at the
    defaults (``stage["pack_tasks"]``), a chunk under 128 documents as one
    task; the summaries and counts are the unsliced pipeline's, and the
    summaries the benchmark's plain reference's."""
    from portbench.reference import sharedtree as ref

    pool, docs = _record_pool(1024 + 100, 24, 2 ** 33 + 17)

    def run():
        stage, stats = {}, {}
        got = tp.pipelined_tree_replay(docs, device="cpu", stage=stage,
                                       stats=stats)
        return [s.digest() for s in got], stage, stats, got

    sliced, stage, stats, got = run()
    assert stage["pack_tasks"] == 7 + 1
    whole_family = dataclasses.replace(tp.TREE_FAMILY, slice_pack=None)
    w_stage, w_stats = {}, {}
    whole = pipeline.pipelined_family_replay(
        whole_family, docs, device="cpu", stage=w_stage, stats=w_stats)
    assert w_stage["pack_tasks"] == 2
    assert sliced == [s.digest() for s in whole]
    assert stats == w_stats == {"native_pack_docs": len(docs),
                                "device_docs": len(docs)}
    for d in range(0, pool.n_docs, 37):
        want = ref.replay(pool.records(d), pool.final_msn)
        assert {k: v.content for k, v in got[d].children.items()} == want


def test_a_sliced_pack_on_one_worker_a_pool_finishes():
    """With one pack and one extract worker, several record chunks each
    cut into two ranges pack, fold and extract within a bounded wait, in
    the caller's order."""
    import threading

    _pool, docs = _record_pool(5 * 128, 16, 41)
    box = {}

    def call():
        stage = {}
        box["got"] = tp.pipelined_tree_replay(
            docs, chunk_docs=128, pack_threads=1, extract_threads=1,
            stage=stage, device="cpu")
        box["stage"] = stage

    worker = threading.Thread(target=call, daemon=True)
    worker.start()
    worker.join(timeout=300)
    assert not worker.is_alive(), "the sliced packs did not finish"
    assert box["stage"]["pack_tasks"] == 5 * 2
    assert [s.digest() for s in box["got"]] == \
        [s.digest() for s in tk.replay_tree_batch(docs, device="cpu")]
