"""Tier 2.5 of the catch-up cache in the port: device-resident pack
buffers (``DevicePackCache``, ``MergeTreeDeviceOps``) and their plain
kernels' versions (``resident_cuda.splice_rows`` / ``widen_resident``),
held against the JAX package's on the CPU.

Every call of every sequence runs through both pipelines with matching
tiers (tests/torch_tiers.py): equal summary bytes, ``delta_docs``,
``h2d_bytes`` / ``d2h_bytes`` and ``stats()`` of every tier.  The port
reads no environment, so where the reference's tests force the wide
upload with ``FF_UPLOAD_NARROW=0``, the port's narrowing functions are
patched to return the wide planes."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import bench
from fluidframework_tpu.ops import device_cache as ref_dc
from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.ops.mergetree_kernel import MergeTreeDocInput
from fluidframework_tpu_torch.ops import device_cache as dc
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import pipeline, resident_cuda
from tests.torch_corpora import port_docs, warm_doc
from tests.torch_tiers import TierPair, corpus, streams, window


@pytest.fixture(autouse=True)
def _xla_fold(monkeypatch):
    monkeypatch.delenv("FF_PALLAS_FOLD", raising=False)
    monkeypatch.delenv("FF_UPLOAD_NARROW", raising=False)


def _wide_uploads(monkeypatch, wide: bool) -> None:
    """Both sides upload wide (``wide``) or narrow where the facts allow."""
    if wide:
        monkeypatch.setenv("FF_UPLOAD_NARROW", "0")
        monkeypatch.setattr(pipeline, "narrow_ops_for_upload",
                            lambda ops, meta: ops)
        monkeypatch.setattr(pipeline, "narrow_state_for_upload",
                            lambda state, meta: state)
    else:
        monkeypatch.setenv("FF_UPLOAD_NARROW", "1")
        monkeypatch.setattr(pipeline, "narrow_ops_for_upload",
                            mt.narrow_ops_for_upload)
        monkeypatch.setattr(pipeline, "narrow_state_for_upload",
                            mt.narrow_state_for_upload)


#: 12 streams of 64 ops; 56 -> 64 stays inside the T = 64 / S = 128
#: buckets (suffix splices), 20 -> 64 crosses them (a repack)
SEQUENCES = {
    "cold-exact-grown": [dict(lo=56), dict(lo=56),
                         dict(lo=56, hi=64, grown={0, 5})],
    "grown-twice": [dict(lo=56), dict(lo=56, hi=60, grown={1, 9}),
                    dict(lo=56, hi=64, grown={1, 2, 9})],
    "bucket-crossing": [dict(lo=20), dict(lo=20, hi=64, grown={2}),
                        dict(lo=20, hi=64, grown={2})],
}


@pytest.mark.parametrize("tiers", ["device+pack", "all"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_resident_sequence_matches_reference(name, tiers):
    s = streams(12, 64)
    pair = TierPair(pack=True, delta=tiers == "all", device=True)
    for call in SEQUENCES[name]:
        docs = corpus(s, **call)
        got, _stage, _stats = pair.run(docs)
    assert got == [x.digest() for x in ref_mt.replay_mergetree_batch(docs)]


def test_exact_warm_hit_uploads_nothing_and_downloads_the_digest_plane():
    s = streams(16, 64)
    pair = TierPair(pack=True, delta=True, device=True)
    docs = corpus(s, lo=56)
    pair.run(docs)
    _got, warm, stats = pair.run(docs)
    assert warm["h2d_bytes"] == 0
    assert warm["d2h_bytes"] == 8 * len(docs)
    assert stats["delta_docs"] == len(docs)
    assert pair.port["device_cache"].stats()["served"] == 2


def test_suffix_warm_catchup_moves_5x_fewer_h2d_bytes():
    """One grown document per chunk of 16: both chunks splice, and the
    upload is at least 5x smaller than the full upload of the same
    corpus (the reference's byte gate)."""
    s = streams(32, 64)
    pair = TierPair(pack=True, device=True)
    pair.run(corpus(s, lo=56), chunk_docs=16)
    grown = corpus(s, lo=56, hi=64, grown={0, 16})
    _got, res, _ = pair.run(grown, chunk_docs=16)
    full = TierPair(pack=True)
    full.run(corpus(s, lo=56), chunk_docs=16)
    _got, whole, _ = full.run(grown, chunk_docs=16)
    assert res["h2d_bytes"] * 5 <= whole["h2d_bytes"]
    assert pair.port["device_cache"].stats()["spliced"] == 2


@pytest.mark.parametrize("flip", ["narrow-to-wide", "wide-to-narrow"])
def test_encoding_flip_matches_reference(monkeypatch, flip):
    """Narrow → wide migrates the resident planes on the device (no
    full upload; the suffix still splices); wide → narrow has no
    migration and uploads in full.  Counters equal the reference's."""
    s = streams(6, 64)
    pair = TierPair(pack=True, device=True)
    _wide_uploads(monkeypatch, flip == "wide-to-narrow")
    _got, cold, _ = pair.run(corpus(s, lo=56), chunk_docs=6)
    _wide_uploads(monkeypatch, flip == "narrow-to-wide")
    _got, grown, _ = pair.run(corpus(s, lo=56, hi=64, grown={2}),
                              chunk_docs=6)
    st = pair.port["device_cache"].stats()
    if flip == "narrow-to-wide":
        assert (st["spliced"], st["misses"]) == (1, 1)
        assert 0 < grown["h2d_bytes"] < cold["h2d_bytes"]
        [entry] = pair.port["device_cache"]._entries.values()
        assert entry.ops.seq.dtype == torch.int32
    else:
        assert (st["spliced"], st["misses"]) == (0, 2)


def _warm_windows(tail_lens, epoch="ep"):
    """Documents with a base summary (the warm state rides the upload)
    whose tails are windows of one stream each."""
    base = warm_doc()
    return [dataclasses.replace(
        base, doc_id=f"w{i}", ops=base.ops[:n],
        final_seq=base.ops[n - 1].seq,
        cache_token=(epoch, f"w{i}", base.base_seq, ""))
        for i, n in enumerate(tail_lens)]


@pytest.mark.parametrize("wide_after", [False, True],
                         ids=["narrow", "narrow-to-wide"])
def test_warm_state_chunks_serve_splice_and_migrate(monkeypatch,
                                                    wide_after):
    """Warm documents keep their narrow base state resident too; a grown
    tail splices, and a flip to the wide upload migrates the state
    planes (the sentinel and the live-slot rebase) with the op planes."""
    pair = TierPair(pack=True, delta=True, device=True)
    pair.run(_warm_windows([20, 20, 20, 20]), chunk_docs=4)
    pair.run(_warm_windows([20, 20, 20, 20]), chunk_docs=4)
    _wide_uploads(monkeypatch, wide_after)
    pair.run(_warm_windows([20, 23, 20, 24]), chunk_docs=4)
    assert pair.port["device_cache"].stats()["spliced"] == 1
    [entry] = pair.port["device_cache"]._entries.values()
    assert entry.state is not None
    assert entry.state.ins_seq.dtype == \
        (torch.int32 if wide_after else torch.int16)


def test_suffix_without_pack_lineage_uploads_in_full():
    s = streams(6, 64)
    pair = TierPair(pack=False, device=True)
    docs = corpus(s, lo=56)
    pair.run(docs, chunk_docs=6)
    _got, exact, _ = pair.run(docs, chunk_docs=6)
    assert exact["h2d_bytes"] == 0
    pair.run(corpus(s, lo=56, hi=64, grown={0}), chunk_docs=6)
    st = pair.port["device_cache"].stats()
    assert (st["served"], st["spliced"], st["misses"]) == (1, 0, 2)


def test_binary_and_tokenless_chunks_bypass():
    pair = TierPair(pack=False, delta=True, device=True)
    _got, stage, _ = pair.run([bench.synth_doc(i, 16) for i in range(4)],
                              chunk_docs=4)
    assert stage["h2d_bytes"] > 0
    s = streams(4, 16)
    pair.run([dataclasses.replace(window(s, i, 12), cache_token=None)
              for i in range(4)], chunk_docs=4)
    st = pair.port["device_cache"].stats()
    assert st["bypass"] == 2 and st["entries"] == 0


def test_byte_bound_and_lru_eviction_match_reference():
    s = streams(8, 32)
    probe = TierPair(pack=True, device=True)
    probe.run(corpus(s, lo=26), chunk_docs=2)
    per_entry = max(e.nbytes for e in
                    probe.port["device_cache"]._entries.values())
    pair = TierPair(pack=True, device=True,
                    device_kw={"max_bytes": 2 * per_entry})
    pair.run(corpus(s, lo=26), chunk_docs=2)
    pair.run(corpus(s, lo=26), chunk_docs=2)
    st = pair.port["device_cache"].stats()
    assert st["entries"] <= 2 and st["evictions"] >= 2
    tiny = TierPair(pack=True, device=True, device_kw={"max_bytes": 16})
    tiny.run(corpus(s, lo=26)[:2], chunk_docs=2)
    assert tiny.port["device_cache"].stats()["entries"] == 0


def test_epoch_bump_invalidates_resident_entries():
    s = streams(4, 32)
    pair = TierPair(pack=True, device=True)
    pair.run(corpus(s, lo=26, epoch="e1"), chunk_docs=4)
    for side in (pair.ref, pair.port):
        assert side["device_cache"].invalidate_epoch("e2") == 1
        assert side["device_cache"].invalidate_epoch("e2") == 0
    pair.run(corpus(s, lo=26, epoch="e2"), chunk_docs=4)
    assert pair.port["device_cache"].stats()["invalidations"] == 1


@pytest.mark.parametrize("pin_budget", ["one-entry", "below-one-entry"])
def test_pin_spill_restore_sequence_matches_reference(pin_budget):
    """``pin_resident=True`` with a pin budget below the working set: the
    oldest pinned entries spill to host copies and restore (re-upload,
    counted in h2d_bytes) on their next acquire — through exact hits and
    a suffix splice — with the reference's counters at every call.  Below
    one entry, the served entry spills straight back after each
    restore."""
    s = streams(12, 64)
    probe = TierPair(pack=True, device=True)
    probe.run(corpus(s, lo=56), chunk_docs=4)
    per_entry = max(e.nbytes for e in
                    probe.port["device_cache"]._entries.values())
    budget = per_entry + 64 if pin_budget == "one-entry" else 1
    pair = TierPair(pack=True, delta=True, device=True,
                    device_kw={"pin_max_bytes": budget})
    for call in (dict(lo=56), dict(lo=56), dict(lo=56, hi=64, grown={1}),
                 dict(lo=56, hi=64, grown={1})):
        _got, stage, _ = pair.run(corpus(s, **call), chunk_docs=4,
                                  pin_resident=True)
    st = pair.port["device_cache"].stats()
    assert st["spills"] >= 2 and st["unspills"] >= 1
    assert st["pinned_entries"] == 3
    assert st["pinned_bytes"] <= budget


def test_pin_unpin_and_lru_exemption_match_reference():
    """The pinned tier through the cache's own API, side by side: a pinned
    entry survives an LRU sweep that evicts its unpinned control, unpin
    returns it, and unknown tokens answer False."""
    def chunk(i, ops=6):
        docs = [bench.synth_doc(i * 16 + j, ops) for j in range(2)]
        for j, doc in enumerate(docs):
            doc.cache_token = ("e0", f"chunk{i}-doc{j}", 0, ops)
            doc.binary_ops = None
            doc.ops = bench.doc_ops(bench.synth_doc(i * 16 + j, ops))
        return docs

    results = []
    for side, pack, Cache, kw in (
            ("ref", ref_mt.pack_mergetree_batch, ref_dc.DevicePackCache,
             {}),
            ("port", mt.pack_mergetree_batch, dc.DevicePackCache,
             {"device": "cpu"})):
        docs0, docs1 = chunk(0), chunk(1)
        if side == "port":
            docs0, docs1 = port_docs(docs0), port_docs(docs1)
        cache = Cache(max_bytes=192 << 20, pin_max_bytes=64 << 20, **kw)
        cache.acquire(*pack(docs0), pin=True)
        one = cache.stats()["bytes"]
        cache.max_bytes = one + 1
        cache.acquire(*pack(docs1))
        tokens = next(iter(cache._entries))
        log = [cache.stats(), cache.unpin(tokens), cache.unpin(tokens),
               cache.pin(("nope",)), cache.stats()]
        results.append(json.dumps(log, sort_keys=True))
    assert results[0] == results[1]
    assert json.loads(results[1])[0]["pinned_entries"] == 1


def test_forced_digest_mismatch_with_every_tier():
    s = streams(8, 64)
    pair = TierPair(pack=True, delta=True, device=True)
    docs = corpus(s, lo=56)
    pair.run(docs)
    for side in (pair.ref, pair.port):
        cache = side["delta_cache"]
        token = docs[3].cache_token
        cache._entries[token] = cache._entries[token]._replace(
            digest=(7, 7))
    _got, stage, stats = pair.run(docs)
    assert stats["delta_docs"] == 7 and stage["h2d_bytes"] == 0


def test_splice_keeps_every_resident_tensor_in_place():
    """The port's counterpart of the reference's donation test: a suffix
    acquire writes the resident tensors in place (same storage), and the
    result equals the host arrays of the grown chunk."""
    s = streams(6, 64)
    pair = TierPair(pack=True, device=True)
    pair.run(corpus(s, lo=56), chunk_docs=6)
    [entry] = pair.port["device_cache"]._entries.values()
    before = {f: getattr(entry.ops, f).data_ptr() for f in mt.MTOps._fields}
    packed = []
    pipeline.pipelined_mergetree_replay(
        port_docs(corpus(s, lo=56, hi=64, grown={1, 4})), chunk_docs=6,
        packed_out=packed, device="cpu", **pair.port)
    assert pair.port["device_cache"].stats()["spliced"] == 1
    assert {f: getattr(entry.ops, f).data_ptr()
            for f in mt.MTOps._fields} == before
    [(_state, host_ops, _meta, _tag)] = packed
    for f in mt.MTOps._fields:
        np.testing.assert_array_equal(getattr(entry.ops, f).numpy(),
                                      getattr(host_ops, f), err_msg=f)


# ---------------------------------------------------------------------------
# The plain versions of the kernels
# ---------------------------------------------------------------------------


def _splice_case(dtype, K, seed=7):
    rng = np.random.default_rng(seed)
    D, T, L = 5, 24, 8
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -100), min(info.max, 100)

    def planes(width):
        out = {f: rng.integers(lo, hi, (D, width), dtype)
               for f in mt.MTOps._fields if f != "pvals"}
        out["pvals"] = rng.integers(lo, hi, (D, width, K), dtype)
        return out

    start = np.asarray([0, 3, 16, 20, 7], np.int32)
    count = np.asarray([2, 8, 8, 4, 0], np.int32)
    return planes(T), planes(L), start, count


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_plain_splice_matches_row_loop_and_reference(dtype, K):
    """The plain splice (``resident_cuda.splice_rows`` on CPU tensors,
    the port's counterpart of the reference's ``_splice_ops``) equals the
    obvious per-document row loop (ragged counts, one of them 0) and the
    reference's ``_splice_ops``, and writes in place."""
    import jax

    base, rows, start, count = _splice_case(dtype, K)
    resident = mt.MTOps(**{f: torch.from_numpy(v.copy())
                           for f, v in base.items()})
    ptrs = [x.data_ptr() for x in resident]
    out = resident_cuda.splice_rows(
        resident, mt.MTOps(**{f: torch.from_numpy(v)
                              for f, v in rows.items()}),
        torch.from_numpy(start), torch.from_numpy(count))
    assert out is resident and [x.data_ptr() for x in out] == ptrs
    ref = ref_dc._splice_ops(
        ref_mt.MTOps(**{f: jax.device_put(v) for f, v in base.items()}),
        ref_mt.MTOps(**{f: jax.device_put(v) for f, v in rows.items()}),
        jax.device_put(start), jax.device_put(count))
    for f in mt.MTOps._fields:
        expect = base[f].copy()
        for d in range(len(start)):
            for j in range(int(count[d])):
                expect[d, start[d] + j] = rows[f][d, j]
        np.testing.assert_array_equal(getattr(out, f).numpy(), expect,
                                      err_msg=f)
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), expect,
                                      err_msg=f)


def _narrow_chunk(warm):
    """A packed chunk and its narrow upload encoding (ops, and the base
    state of warm documents)."""
    docs = _warm_windows([20, 17, 24]) if warm else \
        corpus(streams(6, 32), lo=26)
    state, ops, meta = ref_mt.pack_mergetree_batch(docs)
    n_ops = ref_mt.narrow_ops_for_upload(ops, meta)
    n_state = ref_mt.narrow_state_for_upload(state, meta)
    assert n_ops.seq.dtype == np.int16
    if warm:
        assert n_state.ins_seq.dtype == np.int16
        assert (np.asarray(n_state.rem_seq) == ref_mt.I16_NOT_REMOVED).any()
    return n_state, n_ops, np.asarray(meta["doc_base"], np.int32)


@pytest.mark.parametrize("what", ["ops", "state"])
def test_plain_widen_matches_reference(what):
    """``widen_resident`` on CPU tensors equals the reference's
    ``_widen_ops`` / ``_widen_state`` on the same narrow planes, bit for
    bit, and keeps ``overflow`` as it is."""
    import jax.numpy as jnp

    n_state, n_ops, base = _narrow_chunk(warm=what == "state")
    tree = n_ops if what == "ops" else n_state
    widen = ref_mt._widen_ops if what == "ops" else ref_mt._widen_state
    want = widen(type(tree)(*(jnp.asarray(x) for x in tree)),
                 jnp.asarray(base))
    port_type = mt.MTOps if what == "ops" else mt.MTState
    port_tree = port_type(*(torch.from_numpy(np.ascontiguousarray(x))
                            for x in tree))
    got = resident_cuda.widen_resident(port_tree, torch.from_numpy(base))
    for f in port_type._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    if what == "state":
        assert got.overflow is port_tree.overflow


def test_widen_resident_passes_wide_and_refuses_unknown_encodings():
    _state, n_ops, base = _narrow_chunk(warm=False)
    wide = mt.MTOps(*(torch.from_numpy(np.ascontiguousarray(x, np.int32))
                      for x in n_ops))
    assert resident_cuda.widen_resident(wide, torch.from_numpy(base)) is wide
    odd = wide._replace(seq=wide.seq.to(torch.int8))
    with pytest.raises(TypeError, match="seq dtype"):
        resident_cuda.widen_resident(odd, torch.from_numpy(base))
    with pytest.raises(TypeError, match="MTOps or MTState"):
        resident_cuda.widen_resident((wide.seq,), torch.from_numpy(base))


def test_cuda_wrappers_refuse_other_devices():
    """A wrapper given tensors on neither the CPU nor the card raises; it
    never quietly falls back (the card itself is held in
    tests/test_torch_cuda.py)."""
    meta_t = torch.empty((2, 4), dtype=torch.int32, device="meta")
    ops = mt.MTOps(*([meta_t] * 9 + [torch.empty((2, 4, 1),
                                                 dtype=torch.int32,
                                                 device="meta")]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        resident_cuda.splice_rows(ops, ops, meta_t[:, 0], meta_t[:, 0])


def test_port_doc_input_carries_the_cache_token():
    doc = MergeTreeDocInput(doc_id="x", ops=[], cache_token=("ep", "x"))
    assert port_docs([doc])[0].cache_token == ("ep", "x")
