"""The port's doc-sharded fold (``fluidframework_tpu_torch/parallel``)
against the JAX package's ``parallel`` on the CPU.

Twins of tests/test_parallel.py: where the reference runs on ``n`` of the
8 virtual CPU devices tests/conftest.py forces, the port runs
``doc_mesh(["cpu"] * n)``, so the split into parts, the per-part folds
and the reassembly run here.  Summaries, ``stats`` dicts, stage keys and
the ``h2d_bytes`` / ``d2h_bytes`` counters must equal the reference's
``replay_*_sharded`` for mesh sizes 1, 2, 3, 5 and 8, with the cache
tiers on and off; the seam's ``CatchupService(mesh=...)`` is held
against the reference's with the mesh chosen on purpose on both sides.
"""

import jax
import numpy as np
import pytest
import torch

import bench
from fluidframework_tpu.ops import map_kernel as ref_mp
from fluidframework_tpu.ops import matrix_kernel as ref_mk
from fluidframework_tpu.ops import tree_kernel as ref_tk
from fluidframework_tpu.parallel import shard as ref_shard
from fluidframework_tpu.service import LocalOrderingService as RefOrdering
from fluidframework_tpu.service.catchup import CatchupService as RefCatchup
from fluidframework_tpu_torch.convert import (load_service_corpus,
                                              map_doc_input_from,
                                              matrix_doc_input_from,
                                              tree_doc_input_from)
from fluidframework_tpu_torch.ops import map_kernel as mp
from fluidframework_tpu_torch.ops import matrix_kernel as mk
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops.parts import Parts
from fluidframework_tpu_torch.parallel import (dcn_mesh, doc_mesh,
                                               replay_map_sharded,
                                               replay_matrix_sharded,
                                               replay_mergetree_sharded,
                                               replay_tree_sharded)
from fluidframework_tpu_torch.service import LocalOrderingService
from fluidframework_tpu_torch.service.catchup import CatchupService
from tests.test_tree_kernel import run_fuzz_doc
from tests.torch_corpora import (GENERATORS, graft_entry, port_docs,
                                 port_stage_keys, port_twin, twinned)
from tests.torch_service import export_corpus
from tests.torch_tiers import TierPair, corpus, streams

SIZES = (1, 2, 3, 5, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_mesh(n):
    return ref_shard.doc_mesh(jax.devices()[:n])


def port_mesh(n):
    return doc_mesh(["cpu"] * n)


def digests(summaries):
    return [s.digest() for s in summaries]


def both(ref_fn, port_fn, ref_docs, port_in, n, **kw):
    """The reference's and the port's sharded entry over the same
    documents on ``n`` parts; returns the port's digests after asserting
    equal digests and equal ``stats``."""
    r_stats, p_stats = {}, {}
    ref = ref_fn(ref_docs, mesh=ref_mesh(n), stats=r_stats, **kw)
    got = port_fn(port_in, mesh=port_mesh(n), stats=p_stats, **kw)
    assert digests(got) == digests(ref)
    assert p_stats == r_stats
    return digests(got)


def _fuzz_docs(spec_name, make_doc, seeds, rounds):
    """Each seed's fuzz log as a doc input built by each package's own
    generator (``torch_corpora.twinned``), with the reference replica's
    summary digest: (reference docs carrying their port twins, oracle
    digests)."""
    oracle = []

    def build(gen):
        docs = []
        for i, seed in enumerate(seeds):
            replicas, factory = gen.run_fuzz(
                getattr(gen.fuzz, spec_name)(), seed=seed, n_clients=2,
                rounds=rounds + i)
            docs.append(make_doc(gen, i, factory))
            if gen is GENERATORS[0]:  # the reference's replicas
                oracle.append(replicas[0].summarize().digest())
        return docs

    return twinned(build), oracle


@pytest.fixture(scope="module")
def fuzz_docs():
    # 11 documents: deliberately not a multiple of 8
    return _fuzz_docs("StringFuzzSpec", lambda gen, i, factory:
                      gen.MergeTreeDocInput(
                          doc_id=f"doc{i}",
                          ops=gen.channel_log(factory, "fuzz"),
                          final_seq=factory.sequencer.seq,
                          final_msn=factory.sequencer.min_seq),
                      range(300, 311), 5)


def _map_docs(base_seed, n, rounds):
    return _fuzz_docs("MapFuzzSpec", lambda gen, i, factory: gen.MapDocInput(
        doc_id=f"m{i}", ops=gen.channel_log(factory, "fuzz")),
        range(base_seed, base_seed + n), rounds)


def _matrix_docs(base_seed, n, rounds):
    return _fuzz_docs("MatrixFuzzSpec", lambda gen, i, factory:
                      gen.MatrixDocInput(
                          doc_id=f"mx{i}",
                          ops=gen.channel_log(factory, "fuzz"),
                          final_seq=factory.sequencer.seq,
                          final_msn=factory.sequencer.min_seq),
                      range(base_seed, base_seed + n), rounds)


def _map_in(docs):
    return [port_twin(d, map_doc_input_from) for d in docs]


def _matrix_in(docs):
    return [port_twin(d, matrix_doc_input_from) for d in docs]


def _tree_in(docs):
    return [tree_doc_input_from(d) for d in docs]


# -- the mesh -----------------------------------------------------------------


def test_mesh_spans_eight_devices():
    mesh = port_mesh(8)
    assert mesh.size == ref_mesh(8).size == 8
    assert mesh.axis_names == ("docs",) and mesh.shape == (8,)
    assert mesh == doc_mesh(["cpu"] * 8) and hash(mesh) == hash(
        doc_mesh([torch.device("cpu")] * 8))
    assert mesh != port_mesh(4)
    with pytest.raises(AttributeError):
        mesh.size = 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            doc_mesh()


@pytest.mark.parametrize("n", SIZES)
def test_sharded_replay_matches_oracle_and_single_chip(fuzz_docs, n):
    docs, oracle_digests = fuzz_docs
    got = both(ref_shard.replay_mergetree_sharded, replay_mergetree_sharded,
               docs, port_docs(docs), n)
    assert got == oracle_digests
    stats, single_stats = {}, {}
    replay_mergetree_sharded(port_docs(docs), mesh=port_mesh(n),
                             stats=stats)
    single = mt.replay_mergetree_batch(port_docs(docs), single_stats,
                                       device="cpu")
    assert digests(single) == oracle_digests
    assert stats.get("device_docs", 0) + stats.get("fallback_docs", 0) \
        == len(docs)
    assert stats == single_stats


def test_sharded_replay_single_doc_pads_to_mesh(fuzz_docs):
    docs, oracle_digests = fuzz_docs
    for n in (3, 8):
        [digest] = both(ref_shard.replay_mergetree_sharded,
                        replay_mergetree_sharded, docs[:1],
                        port_docs(docs[:1]), n)
        assert digest == oracle_digests[0]


def test_graft_dryrun_families_on_eight_parts():
    """The port's counterpart of the graft entry's multichip dry run
    (``__graft_entry__.dryrun_multichip``): every family's sharded entry
    over the graft's hard corpora on 8 parts, equal to the reference's
    on its 8 virtual devices."""
    mod = graft_entry()
    mt_docs = mod._hard_mergetree_docs()
    both(ref_shard.replay_mergetree_sharded, replay_mergetree_sharded,
         mt_docs, port_docs(mt_docs), 8)
    tree_docs = mod._hard_tree_docs()
    both(ref_shard.replay_tree_sharded, replay_tree_sharded, tree_docs,
         _tree_in(tree_docs), 8)
    mx_docs = mod._hard_matrix_docs()
    both(ref_shard.replay_matrix_sharded, replay_matrix_sharded, mx_docs,
         _matrix_in(mx_docs), 8)
    map_docs, _ = _map_docs(900, 3, 6)
    both(ref_shard.replay_map_sharded, replay_map_sharded, map_docs,
         _map_in(map_docs), 8)


def test_dcn_mesh_shape_and_validation():
    cpus = ["cpu"] * 8
    mesh = dcn_mesh(2, cpus)
    assert mesh.axis_names == ref_shard.dcn_mesh(2).axis_names \
        == ("slice", "docs")
    assert mesh.devices.shape == (2, 4) and mesh.size == 8
    assert dcn_mesh(4, cpus).devices.shape == (4, 2)
    with pytest.raises(ValueError):
        dcn_mesh(3, cpus)  # 8 devices don't split into 3 slices
    with pytest.raises(ValueError):
        dcn_mesh(0, cpus)
    from fluidframework_tpu_torch.parallel.shard import _doc_spec

    # the document axis spans every mesh axis, flattened in order
    assert tuple(ref_shard._doc_spec(ref_shard.dcn_mesh(2)))[0] \
        == _doc_spec(mesh) == ("slice", "docs")


def test_dcn_mesh_rejects_rows_straddling_hardware_slices():
    class FakeDev:
        def __init__(self, i, slice_index):
            self.id = i
            self.slice_index = slice_index

    # 4 hardware slices of 2 devices: dcn_mesh(2) would put two hardware
    # slices in one mesh row — both packages reject it.
    devs = [FakeDev(i, i // 2) for i in range(8)]
    for fn in (dcn_mesh, ref_shard.dcn_mesh):
        with pytest.raises(ValueError, match="straddle a DCN boundary"):
            fn(2, devs)
    # grouped by slice_index (then id), whatever order they come in
    mesh = dcn_mesh(4, list(reversed(devs)))
    assert [[d.id for d in row] for row in mesh.devices] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_dcn_sharded_replay_matches_oracle(fuzz_docs):
    docs, oracle_digests = fuzz_docs
    for n_slices in (2, 4):
        got = replay_mergetree_sharded(
            port_docs(docs), mesh=dcn_mesh(n_slices, ["cpu"] * 8))
        ref = ref_shard.replay_mergetree_sharded(
            docs, mesh=ref_shard.dcn_mesh(n_slices))
        assert digests(got) == digests(ref) == oracle_digests


def test_odd_mesh_size_shards_map_and_matrix():
    """Non-power-of-two part counts (3, 5, 7): the map's documents and
    the matrix's [2D] stream axis still split evenly."""
    map_docs, _ = _map_docs(800, 3, 8)
    mx_docs, _ = _matrix_docs(800, 3, 8)
    for n in (3, 5, 7):
        both(ref_shard.replay_map_sharded, replay_map_sharded, map_docs,
             _map_in(map_docs), n)
        got = both(ref_shard.replay_matrix_sharded, replay_matrix_sharded,
                   mx_docs, _matrix_in(mx_docs), n)
        assert got == digests(ref_mk.replay_matrix_batch(mx_docs))


def test_dcn_sharded_map_and_matrix_match_oracle():
    map_docs, map_digests = _map_docs(700, 3, 8)
    mx_docs, mx_digests = _matrix_docs(700, 3, 8)
    mesh = dcn_mesh(2, ["cpu"] * 8)
    assert digests(replay_map_sharded(_map_in(map_docs), mesh=mesh)) \
        == digests(ref_shard.replay_map_sharded(
            map_docs, mesh=ref_shard.dcn_mesh(2))) == map_digests
    assert digests(replay_matrix_sharded(_matrix_in(mx_docs), mesh=mesh)) \
        == digests(ref_shard.replay_matrix_sharded(
            mx_docs, mesh=ref_shard.dcn_mesh(2))) == mx_digests


@pytest.mark.parametrize("n", (3, 8))
def test_tree_sharded_matches_oracle(n):
    docs, oracle_digests = [], []
    for seed in range(5):  # not a multiple of 8: exercises padding
        _f, trees, log, fs, fm = run_fuzz_doc(600 + seed, steps=30)
        docs.append(ref_tk.TreeDocInput("tree", ops=log, final_seq=fs,
                                        final_msn=fm))
        oracle_digests.append(trees[0].summarize().digest())
    got = both(ref_shard.replay_tree_sharded, replay_tree_sharded, docs,
               _tree_in(docs), n)
    assert got == oracle_digests


@pytest.mark.parametrize("n", SIZES)
def test_map_sharded_matches_oracle_and_single_chip(n):
    docs, oracle_digests = _map_docs(500, 5, 8)
    got = both(ref_shard.replay_map_sharded, replay_map_sharded, docs,
               _map_in(docs), n)
    assert got == oracle_digests
    assert digests(mp.replay_map_batch(_map_in(docs), device="cpu")) \
        == oracle_digests


def test_map_sharded_key_straddling_an_even_row_split():
    """A key whose rows would straddle an even split of the flat op axis
    (the reference's sharding): the port splits on document boundaries,
    so each part's K7 sees every row of its keys and the summaries equal
    the reference's and the one-batch entry's."""
    from fluidframework_tpu.protocol.messages import (MessageType,
                                                      SequencedMessage)

    def msg(seq, contents):
        return SequencedMessage(seq=seq, client_id="c", client_seq=seq,
                                ref_seq=seq - 1, min_seq=0,
                                type=MessageType.OP, contents=contents)

    # doc 0: one key set 40 times; doc 1: a handful of keys
    hot = [msg(s, {"kind": "set", "key": "hot", "value": s})
           for s in range(1, 41)]
    cold = [msg(s, {"kind": "set", "key": f"k{s % 3}", "value": -s})
            for s in range(1, 9)]
    docs = [ref_mp.MapDocInput(doc_id="hot", ops=hot),
            ref_mp.MapDocInput(doc_id="cold", ops=cold,
                               base={"b": 1, "k0": "x"})]
    batch = ref_mp.pack_map_batch(docs, bucket_floor=2)
    half = len(batch.key_gid) // 2
    # the precondition: the even row split cuts through the hot key
    assert batch.key_gid[half - 1] == batch.key_gid[half]
    for n in (2, 3):
        got = both(ref_shard.replay_map_sharded, replay_map_sharded, docs,
                   _map_in(docs), n)
        assert got == digests(ref_mp.replay_map_batch(docs)) == digests(
            mp.replay_map_batch(_map_in(docs), device="cpu"))


@pytest.mark.parametrize("n", SIZES)
def test_matrix_sharded_matches_oracle_and_single_chip(n):
    docs, oracle_digests = _matrix_docs(600, 5, 8)
    got = both(ref_shard.replay_matrix_sharded, replay_matrix_sharded, docs,
               _matrix_in(docs), n)
    assert got == oracle_digests
    assert digests(mk.replay_matrix_batch(_matrix_in(docs), device="cpu")) \
        == oracle_digests


def test_hard_mergetree_semantics_sharded_match_oracle():
    """The graft's hard-semantics documents — deep-lag obliterate
    arrival kill, overlap removers, annotate races, lagged fuzz logs, a
    warm obliterate base — cold and warm, on 3 and 8 parts."""
    from fluidframework_tpu.dds.sequence import SharedString

    docs = graft_entry()._hard_mergetree_docs()
    cold = [d for d in docs if d.base_records is None]
    warm = [d for d in docs if d.base_records is not None]
    assert warm, "hard docs must include a warm obliterate doc"
    oracle = []
    for doc in cold:
        replica = SharedString(doc.doc_id)
        for m in doc.ops:
            replica.process(m, local=False)
        oracle.append(replica.summarize().digest())
    for n in (3, 8):
        assert both(ref_shard.replay_mergetree_sharded,
                    replay_mergetree_sharded, cold, port_docs(cold),
                    n) == oracle
        assert both(ref_shard.replay_mergetree_sharded,
                    replay_mergetree_sharded, warm, port_docs(warm),
                    n) == digests(mt.replay_mergetree_batch(
                        port_docs(warm), device="cpu"))


def test_hard_tree_and_matrix_docs_sharded_match_single():
    mod = graft_entry()
    tree_docs = mod._hard_tree_docs()
    assert any(d.base_summary is not None for d in tree_docs)
    mx_docs = mod._hard_matrix_docs()
    assert any(d.base_summary is not None for d in mx_docs)
    for n in (3, 5):
        assert both(ref_shard.replay_tree_sharded, replay_tree_sharded,
                    tree_docs, _tree_in(tree_docs), n) == digests(
            tk.replay_tree_batch(_tree_in(tree_docs), device="cpu"))
        assert both(ref_shard.replay_matrix_sharded, replay_matrix_sharded,
                    mx_docs, _matrix_in(mx_docs), n) == digests(
            mk.replay_matrix_batch(_matrix_in(mx_docs), device="cpu"))


# -- the cache tiers under a mesh -----------------------------------------------


class MeshTiers(TierPair):
    """A ``TierPair`` whose calls go through both packages' sharded
    entries on ``n`` parts."""

    def __init__(self, n, **kw):
        super().__init__(**kw)
        self.n = n

    def run_sharded(self, ref_docs):
        r_stage, r_stats, p_stage, p_stats = {}, {}, {}, {}
        ref_fn, port_fn, convert = \
            (ref_shard.replay_tree_sharded, replay_tree_sharded, _tree_in) \
            if self.tree else (ref_shard.replay_mergetree_sharded,
                               replay_mergetree_sharded, port_docs)
        ref = ref_fn(ref_docs, mesh=ref_mesh(self.n), stage=r_stage,
                     stats=r_stats, **self.ref)
        got = port_fn(convert(ref_docs), mesh=port_mesh(self.n),
                      stage=p_stage, stats=p_stats, **self.port)
        assert digests(got) == digests(ref)
        assert p_stats == r_stats
        assert set(p_stage) == port_stage_keys(r_stage)
        for key in ("h2d_bytes", "d2h_bytes"):
            assert p_stage[key] == r_stage[key], key
        assert self.tier_stats("port") == self.tier_stats("ref")
        return digests(got), p_stage, p_stats


@pytest.mark.parametrize("n", SIZES)
def test_mesh_fold_serves_the_full_tier_stack(n):
    """Cold, exact and grown passes of the merge-tree family with every
    tier on: equal to the reference's mesh fold call by call (bytes,
    stats, every tier's counters); the exact pass uploads nothing and
    downloads only the padded digest plane; the grown pass splices."""
    s = streams(11, 48)  # not a multiple of 8: exercises pad tokens
    pair = MeshTiers(n, pack=True, delta=True, device=True)
    cold = corpus(s, 40)
    expect = digests(mt.replay_mergetree_batch(port_docs(cold),
                                               device="cpu"))
    assert pair.run_sharded(cold)[0] == expect
    got, stage, stats = pair.run_sharded(cold)
    assert got == expect
    assert stage["h2d_bytes"] == 0
    assert stage["d2h_bytes"] == 8 * (-(-11 // n) * n)
    assert stats.get("delta_docs") == 11
    grown = corpus(s, 40, 48, grown={0, 5})
    got, stage, _ = pair.run_sharded(grown)
    assert got == digests(mt.replay_mergetree_batch(port_docs(grown),
                                                    device="cpu"))
    assert pair.port["device_cache"].stats()["spliced"] == 1


@pytest.mark.parametrize("n", (2, 5))
def test_mesh_tree_tier_stack_parity(n):
    from tests.test_torch_tree_pipeline import _fuzz_docs

    pair = MeshTiers(n, pack=True, delta=True, device=True, tree=True)
    docs = _fuzz_docs(21, n=5)
    oracle = [ref_tk.oracle_fallback_summary(d).digest() for d in docs]
    assert pair.run_sharded(docs)[0] == oracle
    got, stage, _ = pair.run_sharded(docs)
    assert got == oracle
    assert stage["h2d_bytes"] == 0
    assert pair.port["device_cache"].stats()["served"] >= 1
    grown = _fuzz_docs(21, n=5)
    cut = _fuzz_docs(21, n=5, cut=3)
    pair2 = MeshTiers(n, pack=True, delta=True, device=True, tree=True)
    pair2.run_sharded(cut)
    assert pair2.run_sharded(grown)[0] == oracle


def test_mesh_tiers_without_delta_and_tokenless_bypass():
    """Tier 0 off (full downloads every pass) and a token-less chunk
    (tiers 2 / 2.5 bypass, the split upload)."""
    s = streams(6, 40)
    pair = MeshTiers(3, pack=True, delta=False, device=True)
    docs = corpus(s, 32)
    pair.run_sharded(docs)
    pair.run_sharded(docs)
    for d in docs:
        d.cache_token = None
    pair.run_sharded(docs)
    assert pair.port["device_cache"].stats()["bypass"] == 1


def test_placement_change_drops_resident_entries():
    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache

    s = streams(4, 32)
    cache = DevicePackCache(device="cpu")
    replay_mergetree_sharded(port_docs(corpus(s, 24)), mesh=port_mesh(2),
                             device_cache=cache)
    assert cache.stats()["entries"] == 1
    cache.set_sharding(port_mesh(2))  # equal placement: kept
    assert cache.stats()["entries"] == 1
    cache.set_sharding(port_mesh(4))
    assert cache.stats()["entries"] == 0
    assert cache.stats()["evictions"] == 1
    with pytest.raises(ValueError, match="placed on a mesh"):
        from fluidframework_tpu_torch.ops.pipeline import (
            pipelined_mergetree_replay)

        pipelined_mergetree_replay(port_docs(corpus(s, 24)), device="cpu",
                                   device_cache=cache)


def test_parts_split_and_reassemble_in_mesh_order():
    from fluidframework_tpu_torch.ops.parts import bounds, put_parts

    x = np.arange(24, dtype=np.int32).reshape(6, 4)
    placed = put_parts((x, x[:, :1]), [torch.device("cpu")] * 3)
    assert isinstance(placed, Parts) and len(placed) == 3
    assert np.array_equal(np.concatenate([p[0].numpy() for p in placed]), x)
    assert bounds(6, 3) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError):
        bounds(7, 3)


# -- the seam --------------------------------------------------------------------


@pytest.mark.parametrize("n", (2, 3))
def test_catchup_service_on_a_mesh_equals_the_reference(n):
    """``CatchupService(mesh=...)`` on both packages, the mesh chosen on
    purpose: cold, exact and grown calls without tier 1, results,
    stats deltas, counters, stage keys and bytes, and every tier's
    counters equal; the one-device instance gives the same results."""
    ref_service = RefOrdering()
    doc_ids = bench.build_catchup_corpus(ref_service, 7, 14)
    port_service = LocalOrderingService()
    load_service_corpus(port_service, export_corpus(ref_service))
    ref = RefCatchup(ref_service, mesh=ref_mesh(n), cache=None)
    port = CatchupService(port_service, mesh=port_mesh(n), cache=None,
                          device="cpu")
    single = CatchupService(port_service, mesh=None, cache=None,
                            device="cpu")
    for _ in range(2):
        r_stats, p_stats = {}, {}
        want = ref.catch_up(doc_ids, upload=False, stats=r_stats)
        got = port.catch_up(doc_ids, upload=False, stats=p_stats)
        assert got == want
        assert p_stats == r_stats
        assert single.catch_up(doc_ids, upload=False) == want
        assert port.pipeline_stats == ref.pipeline_stats
        assert set(port.pipeline_stage) \
            == port_stage_keys(ref.pipeline_stage) \
            == set(single.pipeline_stage)
        for key in ("h2d_bytes", "d2h_bytes"):
            assert port.pipeline_stage[key] == ref.pipeline_stage[key]
        for name in ("_pack_cache", "delta_cache", "device_cache"):
            assert getattr(port, name).stats() == \
                getattr(ref, name).stats(), name
    assert port.device_cache.mesh == port_mesh(n)
    assert port.device_cache.stats()["served"] >= 1


def test_catchup_service_mixed_types_on_a_mesh():
    """Every kernel family (string, map, matrix, tree) and a host channel
    through the seam's sharded branch, against the reference's."""
    from tests.test_torch_catchup import _reference_mixed_corpus
    import random

    ref_service = RefOrdering()
    doc_ids = _reference_mixed_corpus(ref_service, random.Random(5),
                                      n_docs=3)
    port_service = LocalOrderingService()
    load_service_corpus(port_service, export_corpus(ref_service))
    ref = RefCatchup(ref_service, mesh=ref_mesh(2), cache=None)
    port = CatchupService(port_service, mesh=port_mesh(2), cache=None,
                          device="cpu")
    r_stats, p_stats = {}, {}
    assert port.catch_up(doc_ids, upload=False, stats=p_stats) == \
        ref.catch_up(doc_ids, upload=False, stats=r_stats)
    assert p_stats == r_stats
    assert port.pipeline_stats == ref.pipeline_stats
    assert port.host_channels == ref.host_channels


def test_auto_mesh_is_one_device_without_cards(monkeypatch):
    svc = CatchupService(LocalOrderingService(), device="cpu")
    assert svc._resolve_mesh() is None
    svc = CatchupService(LocalOrderingService(), mesh=port_mesh(2),
                         device="cpu")
    assert svc._resolve_mesh() == port_mesh(2)


def test_tree_step_folds_each_part_like_one_device():
    """``tree_sharded_replay_step``: the edit-fold once a part, the final
    planes equal to the one-device plain fold's rows and the overflow
    flags gathered in order."""
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.parallel import tree_sharded_replay_step
    from fluidframework_tpu_torch.testing.tree_workload import tree_windows

    _base, grown = tree_windows(6, 24)
    state, edits, _meta = tk.pack_tree_batch(grown)
    want = tk.tree_fold_reference(tensors_to(state, "cpu"),
                                  tensors_to(edits, "cpu"))
    mesh = port_mesh(3)
    finals, overflow = tree_sharded_replay_step(mesh)(
        Parts(tensors_to(tk.TreeState(*(x[lo:lo + 2] for x in state)),
                         "cpu") for lo in (0, 2, 4)),
        Parts(tensors_to(tk.TreeEdits(*(x[lo:lo + 2] for x in edits)),
                         "cpu") for lo in (0, 2, 4)))
    for f in tk.TreeState._fields:
        got = torch.cat([getattr(p, f) for p in finals])
        assert torch.equal(got, getattr(want, f)), f
    assert np.array_equal(overflow, want.overflow.numpy())


def test_matrix_sharded_checks_each_parts_violated_facts():
    """A part whose fold counted a violated fact raises, as
    ``replay_matrix_batch`` does, whatever the other parts say."""
    from fluidframework_tpu_torch.parallel import matrix_sharded_replay_step

    docs, _ = _matrix_docs(600, 4, 4)
    mesh = port_mesh(2)
    real = matrix_sharded_replay_step(mesh)

    def bad_second_part(state, ops, cold, S):
        parts = real(state, ops, cold, S)
        final, resolved, viol = parts[1]
        return [parts[0], (final, resolved, torch.ones_like(viol))]

    with pytest.raises(ValueError, match="facts do not hold"):
        replay_matrix_sharded(_matrix_in(docs), mesh=mesh,
                              step=bad_second_part)
