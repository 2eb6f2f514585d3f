"""The hand-written CUDA kernels (the fold's state-out builds in shared
and in device memory, its fold+export and resolving builds, the resident,
tree and map kernels) against the plain PyTorch versions, and the entry
points against the oracles, on the card.  These tests need an NVIDIA GPU (sm_90a) and ``nvcc``; without
a CUDA device they skip.  They import neither JAX nor the JAX package, so
on a machine without JAX they run with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import pytest
import torch

from fluidframework_tpu_torch.convert import tensors_to
from fluidframework_tpu_torch.ops import fold_cuda
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops.pipeline import pipelined_mergetree_replay
from fluidframework_tpu_torch.testing import workload

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _assert_all_equal(want, got):
    """Every slot of every plane (dead slots too), ``n``, ``overflow``, and
    the whole int32 export byte for byte."""
    for f in mt.MTState._fields:
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert torch.equal(mt.export_state(want), mt.export_state(got))


CORPORA = {
    "fixture": workload.hard_docs,
    "bench-64x96": lambda: [workload.synth_doc(i, 96) for i in range(64)],
    # S = 3,072: past the limit of a double-buffered state
    "long-tail-8x1536": lambda: [workload.synth_doc(i, 1536)
                                 for i in range(8)],
    # S = 4,096: past shared memory, folded in device memory
    "large-s-3x2000": lambda: [workload.synth_doc(i, 2000)
                               for i in range(3)],
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_kernel_matches_plain_fold(cuda, corpus):
    docs = CORPORA[corpus]()
    st_np, ops_np, _meta = mt.pack_mergetree_batch(docs)
    state, ops = tensors_to(st_np, cuda), tensors_to(ops_np, cuda)
    where = fold_cuda.placement(st_np.tstart.shape[1], st_np.props.shape[2])
    before = fold_cuda.fold.launches
    before_where = fold_cuda.fold.placements[where]
    got = fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    assert fold_cuda.fold.launches == before + 1
    assert fold_cuda.fold.placements[where] == before_where + 1
    want = mt.fold_reference(state, ops)
    _assert_all_equal(want, got)


def test_entry_point_on_card_matches_oracle(cuda):
    docs = workload.hard_docs() + [workload.synth_doc(i, 48)
                                   for i in range(16)]
    before = fold_cuda.fold_export.launches
    got = mt.replay_mergetree_batch(docs)
    assert fold_cuda.fold_export.launches == before + 1
    want = [workload.oracle_replay(d).summarize().digest() for d in docs]
    assert [s.digest() for s in got] == want


def test_state_too_large_for_shared_memory_folds_in_device_memory(cuda):
    """A state larger than a block's shared memory folds in device memory
    (the shared-memory placement does not take it), bit for bit as the
    plain fold (S = 8,192: ~0.5 MB a document)."""
    ops = mt.MTOps(*[torch.zeros((1, 4), dtype=torch.int32, device=cuda)
                     for _ in range(9)],
                   pvals=torch.full((1, 4, 1), mt.PROP_NOT_TOUCHED,
                                    dtype=torch.int32, device=cuda))
    ops = ops._replace(kind=torch.tensor([[1, 1, 2, 1]], dtype=torch.int32,
                                         device=cuda),
                       seq=torch.tensor([[1, 2, 3, 4]], dtype=torch.int32,
                                        device=cuda),
                       ref_seq=torch.tensor([[0, 1, 2, 3]],
                                            dtype=torch.int32, device=cuda),
                       tlen=torch.tensor([[5, 3, 0, 2]], dtype=torch.int32,
                                         device=cuda),
                       a=torch.tensor([[0, 2, 1, 4]], dtype=torch.int32,
                                      device=cuda),
                       b=torch.tensor([[0, 0, 3, 0]], dtype=torch.int32,
                                      device=cuda))
    state = mt.cold_start(ops, 8192)
    assert fold_cuda.placement(8192, 1) == "gmem"
    before = dict(fold_cuda.fold.placements)
    got = fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    assert fold_cuda.fold.placements == dict(before,
                                             gmem=before["gmem"] + 1)
    _assert_all_equal(mt.fold_reference(state, ops), got)


def _leaves(ex):
    return ex if isinstance(ex, tuple) else (ex,)


def _assert_export_equal(want, got, label):
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (label, i)
        assert torch.equal(w, g), (label, i)


EXPORT_CORPORA = {
    "fixture": workload.hard_docs,
    "obliterate-lagged": lambda: workload.cold_fixture_docs(4),
    "bench-64x96": lambda: [workload.synth_doc(i, 96) for i in range(64)],
    "large-s-2x2000": lambda: [workload.synth_doc(i, 2000)
                               for i in range(2)],
}


@pytest.mark.parametrize("corpus", sorted(EXPORT_CORPORA))
def test_fused_export_matches_plain_in_every_layout(cuda, corpus):
    """The fold+export build against the plain decode → fold → export →
    digest, leaf by leaf (dtype, shape, bytes), in every layout the
    chunk's facts allow, digest on and off, cold (where the chunk has no
    base) and warm."""
    docs = EXPORT_CORPORA[corpus]()
    st_np, ops_np, meta = mt.pack_mergetree_batch(docs)
    S = st_np.tstart.shape[1]
    warmths = ["warm"] if any(d.base_records for d in docs) \
        else ["cold", "warm"]
    base = torch.from_numpy(meta["doc_base"]).to(cuda)
    finals = {}  # the plain decode + fold, once per input encoding

    def plain(state, ops, layout, digest):
        key = (ops.seq.dtype, None if state is None else state.n.dtype)
        if key not in finals:
            wide = mt._widen_ops(ops, base)
            start = mt.cold_start(wide, S) if state is None \
                else mt._widen_state(state, base)
            finals[key] = mt.fold_reference(start, wide)
        return mt.export_final(finals[key], base, layout, digest)

    seen = 0
    for label, m in workload.layout_metas(meta):
        layout = mt._export_flags(m)
        ops = tensors_to(mt.narrow_ops_for_upload(ops_np, m), cuda)
        for warmth in warmths:
            state = None if warmth == "cold" else tensors_to(
                mt.narrow_state_for_upload(st_np, m), cuda)
            for digest in (False, True):
                before = fold_cuda.fold_export.launches
                got = fold_cuda.fold_export(state, ops, base, layout, digest,
                                            S=S)
                torch.cuda.synchronize()
                assert fold_cuda.fold_export.launches == before + 1
                _assert_export_equal(plain(state, ops, layout, digest), got,
                                     (label, warmth, digest))
                seen += 1
    assert seen >= 4


def test_pipeline_on_card_matches_oracle(cuda):
    docs = workload.hard_docs() + [workload.synth_doc(i, 48)
                                   for i in range(40)]
    stage = {}
    before = fold_cuda.fold_export.launches
    got = pipelined_mergetree_replay(docs, chunk_docs=8, stage=stage)
    assert fold_cuda.fold_export.launches > before
    want = [workload.oracle_replay(d).summarize().digest() for d in docs]
    assert [s.digest() for s in got] == want
    assert stage["d2h_bytes"] > 0 and stage["h2d_bytes"] > 0


# ---------------------------------------------------------------------------
# The resident-buffer kernels (csrc/resident.cu) and the warm path
# ---------------------------------------------------------------------------


def _splice_planes(dtype, K, seed, device):
    gen = torch.Generator().manual_seed(seed)
    D, T, L = 7, 40, 12

    def planes(width):
        out = {f: torch.randint(-100, 100, (D, width), generator=gen)
               for f in mt.MTOps._fields if f != "pvals"}
        out["pvals"] = torch.randint(-100, 100, (D, width, K), generator=gen)
        return mt.MTOps(**{f: v.to(dtype).to(device) for f, v in out.items()})

    start = torch.tensor([0, 3, 28, 30, 7, 39, 11], dtype=torch.int32)
    count = torch.tensor([2, 12, 12, 4, 0, 1, 9], dtype=torch.int32)
    return planes(T), planes(L), start.to(device), count.to(device)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_splice_kernel_matches_plain_in_place(cuda, dtype, K):
    from fluidframework_tpu_torch.ops import resident_cuda

    base, rows, start, count = _splice_planes(dtype, K, 5, cuda)
    kernel = mt.MTOps(*(x.clone() for x in base))
    plain = mt.MTOps(*(x.clone() for x in base))
    ptrs = [x.data_ptr() for x in kernel]
    before = resident_cuda.splice_rows.launches
    out = resident_cuda.splice_rows(kernel, rows, start, count)
    torch.cuda.synchronize()
    assert resident_cuda.splice_rows.launches == before + 1
    assert out is kernel and [x.data_ptr() for x in out] == ptrs
    resident_cuda.splice_rows_reference(plain, rows, start, count)
    for f in mt.MTOps._fields:
        assert torch.equal(getattr(kernel, f), getattr(plain, f)), f
    assert not torch.equal(kernel.seq, base.seq)


@pytest.mark.parametrize("what", ["ops", "state"])
def test_widen_kernel_matches_plain(cuda, what):
    from fluidframework_tpu_torch.ops import resident_cuda

    docs = workload.hard_docs() if what == "state" else \
        [workload.synth_doc(i, 48) for i in range(24)]
    st_np, ops_np, meta = mt.pack_mergetree_batch(docs)
    tree = mt.narrow_ops_for_upload(ops_np, meta) if what == "ops" \
        else mt.narrow_state_for_upload(st_np, meta)
    tree = tensors_to(tree, cuda)
    assert mt.upload_encoding(tree), "the corpus did not narrow"
    base = torch.from_numpy(meta["doc_base"]).to(cuda)
    before = resident_cuda.widen_resident.launches
    got = resident_cuda.widen_resident(tree, base)
    torch.cuda.synchronize()
    assert resident_cuda.widen_resident.launches == before + 1
    want = mt._widen_ops(tree, base) if what == "ops" \
        else mt._widen_state(tree, base)
    for f in type(tree)._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f
        assert torch.equal(w, g), f


def test_warm_sequence_on_card_matches_cpu(cuda, monkeypatch):
    """Cold, exact and grown calls with every tier on, on the card and on
    the CPU: the same summaries, byte counters and tier counters, and the
    grown call splices on the card.  The CPU run takes the card's byte
    rule for the delta download (a bucketed gather, not exact rows read
    through a host view), so the d2h counters compare like for like."""
    from fluidframework_tpu_torch.ops import resident_cuda
    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
    from fluidframework_tpu_torch.ops.pipeline import PackCache
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)

    streams = [workload.doc_ops(workload.synth_doc(i, 64))
               for i in range(24)]

    def corpus(grown):
        docs = []
        for i, msgs in enumerate(streams):
            msgs = msgs[:64 if i in grown else 56]
            docs.append(mt.MergeTreeDocInput(
                doc_id=f"d{i}", ops=msgs, final_seq=msgs[-1].seq,
                cache_token=("ep", f"d{i}", 0, "")))
        return docs

    monkeypatch.setattr(mt, "_host_view", lambda a: None)
    runs = {}
    for device in ("cpu", "cuda"):
        tiers = dict(pack_cache=PackCache(), delta_cache=DeltaExportCache(),
                     device_cache=DevicePackCache(device=device))
        calls = []
        resident_cuda.reset_launches()
        for grown in ((), (), (0, 9, 17)):
            stage, stats = {}, {}
            got = pipelined_mergetree_replay(
                corpus(set(grown)), chunk_docs=8, stage=stage, stats=stats,
                device=device, **tiers)
            calls.append(([s.digest() for s in got], stats,
                          stage["h2d_bytes"], stage["d2h_bytes"]))
        runs[device] = (calls, {k: t.stats() for k, t in tiers.items()})
        if device == "cuda":
            assert resident_cuda.splice_rows.launches >= 1
    assert runs["cuda"] == runs["cpu"]
    want = [workload.oracle_replay(d).summarize().digest()
            for d in corpus({0, 9, 17})]
    assert runs["cuda"][0][-1][0] == want


# ---------------------------------------------------------------------------
# The SharedTree edit-fold kernel (csrc/tree_fold.cu) and the tree tiers
# ---------------------------------------------------------------------------


def _tree_corpora():
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing import tree_workload as tw

    out = {f"crafted-{k}": v for k, v in tw.crafted_tree_cases().items()}
    for seed in range(3):
        out[f"random-{seed}"] = tw.random_tree_arrays(seed, 37, 64, 32, 80)
    base, grown = tw.tree_windows(96, 48)
    for name, docs in (("workload-base", base), ("workload-grown", grown)):
        st, ed, _meta = tk.pack_tree_batch(docs)
        out[name] = (st, ed)
    return out


def _tree_counts(state, seed=0):
    """Used-row counts for the digest: from none to past the plane."""
    gen = torch.Generator().manual_seed(seed)
    D, N = state.next.shape
    C = state.head.shape[1]
    n = torch.randint(0, N + 4, (D,), generator=gen, dtype=torch.int32)
    c = torch.randint(0, C + 4, (D,), generator=gen, dtype=torch.int32)
    return n, c


def _assert_tree_equal(want, got):
    for f in type(want)._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f
        assert torch.equal(w, g), f


@pytest.mark.parametrize("where", ["smem", "gmem"])
@pytest.mark.parametrize("build", ["fold", "fold_digest"])
def test_tree_kernel_matches_plain_fold(cuda, build, where, monkeypatch):
    """Both builds, in both placements (device memory forced on these
    small forests), against the plain fold and digest: every plane, padding
    rows included, and the digest, bit for bit; the inputs unwritten."""
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops.tree_pipeline import tree_doc_digests

    monkeypatch.setattr(tree_fold_cuda, "placement", lambda N, C: where)
    entry = getattr(tree_fold_cuda, build)
    for name, (st_np, ed_np) in _tree_corpora().items():
        state, edits = tensors_to(st_np, cuda), tensors_to(ed_np, cuda)
        keep = tk.TreeState(*(x.clone() for x in state))
        n, c = (x.to(cuda) for x in _tree_counts(state))
        before = entry.placements[where]
        if build == "fold":
            got = entry(state, edits)
        else:
            got, dig = entry(state, edits, n, c)
        torch.cuda.synchronize()
        assert entry.placements[where] == before + 1, name
        want = tk.tree_fold_reference(state, edits)
        _assert_tree_equal(want, got)
        _assert_tree_equal(keep, state)
        if build == "fold_digest":
            assert torch.equal(tree_doc_digests(want, n, c), dig), name


@pytest.mark.parametrize("build", ["fold", "fold_digest"])
def test_tree_kernel_counts_no_launch_for_an_empty_chunk(cuda, build):
    """A chunk of no documents on the card launches nothing and leaves the
    entry's counts as they were."""
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    st_np, ed_np = tk.empty_tree_arrays(0, 16, 8, 16)
    state = tensors_to(tk.TreeState(**st_np), cuda)
    edits = tensors_to(tk.TreeEdits(**ed_np), cuda)
    entry = getattr(tree_fold_cuda, build)
    before = (entry.launches, dict(entry.placements))
    if build == "fold":
        got = entry(state, edits)
    else:
        n = torch.zeros((0,), dtype=torch.int32, device=cuda)
        got, dig = entry(state, edits, n, n.clone())
        assert dig.shape == (0, 2)
    assert got.next.shape == (0, 16)
    assert (entry.launches, entry.placements) == before


def test_tree_kernel_flags_the_deep_walk(cuda):
    """The crafted deep chain on the card: a hit inside the 64-step walk
    still overflows, and a target past the walk's reach moves."""
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.testing import tree_workload as tw

    st_np, ed_np = tw.crafted_tree_cases()["deep_chain"]
    got = tree_fold_cuda.fold(tensors_to(st_np, cuda),
                              tensors_to(ed_np, cuda))
    assert got.overflow.tolist() == [True, True]
    assert int(got.node_container[0, 70]) == 69
    assert int(got.node_container[1, 3]) == 75


def test_tree_splice_along_three_axes_matches_plain(cuda):
    """A grown tree chunk through tier 2.5 on the card: the resident
    entry splices its edit, node and container rows in place (three
    ``splice_rows`` launches), each axis equal to ``splice_rows_reference``
    on a copy, and the entry equals the grown chunk's host arrays."""
    from fluidframework_tpu_torch.ops import resident_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_pipeline as tp
    from fluidframework_tpu_torch.testing import tree_workload as tw

    from fluidframework_tpu_torch.protocol.messages import (
        MessageType, SequencedMessage)

    def ins(parent, field, nid):
        return {"kind": "insert", "parent": parent, "field": field,
                "anchor": None,
                "content": [{"id": nid, "type": "n", "value": 1}]}

    # nested inserts in the suffix: new container rows too
    nested = [SequencedMessage(
        seq=s, client_id="c0", client_seq=s, ref_seq=s - 1, min_seq=0,
        type=MessageType.OP, contents={"edits": [e]}) for s, e in enumerate(
            [ins("", "a", "x"), ins("", "a", "y"), ins("x", "k", "z"),
             ins("y", "j", "w")], 1)]
    base, grown = tw.tree_windows(24, 48, grow_every=2)
    base = [d for d in base if not tk.known_tree_fallback(d)] \
        + [tw.tree_doc(99, nested, 2)]
    grown = [d for d in grown if not tk.known_tree_fallback(d)] \
        + [tw.tree_doc(99, nested, 4)]
    pack = tp.tree_pack_cache()
    cache = tp.tree_device_cache(device=cuda)
    st0, ed0, meta0 = pack.pack(base)
    cache.acquire(st0, ed0, meta0)
    (entry,) = cache._entries.values()
    before = {g: tuple(x.clone() for x in planes) for g, planes in (
        ("edits", entry.ops),
        ("node", tp._group(tp._TreeNodePlanes, entry.state)),
        ("cont", tp._group(tp._TreeContPlanes, entry.state)))}
    st1, ed1, meta1 = pack.pack(grown)
    assert meta1["_pack_lineage"][0] == "suffix"
    assert (meta1["n_cont"] > meta0["n_cont"]).any()
    resident_cuda.reset_launches()
    _s, _e, aux, up = cache.acquire(st1, ed1, meta1)
    torch.cuda.synchronize()
    assert cache.stats()["spliced"] == 1
    assert resident_cuda.splice_rows.launches == 3
    assert up < sum(x.nbytes for x in st1) + sum(x.nbytes for x in ed1)
    for group, host, old, new, planes in (
            ("edits", ed1, tp.TreeDeviceOps.t_rows(ed0),
             tp.TreeDeviceOps.t_rows(ed1), tk.TreeEdits),
            ("node", tp._group(tp._TreeNodePlanes, st1), meta0["n_nodes"],
             meta1["n_nodes"], tp._TreeNodePlanes),
            ("cont", tp._group(tp._TreeContPlanes, st1), meta0["n_cont"],
             meta1["n_cont"], tp._TreeContPlanes)):
        from fluidframework_tpu_torch.ops.device_cache import (
            gather_suffix_rows)

        rows_np, _L = gather_suffix_rows(planes, host, old, new)
        rows = planes(**{f: torch.from_numpy(v).to(cuda)
                         for f, v in rows_np.items()})
        start = torch.from_numpy(old).to(cuda)
        count = torch.from_numpy(new - old).to(cuda)
        kernel = planes(*(x.clone() for x in before[group]))
        plain = planes(*(x.clone() for x in before[group]))
        resident_cuda.splice_rows(kernel, rows, start, count)
        resident_cuda.splice_rows_reference(plain, rows, start, count)
        _assert_tree_equal(plain, kernel)
        _assert_tree_equal(planes(*(torch.from_numpy(
            np_.copy()).to(cuda) for np_ in host)), kernel)
    _assert_tree_equal(tensors_to(ed1, cuda), entry.ops)
    _assert_tree_equal(tensors_to(st1, cuda), entry.state)
    assert [x.tolist() for x in aux] == \
        [meta1["n_nodes"].tolist(), meta1["n_cont"].tolist()]


def test_tree_warm_sequence_on_card_matches_cpu(cuda, monkeypatch):
    """Cold, exact and grown tree calls with every tier on, on the card
    and on the CPU (the CPU with the card's delta byte rule): the same
    summaries, byte counters and tier counters, the kernel and the splice
    launched on the card, and the grown call equal to the oracle."""
    from fluidframework_tpu_torch.ops import resident_cuda, tree_fold_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_pipeline as tp
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import tree_workload as tw

    base, grown = tw.tree_windows(40, 48)
    monkeypatch.setattr(mt, "_host_view", lambda a: None)
    runs = {}
    for device in ("cpu", "cuda"):
        tiers = dict(pack_cache=tp.tree_pack_cache(),
                     delta_cache=DeltaExportCache(),
                     device_cache=tp.tree_device_cache(device=device))
        calls = []
        resident_cuda.reset_launches()
        tree_fold_cuda.reset_launches()
        for docs in (base, base, grown):
            stage, stats = {}, {}
            got = tp.pipelined_tree_replay(
                docs, chunk_docs=16, stage=stage, stats=stats,
                device=device, **tiers)
            calls.append(([s.digest() for s in got], stats,
                          stage["h2d_bytes"], stage["d2h_bytes"]))
        runs[device] = (calls, {k: t.stats() for k, t in tiers.items()})
        if device == "cuda":
            assert tree_fold_cuda.fold_digest.launches >= 3
            assert resident_cuda.splice_rows.launches >= 1
    assert runs["cuda"] == runs["cpu"]
    assert runs["cuda"][0][-1][0] == [
        tk.oracle_fallback_summary(d).digest() for d in grown]
    got = tk.replay_tree_batch(grown)
    assert [s.digest() for s in got] == runs["cuda"][0][-1][0]


# ---------------------------------------------------------------------------
# The SharedMap reduction (csrc/map_lww.cu) and the matrix axis fold with
# resolution (the resolving build of csrc/mergetree_fold.cu)
# ---------------------------------------------------------------------------


def _map_corpora():
    from fluidframework_tpu_torch.testing import config_workloads as cw

    out = {f"crafted-{c}": (lambda c=c: cw.crafted_map_docs(c))
           for c in cw.CRAFTED_MAP}
    out["fixture"] = cw.hard_map_docs
    out["workload-256x96"] = lambda: [cw.gen_map_doc(i, 96)
                                      for i in range(256)]
    return out


def _matrix_corpora():
    from fluidframework_tpu_torch.testing import config_workloads as cw

    out = {f"crafted-{c}": (lambda c=c: [cw.crafted_matrix_doc(c)])
           for c in cw.CRAFTED_MATRIX}
    out["fixture"] = cw.hard_matrix_docs
    out["workload-64x64"] = lambda: [cw.gen_matrix_doc(i, 64)
                                     for i in range(64)]
    return out


@pytest.mark.parametrize("corpus", sorted(_map_corpora()))
def test_map_lww_kernel_matches_plain_on_every_key(cuda, corpus):
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda

    batch = mp.pack_map_batch(_map_corpora()[corpus]())
    inputs = mp.lww_inputs(batch, cuda)
    before = map_lww_cuda.lww.launches
    got_present, got_val = map_lww_cuda.lww(inputs, batch.num_docs)
    torch.cuda.synchronize()
    assert map_lww_cuda.lww.launches == before + 1
    want_present, want_val = mp.map_lww_reference(inputs, batch.num_docs)
    assert got_present.dtype == torch.bool and got_val.dtype == torch.int32
    assert torch.equal(want_present, got_present)
    assert torch.equal(want_val, got_val)


def test_map_lww_kernel_counts_no_launch_for_no_keys(cuda):
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda

    empty = mp.LWWInputs(*[torch.zeros(n, dtype=torch.int32, device=cuda)
                           for n in (64, 64, 64, 64, 0, 64, 64)])
    before = map_lww_cuda.lww.launches
    present, win_val = map_lww_cuda.lww(empty, 1)
    assert present.shape == win_val.shape == (0,)
    assert mp.replay_map_batch([]) == []
    assert map_lww_cuda.lww.launches == before


def test_map_entry_point_on_card_matches_oracle(cuda):
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = cw.hard_map_docs() + cw.crafted_map_docs("mixed") + \
        [cw.gen_map_doc(i, 96) for i in range(64)]
    before = map_lww_cuda.lww.launches
    stats = {}
    got = mp.replay_map_batch(docs, stats=stats)
    assert map_lww_cuda.lww.launches == before + 1
    assert stats == {"device_docs": len(docs)}
    assert [s.digest() for s in got] == \
        [mp.oracle_map_summary(d).digest() for d in docs]


@pytest.mark.parametrize("where", ["smem", "gmem"])
@pytest.mark.parametrize("corpus", sorted(_matrix_corpora()))
def test_resolving_kernel_matches_plain(cuda, monkeypatch, corpus, where):
    """Both placements of the resolving build against the plain
    ``replay_scan_resolving``: every plane, ``n``, ``overflow`` and every
    resolved handle (padding rows included); device memory forced by
    patching ``placement``."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mk

    docs = [d for d in _matrix_corpora()[corpus]()
            if not mk.known_matrix_fallback(d)]
    st_np, ops_np, _meta = mk.pack_matrix_batch(docs)
    state, ops = tensors_to(st_np, cuda), tensors_to(ops_np, cuda)
    monkeypatch.setattr(fold_cuda, "placement", lambda S, K, lib=None: where)
    before = dict(fold_cuda.fold_resolving.placements)
    got, got_resolved = fold_cuda.fold_resolving(state, ops)
    torch.cuda.synchronize()
    assert fold_cuda.fold_resolving.placements == dict(
        before, **{where: before[where] + 1})
    want, want_resolved = mk.replay_scan_resolving(state, ops)
    _assert_all_equal(want, got)
    assert torch.equal(want_resolved, got_resolved)


def test_resolving_kernel_skips_a_zero_width_slot_that_ends_a_chunk(cuda):
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    st_np, ops_np, _m = mk.pack_matrix_batch(
        [cw.crafted_matrix_doc("zero-width-chunk-end")])
    _final, resolved = fold_cuda.fold_resolving(tensors_to(st_np, cuda),
                                                tensors_to(ops_np, cuda))
    rows = resolved[0][torch.from_numpy(ops_np.kind[0]).to(cuda)
                       == mk.K_RESOLVE]
    assert rows.tolist() == [32, 31, -1]


def test_resolving_kernel_counts_no_launch_for_an_empty_batch(cuda):
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    st_np, ops_np, _m = mk.pack_matrix_batch([cw.gen_matrix_doc(0, 8)])
    state = mt.MTState(*(x[:0] for x in tensors_to(st_np, cuda)))
    ops = mt.MTOps(*(x[:0] for x in tensors_to(ops_np, cuda)))
    before = (fold_cuda.fold_resolving.launches,
              dict(fold_cuda.fold_resolving.placements))
    final, resolved = fold_cuda.fold_resolving(state, ops)
    assert final.tstart.shape[0] == 0 and resolved.shape[0] == 0
    assert (fold_cuda.fold_resolving.launches,
            fold_cuda.fold_resolving.placements) == before


def test_matrix_entry_point_on_card_matches_oracle(cuda):
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = cw.hard_matrix_docs() + [cw.crafted_matrix_doc(c)
                                    for c in cw.CRAFTED_MATRIX] + \
        [cw.gen_matrix_doc(i, 64) for i in range(64)]
    before = fold_cuda.fold_resolving.launches
    stats = {}
    got = mk.replay_matrix_batch(docs, stats=stats)
    assert fold_cuda.fold_resolving.launches == before + 1
    assert stats == {"device_docs": len(docs) - 2, "fallback_docs": 2}
    assert [s.digest() for s in got] == \
        [mk.oracle_matrix_fallback(d).digest() for d in docs]
