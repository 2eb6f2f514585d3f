"""The hand-written CUDA kernels (the fold's state-out builds in shared
and in device memory, its fold+export builds, the resident, tree, map and
matrix kernels) against the plain PyTorch versions, and the entry points
against the oracles, on the card.  These tests need an NVIDIA GPU (sm_90a) and ``nvcc``; without
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


def _tree_block_corpora():
    """Tree planes for the launch shapes: the crafted NIL cases (T not a
    multiple of 4: plain copies), 37 random forests whose rows are whole
    16-byte units over two edit tiles (bulk copies), 37 whose rows are
    not (N = 30, C = 10, T = 45: plain copies, two tiles), 37 with values
    far outside their planes, and 3 with no edit rows (T = 0)."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing import tree_workload as tw

    out = {f"crafted-{k}": v for k, v in tw.crafted_tree_cases().items()}
    out["random-bulk"] = tw.random_tree_arrays(11, 37, 64, 32, 80)
    out["random-plain"] = tw.random_tree_arrays(12, 37, 30, 10, 45)
    out["wild"] = tw.wild_tree_arrays(13, 37, 64, 32, 80)
    st, ed = tk.empty_tree_arrays(3, 16, 8, 0)
    out["no-edits"] = (tk.TreeState(**st), tk.TreeEdits(**ed))
    return out


def _fold_and_compare(cuda, build, st_np, ed_np, **kw):
    """One launch of ``build`` on the card against the plain fold (and
    digest): every plane with its padding rows, bit for bit."""
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops.tree_pipeline import tree_doc_digests

    state, edits = tensors_to(st_np, cuda), tensors_to(ed_np, cuda)
    entry = getattr(tree_fold_cuda, build)
    before = entry.launches
    if build == "fold":
        got = entry(state, edits, **kw)
    else:
        n, c = (x.to(cuda) for x in _tree_counts(state))
        got, dig = entry(state, edits, n, c, **kw)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    want = tk.tree_fold_reference(state, edits)
    _assert_tree_equal(want, got)
    if build == "fold_digest":
        assert torch.equal(tree_doc_digests(want, n, c), dig)


@pytest.mark.parametrize("build", ["fold", "fold_digest"])
def test_tree_kernel_matches_plain_on_every_copy_path(cuda, build):
    """One document a block, 37 documents, on bulk-copied and plainly
    copied rows, the crafted NIL cases, values far outside their planes
    and no edit rows: the kernel equals the plain fold and digest."""
    for name, (st_np, ed_np) in _tree_block_corpora().items():
        _fold_and_compare(cuda, build, st_np, ed_np)


@pytest.mark.parametrize("build", ["fold", "fold_digest"])
def test_tree_kernel_folds_at_the_shared_memory_edge(cuda, build):
    """Forests at each edge of the placements, 3 documents each, against
    the plain fold: the largest full layout (N = 6,268, C = 64), the lean
    layout just past it (64 rows a tile), a chunk of bucket shape in the
    lean layout (N = 8,192, C = 256: 8 rows a tile, bulk copies, eight
    tiles; also with values far outside the planes), the largest lean
    forest (N = 8,266: 4 rows a tile), and the next size up in device
    memory."""
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.testing import tree_workload as tw

    entry = getattr(tree_fold_cuda, build)
    for N, C, T, layout in ((6268, 64, 16, (64, True)),
                            (6272, 64, 16, (64, False)),
                            (8192, 256, 64, (8, False)),
                            (8266, 64, 16, (4, False)),
                            (8267, 64, 16, None)):
        assert tree_fold_cuda.smem_layout(N, C) == layout
        where = "smem" if layout else "gmem"
        before = entry.placements[where]
        _fold_and_compare(cuda, build, *tw.random_tree_arrays(N, 3, N, C,
                                                              T))
        assert entry.placements[where] == before + 1
    _fold_and_compare(cuda, build, *tw.wild_tree_arrays(8192, 3, 8192, 256,
                                                        64))


class _RefusingLibrary:
    """A kernel library whose every C entry reports a CUDA error."""

    @staticmethod
    def tree_fold(*args):
        return 98  # cudaErrorInvalidDeviceFunction

    @staticmethod
    def map_lww(*args):
        return 98


class _TwoABlock:
    """The kernel's library asked for two documents a block, which its C
    entry does not take."""

    def __init__(self, lib):
        self.lib = lib

    def tree_fold(self, ptrs, D, N, C, T, gmem, docs_per_block, stream):
        return self.lib.tree_fold(ptrs, D, N, C, T, gmem, 2, stream)


def test_kernels_raise_and_never_fall_back_on_the_card(cuda):
    """On CUDA tensors a refused launch raises (a library that reports an
    error, a documents-a-block value the source does not take) and counts
    nothing: no wrapper returns the plain version instead."""
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda, tree_fold_cuda
    from fluidframework_tpu_torch.testing import config_workloads as cw
    from fluidframework_tpu_torch.testing import tree_workload as tw

    st_np, ed_np = tw.random_tree_arrays(5, 9, 16, 8, 16)
    state, edits = tensors_to(st_np, cuda), tensors_to(ed_np, cuda)
    n, c = (x.to(cuda) for x in _tree_counts(state))
    for build in ("fold", "fold_digest"):
        entry = getattr(tree_fold_cuda, build)
        args = (state, edits) if build == "fold" else (state, edits, n, c)
        before = entry.launches
        with pytest.raises(RuntimeError, match="tree_fold launch failed"):
            entry(*args, lib=_RefusingLibrary())
        with pytest.raises(RuntimeError, match="tree_fold launch failed"):
            entry(*args, lib=_TwoABlock(tree_fold_cuda._library()))
        assert entry.launches == before
    batch = mp.pack_map_batch(cw.crafted_map_docs("mixed"))
    inputs = mp.lww_inputs(batch, cuda)
    before = map_lww_cuda.lww.launches
    with pytest.raises(RuntimeError, match="map_lww launch failed"):
        map_lww_cuda.lww(inputs, batch.num_docs, lib=_RefusingLibrary())
    assert map_lww_cuda.lww.launches == before


def test_tree_splice_along_three_axes_matches_plain(cuda):
    """A grown tree chunk through tier 2.5 on the card: the resident
    entry splices its edit, node and container rows in place (one
    ``splice_row_groups`` launch for the three axes), each axis equal to
    ``splice_rows_reference`` on a copy, and the entry equals the grown
    chunk's host arrays."""
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
    assert resident_cuda.splice_rows.launches == 1  # the axes in one launch
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
# The SharedMap reduction (csrc/map_lww.cu) and the matrix entry point
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


@pytest.mark.parametrize("seed", range(4))
def test_map_lww_kernel_matches_plain_on_adversarial_inputs(cuda, seed):
    """Inputs no packer emits (``adversarial_lww_inputs``: shuffled rows,
    a key of thousands of rows spread over many warps, payloads below -1
    beside losers, ids out of range, negative ``key_doc``, ties at
    INT32_MIN): the kernel equals the plain reduction on every key."""
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda
    from fluidframework_tpu_torch.testing import config_workloads as cw

    x, docs = cw.adversarial_lww_inputs(seed)
    inputs = mp.LWWInputs(*(torch.from_numpy(a).to(cuda) for a in x))
    got_present, got_val = map_lww_cuda.lww(inputs, docs)
    want_present, want_val = mp.map_lww_reference(inputs, docs)
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


def test_matrix_entry_point_on_card_matches_oracle(cuda):
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    from fluidframework_tpu_torch.ops import matrix_fold_cuda

    docs = cw.hard_matrix_docs() + [cw.crafted_matrix_doc(c)
                                    for c in cw.CRAFTED_MATRIX] + \
        [cw.gen_matrix_doc(i, 64) for i in range(64)]
    before = matrix_fold_cuda.fold_resolving.launches
    stats = {}
    got = mk.replay_matrix_batch(docs, stats=stats)
    assert matrix_fold_cuda.fold_resolving.launches == before + 1
    assert stats == {"device_docs": len(docs) - 2, "fallback_docs": 2}
    assert [s.digest() for s in got] == \
        [mk.oracle_matrix_fallback(d).digest() for d in docs]


@pytest.mark.parametrize("form", ["records", "messages"])
def test_matrix_pipeline_on_card_matches_oracle(cuda, form):
    """The matrix family through the pipeline on the card: two chunks, a
    sliced native pack (records), the writer and the Python route, the
    fixture's fallbacks; the same summaries and counts as on the CPU."""
    import dataclasses

    from fluidframework_tpu_torch.ops import matrix_fold_cuda
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.ops import matrix_native as mn
    from fluidframework_tpu_torch.ops.matrix_pipeline import \
        pipelined_matrix_replay
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = [cw.gen_matrix_doc(i, 300) for i in range(260)] \
        + cw.hard_matrix_docs()
    if form == "records":
        docs = [dataclasses.replace(d, ops=[],
                                    records=mn.encode_matrix_ops(d.ops))
                if d.base_summary is None else d for d in docs]
    runs = {}
    for device in ("cpu", cuda):
        stats, stage = {}, {}
        before = matrix_fold_cuda.fold_resolving.launches
        got = pipelined_matrix_replay(docs, chunk_docs=256, stats=stats,
                                      stage=stage, device=device)
        launches = matrix_fold_cuda.fold_resolving.launches - before
        runs[str(device)] = ([s.digest() for s in got], stats,
                             {k: stage[k] for k in (
                                 "extract_native_docs", "extract_cells",
                                 "resolve_rows", "pack_tasks")}, launches)
    cpu, card = runs["cpu"], runs[str(cuda)]
    assert card[:3] == cpu[:3] and card[3] == 2 and cpu[3] == 0
    assert card[0] == [mk.oracle_matrix_fallback(d).digest() for d in docs]
    assert card[1]["fallback_docs"] == 2


# ---------------------------------------------------------------------------
# The matrix fold (csrc/matrix_fold.cu) and the resident kernels' edges
# ---------------------------------------------------------------------------


def _assert_matrix_equal(want, want_resolved, got, got_resolved):
    for f in mt.MTState._fields:
        assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert torch.equal(want_resolved, got_resolved)


def _matrix_batches():
    from fluidframework_tpu_torch.testing import config_workloads as cw

    out = _matrix_corpora()
    # S = 4,096: the block a stream, in shared memory
    out["large-s-2x2048"] = lambda: [cw.gen_matrix_doc(i, 2048)
                                     for i in range(2)]
    return out


#: (corpus, warmth): every corpus warm, and cold where no document has a
#: base summary (the fixture has some)
_MATRIX_FOLDS = [(c, w) for c in sorted(_matrix_batches())
                 for w in (("warm",) if c == "fixture" else ("cold", "warm"))]


@pytest.mark.parametrize("corpus,warmth", _MATRIX_FOLDS)
def test_matrix_fold_kernel_matches_plain(cuda, corpus, warmth):
    """K4 against the plain ``replay_scan_resolving``: every plane, ``n``,
    ``overflow`` and resolved handle, padding rows included, cold (no
    state read) where the batch is, and warm; one launch, no fact
    violated."""
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk

    docs = [d for d in _matrix_batches()[corpus]()
            if not mk.known_matrix_fallback(d)]
    st_np, ops_np, meta = mk.pack_matrix_batch(docs)
    assert meta["cold"] or warmth == "warm"
    state, ops = tensors_to(st_np, cuda), tensors_to(ops_np, cuda)
    S = st_np.tstart.shape[1]
    assert mf.placement(S) == "smem"
    before = mf.fold_resolving.placements["smem"]
    got, got_resolved, violations = mf.fold_resolving(
        None if warmth == "cold" else state, ops, cold=warmth == "cold",
        S=S)
    torch.cuda.synchronize()
    assert mf.fold_resolving.placements["smem"] == before + 1
    assert not violations.any()
    want, want_resolved = mk.replay_scan_resolving(state, ops)
    _assert_matrix_equal(want, want_resolved, got, got_resolved)


def test_matrix_fold_kernel_in_device_memory(cuda):
    """A stream too large for a block's shared memory (S = 8,192) folds in
    device memory, bit for bit as the plain fold, cold and warm."""
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    st_np, ops_np, _m = mk.pack_matrix_batch(
        [cw.gen_matrix_doc(i, 40) for i in range(3)])
    S = 8192
    state = mk.matrix_fill_state(st_np.tstart.shape[0], S, cuda)
    ops = tensors_to(ops_np, cuda)
    assert mf.placement(S) == "gmem"
    want, want_resolved = mk.replay_scan_resolving(state, ops)
    for cold in (True, False):
        before = mf.fold_resolving.placements["gmem"]
        got, got_resolved, violations = mf.fold_resolving(
            None if cold else state, ops, cold=cold, S=S)
        torch.cuda.synchronize()
        assert mf.fold_resolving.placements["gmem"] == before + 1
        assert not violations.any()
        _assert_matrix_equal(want, want_resolved, got, got_resolved)


def test_matrix_fold_kernel_skips_a_zero_width_slot_that_ends_a_chunk(cuda):
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    st_np, ops_np, _m = mk.pack_matrix_batch(
        [cw.crafted_matrix_doc("zero-width-chunk-end")])
    _final, resolved, _v = mf.fold_resolving(
        None, tensors_to(ops_np, cuda), cold=True, S=st_np.tstart.shape[1])
    rows = resolved[0][torch.from_numpy(ops_np.kind[0]).to(cuda)
                       == mk.K_RESOLVE]
    assert rows.tolist() == [32, 31, -1]


@pytest.mark.parametrize("fact", ["obliterate-row", "annotate-row",
                                  "props-write", "ob-stamp"])
def test_matrix_fold_kernel_counts_a_violated_fact(cuda, fact):
    """A row of another kind, a props write or an obliterate stamp on a
    live slot is counted on its stream, and ``check_facts`` raises."""
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = [d for d in cw.hard_matrix_docs()
            if not mk.known_matrix_fallback(d)]
    st_np, ops_np, _m = mk.pack_matrix_batch(docs)
    state, ops = tensors_to(st_np, cuda), tensors_to(ops_np, cuda)
    live = int(torch.nonzero(state.n)[0, 0])
    if fact.endswith("-row"):
        kind = ops.kind.clone()
        kind[live, 0] = 4 if fact == "obliterate-row" else 3
        ops = ops._replace(kind=kind)
    elif fact == "props-write":
        pvals = ops.pvals.clone()
        pvals[live, 0, 0] = 0
        ops = ops._replace(pvals=pvals)
    else:
        stamped = state.ob2_client.clone()
        stamped[live, 0] = 1
        state = state._replace(ob2_client=stamped)
    _f, _r, violations = mf.fold_resolving(state, ops)
    assert int(violations[live]) >= 1
    with pytest.raises(ValueError, match="facts do not hold"):
        mf.check_facts(violations)


def test_matrix_fold_kernel_counts_no_launch_for_an_empty_batch(cuda):
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    _s, ops_np, _m = mk.pack_matrix_batch([cw.gen_matrix_doc(0, 8)])
    ops = mt.MTOps(*(x[:0] for x in tensors_to(ops_np, cuda)))
    before = mf.fold_resolving.launches
    final, resolved, violations = mf.fold_resolving(None, ops, cold=True,
                                                    S=32)
    assert final.tstart.shape == (0, 32) and resolved.shape[0] == 0
    assert violations.shape == (0,)
    assert mf.fold_resolving.launches == before


def _splice_edge_planes(dtype, K, T, L, device, seed=11):
    gen = torch.Generator().manual_seed(seed)
    D = 9

    def planes(width):
        out = {f: torch.randint(-100, 100, (D, width), generator=gen)
               for f in mt.MTOps._fields if f != "pvals"}
        out["pvals"] = torch.randint(-100, 100, (D, width, K), generator=gen)
        return mt.MTOps(**{f: v.to(dtype).to(device) for f, v in out.items()})

    # count 0 and L; starts near T (rows past T dropped), at 0, odd
    start = torch.tensor([0, 1, T - 1, T - 2, 3, T - L, 5, 0, T],
                         dtype=torch.int32)
    count = torch.tensor([0, L, L, 3, 1, L, 0, 2, L], dtype=torch.int32)
    return planes(T), planes(L), start.to(device), count.to(device)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("T", [37, 40])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_splice_kernel_edges_match_plain(cuda, dtype, T, K):
    """The splice at ``count`` 0 and L, ``start`` near T, odd K and odd T
    (rows at every byte offset, so the vector width and the edges vary),
    on int8, int16 and int32 planes: equal to the plain version, in
    place."""
    from fluidframework_tpu_torch.ops import resident_cuda

    base, rows, start, count = _splice_edge_planes(dtype, K, T, 7, cuda)
    kernel, plain = (mt.MTOps(*(x.clone() for x in base)) for _ in range(2))
    resident_cuda.splice_rows(kernel, rows, start, count)
    resident_cuda.splice_rows_reference(plain, rows, start, count)
    torch.cuda.synchronize()
    for f in mt.MTOps._fields:
        assert torch.equal(getattr(kernel, f), getattr(plain, f)), f
    assert not torch.equal(kernel.seq, base.seq)


def test_splice_row_groups_is_one_launch_equal_to_plain(cuda):
    """Three row groups of different widths, dtypes and counts in one
    launch, each equal to its plain splice."""
    from fluidframework_tpu_torch.ops import resident_cuda

    groups, plains = [], []
    for i, (dtype, K, T, L) in enumerate([(torch.int32, 1, 48, 8),
                                          (torch.int16, 3, 37, 5),
                                          (torch.int8, 1, 21, 7)]):
        base, rows, start, count = _splice_edge_planes(dtype, K, T, L, cuda,
                                                       seed=i)
        start = start.clamp(max=T)
        groups.append((mt.MTOps(*(x.clone() for x in base)), rows, start,
                       count))
        plains.append(resident_cuda.splice_rows_reference(
            mt.MTOps(*(x.clone() for x in base)), rows, start, count))
    before = resident_cuda.splice_rows.launches
    resident_cuda.splice_row_groups(groups)
    torch.cuda.synchronize()
    assert resident_cuda.splice_rows.launches == before + 1
    for (got, *_rest), want in zip(groups, plains):
        for f in mt.MTOps._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("T", [36, 37])
def test_widen_kernel_odd_widths_match_plain(cuda, T):
    """The migration of hand-built narrow ops whose rows are and are not a
    multiple of 4 elements (the vector and the scalar path), insert rows
    rebased, others zeroed: equal to the plain decode."""
    from fluidframework_tpu_torch.ops import resident_cuda

    gen = torch.Generator().manual_seed(3)
    D = 5
    narrow = {f: torch.randint(-3000, 3000, (D, T), generator=gen)
              .to(dt) for f, dt in mt._UPLOAD_NARROW_TORCH[mt.MTOps].items()
              if f != "pvals"}
    narrow["kind"] = torch.randint(0, 5, (D, T), generator=gen).to(torch.int8)
    narrow["client"] = torch.randint(-1, 9, (D, T), generator=gen).to(
        torch.int8)
    narrow["pvals"] = torch.randint(-2, 50, (D, T, 2), generator=gen).to(
        torch.int16)
    ops = mt.MTOps(**{f: narrow[f].to(cuda) for f in mt.MTOps._fields})
    assert mt.upload_encoding(ops)
    base = torch.tensor([0, 7, -5, 2 ** 31 - 10, 100], dtype=torch.int32,
                        device=cuda)
    got = resident_cuda.widen_resident(ops, base)
    want = mt._widen_ops(ops, base)
    torch.cuda.synchronize()
    for f in mt.MTOps._fields:
        assert torch.equal(getattr(want, f), getattr(got, f)), f


@pytest.mark.parametrize("corpus", ["mixed", "attribution"])
def test_catchup_service_on_card_equals_cpu(cuda, corpus):
    """The catch-up seam on the card: mixed five-channel documents (a cold
    and a warm round) or attribution documents whose window clamps their
    inserts, through ``CatchupService`` on ``cuda`` and on ``cpu`` over
    the same store and log: equal results and stats deltas, every kernel
    family of the corpus launched."""
    import random

    from fluidframework_tpu_torch.ops import (map_lww_cuda,
                                              matrix_fold_cuda,
                                              tree_fold_cuda)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.testing import service_workload as sw

    service = LocalOrderingService()
    rng = random.Random("mixed")
    if corpus == "mixed":
        runtimes = sw.build_mixed_corpus(service, 6, rng)
    else:
        sw.build_catchup_corpus(service, 12, 48, attribution=True)
    card = CatchupService(service, device=cuda)
    cpu = CatchupService(service, device="cpu")
    for rnd in range(2 if corpus == "mixed" else 1):
        if rnd:
            for rts in runtimes.values():
                sw.drive_mixed_doc(rts, rng, rounds=6)
        fold_cuda.reset_launches()
        map_lww_cuda.reset_launches()
        matrix_fold_cuda.reset_launches()
        tree_fold_cuda.reset_launches()
        c_stats, p_stats = {}, {}
        want = cpu.catch_up(stats=c_stats, upload=False)
        got = card.catch_up(stats=p_stats, upload=False)
        assert got == want and p_stats == c_stats
        assert p_stats["cpuDocs"] == 0
        assert fold_cuda.fold_export.launches >= 1
        if corpus == "mixed":
            assert map_lww_cuda.lww.launches == 1
            assert matrix_fold_cuda.fold_resolving.launches == 1
            assert tree_fold_cuda.fold_digest.launches >= 1
            assert p_stats["hostChannels"] > 0
        for doc_id, (handle, _seq) in got.items():
            assert handle == sw.catchup_oracle_digest(service, doc_id)


def test_server_catchup_rpc_on_card_equals_cpu_fold(cuda):
    """The port's TCP server on the card: an in-thread ``OrderingServer``
    with ``device="cuda"``, one ``catchup`` RPC over TCP through the
    port's network driver for a mixed corpus and a string corpus, every
    kernel family launched, every answer equal to the CPU container
    fold."""
    import random

    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkDocumentServiceFactory)
    from fluidframework_tpu_torch.ops import (map_lww_cuda,
                                              matrix_fold_cuda,
                                              tree_fold_cuda)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.server import OrderingServer
    from fluidframework_tpu_torch.testing import service_workload as sw

    service = LocalOrderingService()
    sw.build_mixed_corpus(service, 4, random.Random("server"))
    sw.build_catchup_corpus(service, 16, 48)
    want = {d: sw.catchup_oracle_digest(service, d)
            for d in service.doc_ids()}
    server = OrderingServer(service, device=cuda)
    thread = server.start_in_thread()
    factory = NetworkDocumentServiceFactory(port=server.port)
    try:
        for reset in (fold_cuda.reset_launches, map_lww_cuda.reset_launches,
                      matrix_fold_cuda.reset_launches,
                      tree_fold_cuda.reset_launches):
            reset()
        out = factory._rpc.request("catchup", {})
        assert out["lane"] == "fold"
        assert out["deviceDocs"] == len(want) and out["cpuDocs"] == 0
        assert fold_cuda.fold_export.launches >= 1
        assert map_lww_cuda.lww.launches == 1
        assert matrix_fold_cuda.fold_resolving.launches == 1
        assert tree_fold_cuda.fold_digest.launches >= 1
        for doc_id, (handle, seq) in out["docs"].items():
            assert seq == service.oplog.head(doc_id)
            assert service.storage.read(handle).digest() == want[doc_id]
    finally:
        factory.close()
        server.loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=10)


# -- the doc-sharded fold on a device list that names the card twice ------------


def _mesh2():
    from fluidframework_tpu_torch.parallel import doc_mesh

    return doc_mesh(["cuda:0", "cuda:0"])


def test_sharded_entries_on_a_repeated_card_equal_one_device(cuda):
    """``["cuda:0"] * 2`` splits every batch into two parts folded one
    after the other on the card: each family's sharded entry equals its
    one-device entry, with one launch of its kernel a part."""
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.ops import (map_lww_cuda,
                                              matrix_fold_cuda,
                                              tree_fold_cuda)
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.parallel import (replay_map_sharded,
                                                   replay_matrix_sharded,
                                                   replay_mergetree_sharded,
                                                   replay_tree_sharded)
    from fluidframework_tpu_torch.testing import config_workloads as cw
    from fluidframework_tpu_torch.testing.tree_workload import tree_windows

    mesh = _mesh2()
    docs = workload.hard_docs() + [workload.synth_doc(i, 48)
                                   for i in range(15)]
    fold_cuda.reset_launches()
    got = replay_mergetree_sharded(docs, mesh=mesh)
    assert fold_cuda.fold_export.launches == 2
    assert [s.digest() for s in got] == [
        s.digest() for s in mt.replay_mergetree_batch(docs)]
    _base, grown = tree_windows(33, 48)
    tree_fold_cuda.reset_launches()
    got = replay_tree_sharded(grown, mesh=mesh)
    assert tree_fold_cuda.fold.launches == 2
    assert [s.digest() for s in got] == [
        s.digest() for s in tk.replay_tree_batch(grown)]
    map_docs = cw.hard_map_docs() + [cw.gen_map_doc(i, 96)
                                     for i in range(9)]
    map_lww_cuda.reset_launches()
    got = replay_map_sharded(map_docs, mesh=mesh)
    assert map_lww_cuda.lww.launches == 2
    assert [s.digest() for s in got] == [
        s.digest() for s in mp.replay_map_batch(map_docs)]
    mx_docs = cw.hard_matrix_docs() + [cw.gen_matrix_doc(i, 64)
                                       for i in range(9)]
    matrix_fold_cuda.reset_launches()
    stats, want_stats = {}, {}
    got = replay_matrix_sharded(mx_docs, mesh=mesh, stats=stats)
    assert matrix_fold_cuda.fold_resolving.launches == 2
    assert [s.digest() for s in got] == [
        s.digest() for s in mk.replay_matrix_batch(mx_docs,
                                                   stats=want_stats)]
    assert stats == want_stats


def test_sharded_tiers_on_a_repeated_card_splice_each_part(cuda):
    """Tier 2.5 placed on ``["cuda:0"] * 2``: the exact pass uploads
    nothing, the grown pass splices each part in place (one K6 launch a
    part), and every pass equals the one-device pipeline."""
    from fluidframework_tpu_torch.ops import resident_cuda
    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
    from fluidframework_tpu_torch.ops.pipeline import PackCache
    from fluidframework_tpu_torch.parallel import replay_mergetree_sharded
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)

    streams = [workload.doc_ops(workload.synth_doc(i, 96))
               for i in range(21)]

    def windows(grown=()):
        out = []
        for i, s in enumerate(streams):
            msgs = s[:96 if i in grown else 80]
            out.append(mt.MergeTreeDocInput(
                doc_id=f"d{i}", ops=msgs, final_seq=msgs[-1].seq,
                final_msn=0, cache_token=("ep", f"d{i}", 0, "")))
        return out

    tiers = dict(pack_cache=PackCache(), delta_cache=DeltaExportCache(),
                 device_cache=DevicePackCache())
    mesh = _mesh2()
    for label, docs in (("cold", windows()), ("exact", windows()),
                        ("grown", windows(grown={0, 7, 20}))):
        stage = {}
        fold_cuda.reset_launches()
        resident_cuda.reset_launches()
        got = replay_mergetree_sharded(docs, mesh=mesh, stage=stage,
                                       **tiers)
        assert fold_cuda.fold_export.launches == 2, label
        assert [s.digest() for s in got] == [
            s.digest() for s in pipelined_mergetree_replay(docs)], label
        if label == "exact":
            assert stage["h2d_bytes"] == 0
        if label == "grown":
            assert resident_cuda.splice_rows.launches == 2
    assert tiers["device_cache"].stats()["spliced"] == 1


def test_catchup_service_on_a_repeated_card_equals_one_device(cuda):
    """``CatchupService(mesh=doc_mesh(["cuda:0"] * 2))``: the seam's
    sharded branch on the card gives the one-device instance's results
    and stats."""
    import random

    from fluidframework_tpu_torch.ops import map_lww_cuda
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.testing import service_workload as sw

    service = LocalOrderingService()
    sw.build_mixed_corpus(service, 6, random.Random("mesh"))
    sw.build_catchup_corpus(service, 16, 48)
    one = CatchupService(service, device=cuda)
    sharded = CatchupService(service, mesh=_mesh2(), device=cuda)
    o_stats, s_stats = {}, {}
    want = one.catch_up(stats=o_stats, upload=False)
    fold_cuda.reset_launches()
    map_lww_cuda.reset_launches()
    got = sharded.catch_up(stats=s_stats, upload=False)
    assert got == want and s_stats == o_stats
    assert fold_cuda.fold_export.launches == 2
    assert map_lww_cuda.lww.launches == 2


def test_frontdoor_proc_shards_fold_on_the_card(cuda, tmp_path):
    """Two ``ProcShard`` processes on ``cuda`` behind a ``FrontDoor``: a
    ``catchup`` RPC for each shard's documents folds every one of them
    on the card (``cpuDocs`` 0, one K1 launch in the shard's process),
    each summary equal to the CPU container fold of the log read back."""
    from fluidframework_tpu_torch.drivers.network_driver import _RpcClient
    from fluidframework_tpu_torch.protocol.summary import tree_from_obj
    from fluidframework_tpu_torch.protocol.wire import (
        decode_sequenced_message)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.frontdoor import FrontDoor
    from fluidframework_tpu_torch.testing import service_workload as sw

    door = FrontDoor(str(tmp_path / "fd"), n_shards=2, spawn="proc",
                     request_timeout=120.0, device=cuda).start()
    rpc = _RpcClient("127.0.0.1", door.port, timeout=120.0)
    try:
        ids = sw.write_catchup_corpus(rpc, 12, 48)
        owners = {}
        for d in ids:
            owners.setdefault(door._route_probe(d)[0], []).append(d)
        assert len(owners) == 2
        for sid, mine in owners.items():
            before = rpc.request("stats", {})["shards"][sid]["launches"]
            out = rpc.request("catchup", {"docs": mine}, timeout=120.0)
            after = rpc.request("stats", {})["shards"][sid]["launches"]
            assert out["deviceDocs"] == len(mine) and out["cpuDocs"] == 0
            assert after["fold_export_smem"] - before["fold_export_smem"] \
                == 1
            for d in mine:
                service = LocalOrderingService()
                service.storage.upload(
                    d, sw._seed_summary("sequence-tpu", "text"), 0)
                for m in rpc.request("deltas", {"doc": d}):
                    service.oplog.append(d, decode_sequenced_message(m))
                tree = tree_from_obj(rpc.request(
                    "read_summary", {"handle": out["docs"][d][0]}))
                assert tree.digest() == sw.catchup_oracle_digest(service, d)
    finally:
        rpc.close()
        door.close()


# -- the scenario engine and the wire soak on the card --------------------------


def test_storm_swarm_on_card_equals_cpu(cuda):
    """A small catch-up storm (the port's ``testing.scenarios``) with its
    ``OrderingServer`` folding on the card: K1 launched, and the whole
    replay-identity surface (heads, sampled digests, storm verdict
    counters) equal to the same spec's ``device="cpu"`` run."""
    from fluidframework_tpu_torch.ops.launches import (launch_counts,
                                                       reset_launches)
    from fluidframework_tpu_torch.testing.scenarios import (build_scenario,
                                                            run_swarm)

    spec = build_scenario("catchup-storm", seed=3, clients=800, docs=8,
                          shards=4)
    reset_launches()
    got = run_swarm(spec, device=cuda)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = run_swarm(spec, device="cpu")
    assert counts["fold_export_smem"] + counts["fold_export_gmem"] >= 1
    assert got.storm["folds"] >= 1
    assert got.identity() == want.identity()


def _soak_on(device, n_docs):
    """The wire soak over an in-process server on ``device``: the
    seeders' digests, the ``catchup`` answer, each answered summary's
    digest, the launches around the RPC, and sampled fresh loads."""
    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkDocumentServiceFactory)
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.ops.launches import (launch_counts,
                                                       reset_launches)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.server import OrderingServer
    from fluidframework_tpu_torch.testing.load import seed_wire_soak

    service = LocalOrderingService()
    server = OrderingServer(service, device=device)
    thread = server.start_in_thread()
    factory = None
    try:
        expected = seed_wire_soak("127.0.0.1", server.port, n_docs,
                                  timeout=300.0)
        factory = NetworkDocumentServiceFactory(host="127.0.0.1",
                                                port=server.port,
                                                timeout=300.0)
        reset_launches()
        res = factory._rpc.request("catchup", {}, timeout=300.0)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = launch_counts()
        summaries = {d: service.storage.read(h).digest()
                     for d, (h, _seq) in res["docs"].items()}
        loads = {}
        loader = Loader(factory)
        for i in (0, 1, 2, 3, 4, n_docs - 1):
            doc = f"soak{i:05d}"
            c = loader.resolve(doc)
            loads[doc] = (c.catchup_ops, c.runtime.summarize().digest())
            c.close()
        return expected, res, summaries, counts, loads
    finally:
        if factory is not None:
            factory.close()
        server.loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=10)


def test_wire_soak_on_card_equals_cpu(cuda):
    """64 mixed-channel documents seeded over TCP by 4 worker processes
    (``python -m fluidframework_tpu_torch.testing.load --wire-worker``),
    folded by one ``catchup`` RPC on the card: K1, K5, K7 and K4 each
    launched, every document on the device route, every summary equal to
    the ``device="cpu"`` server's, fresh loads replaying nothing and
    equal to the seeders' digests."""
    exp_gpu, res_gpu, sums_gpu, counts, loads_gpu = _soak_on(cuda, 64)
    exp_cpu, res_cpu, sums_cpu, _, loads_cpu = _soak_on("cpu", 64)
    assert exp_gpu == exp_cpu
    assert res_gpu["deviceDocs"] == res_cpu["deviceDocs"] == 64
    assert res_gpu["cpuDocs"] == 0
    assert sums_gpu == sums_cpu
    assert loads_gpu == loads_cpu
    assert all(ops == 0 and digest == exp_gpu[doc]
               for doc, (ops, digest) in loads_gpu.items())
    assert counts["fold_export_smem"] + counts["fold_export_gmem"] >= 1
    assert counts["tree_fold_digest_smem"] + counts["tree_fold_smem"] >= 1
    assert counts["map_lww"] >= 1
    assert counts["matrix_fold_smem"] + counts["matrix_fold_gmem"] >= 1


def test_interval_stabbing_exact_pass_on_card_moves_only_the_digest(cuda):
    """The interval stabbing workload (``synth_interval_doc``) through the
    three cache tiers on the card: the cold pass equal to the
    ``device="cpu"`` fold and the oracle; the exact pass serves every
    document from tier 0 (no byte up, the [D, 2] digest plane down, one
    K1 launch a chunk) with the cold pass's summaries."""
    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
    from fluidframework_tpu_torch.ops.launches import (launch_counts,
                                                       reset_launches)
    from fluidframework_tpu_torch.ops.pipeline import PackCache
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = [cw.synth_interval_doc(i, 96, n_msgs=84) for i in range(64)]
    tiers = dict(pack_cache=PackCache(), delta_cache=DeltaExportCache(),
                 device_cache=DevicePackCache(device=cuda))

    def run(device, **kw):
        stage, stats = {}, {}
        got = pipelined_mergetree_replay(docs, chunk_docs=16, stage=stage,
                                         stats=stats, device=device, **kw)
        return [s.digest() for s in got], stage, stats

    cold, _stage, _stats = run(cuda, **tiers)
    assert cold == run("cpu")[0]
    assert cold == [workload.oracle_replay(d).summarize().digest()
                    for d in docs]
    reset_launches()
    exact, stage, stats = run(cuda, **tiers)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert exact == cold
    assert (stage["h2d_bytes"], stage["d2h_bytes"]) == (0, 8 * len(docs))
    assert stats == {"delta_docs": len(docs)}
    assert counts["fold_export_smem"] + counts["fold_export_gmem"] == 4


def test_loadgen_storm_on_card_passes_and_equals_cpu(cuda, tmp_path):
    """``python -m fluidframework_tpu_torch.tools.loadgen --storm --device
    cuda`` (its ``main``): the verdict passes, K1 is launched, and the
    storm counters equal the same run's with ``--device cpu``."""
    import json

    from fluidframework_tpu_torch.ops.launches import (launch_counts,
                                                       reset_launches)
    from fluidframework_tpu_torch.tools import loadgen

    args = ["--storm", "--clients", "800", "--docs", "8", "--shards", "4",
            "--seed", "3"]

    def report(device):
        out = tmp_path / f"{device}.json"
        assert loadgen.main([*args, "--device", device,
                             "--out", str(out)]) == 0
        return json.loads(out.read_text())["scenarios"]["catchup-storm"]

    # the kernels build at first use: build them outside the timed run
    mt.replay_mergetree_batch([workload.synth_doc(0, 8)], device=cuda)
    reset_launches()
    got = report("cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = report("cpu")
    assert got["passed"] and got["oracle_match"]
    assert counts["fold_export_smem"] + counts["fold_export_gmem"] >= 1
    keys = ("requests", "served", "warm", "folds", "shed", "degraded",
            "retries", "fold_errors", "latency_p99_ticks")
    assert {k: got["storm"][k] for k in keys} == \
        {k: want["storm"][k] for k in keys}
    assert got["sequenced_ops"] == want["sequenced_ops"]
