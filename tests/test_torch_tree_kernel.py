"""The port's SharedTree catch-up (``ops/tree_kernel.py``) against the JAX
package's on the CPU: the packer's planes and meta, the plain edit-fold
against the reference's ``replay_vmapped`` on every plane (padding rows
included), its index rules on crafted NIL cases, ``replay_tree_batch``
against the reference's and the oracle with the per-reason counts, and
the pinned workload's copy message for message.  Equality is exact."""

import json

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.tree import SharedTree as RefTree
from fluidframework_tpu.ops import tree_kernel as ref_tk
from fluidframework_tpu.protocol.messages import (MessageType,
                                                  SequencedMessage)
from fluidframework_tpu_torch.convert import (tensors_to, tree_arrays_from,
                                              tree_doc_input_from)
from fluidframework_tpu_torch.dds.tree import SharedTree
from fluidframework_tpu_torch.ops import tree_fold_cuda
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.testing import tree_workload as tw
from tests.test_tree_kernel import run_fuzz_doc
from tools import bench_kernels as bk

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fuzz_docs(seeds, steps=60, n_clients=3):
    docs = []
    for k, seed in enumerate(seeds):
        _f, _t, log, fs, fm = run_fuzz_doc(seed, steps=steps,
                                           n_clients=n_clients,
                                           with_moves=k % 4 != 3)
        docs.append(ref_tk.TreeDocInput(f"f{seed}", ops=log, final_seq=fs,
                                        final_msn=fm))
    return docs


def _warm_docs(seeds, attribution=False):
    """Mid-stream summaries of fuzz logs as bases, with their tails."""
    docs = []
    for seed in seeds:
        _f, _t, log, fs, fm = run_fuzz_doc(seed, steps=60)
        mid = len(log) // 2
        base = RefTree("tree")
        if attribution:
            from fluidframework_tpu.runtime.attributor import Attributor

            base._attributor = Attributor()
        for msg in log[:mid]:
            base.process(msg, local=False)
        docs.append(ref_tk.TreeDocInput(
            f"w{seed}", ops=log[mid:], base_summary=base.summarize(),
            final_seq=fs, final_msn=fm, attribution=attribution))
    return docs


def _workload_docs(n=32, edits=40):
    return [bk.tree_doc(i, bk.synth_tree_messages(i, edits), edits)
            for i in range(n)]


CORPORA = {
    "fuzz": lambda: _fuzz_docs([1, 2, 3, 17, 55, 301, 40007, 40045]),
    "fuzz-deep": lambda: _fuzz_docs([40060, 40100, 40200], steps=120,
                                    n_clients=4),
    "warm": lambda: _warm_docs([77, 78, 79, 80]),
    "warm-attribution": lambda: _warm_docs([81, 82], attribution=True),
    "workload": _workload_docs,
    "nondivisible": lambda: _fuzz_docs(range(1500, 1511), steps=18),
}


def _port(ref_docs):
    return [tree_doc_input_from(d) for d in ref_docs]


def _fold_both(state_np, edits_np):
    """(reference final planes as numpy, port plain-fold final planes)."""
    ref = ref_tk.replay_vmapped(ref_tk.TreeState(*state_np),
                                ref_tk.TreeEdits(*edits_np))
    got = tk.tree_fold_reference(tensors_to(state_np, CPU),
                                 tensors_to(edits_np, CPU))
    return ref, got


def _assert_planes_equal(ref, got):
    for f in tk.TreeState._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).numpy() if isinstance(getattr(got, f),
                                                  torch.Tensor) \
            else np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_pack_planes_and_meta_match_reference(corpus):
    docs = CORPORA[corpus]()
    r_state, r_edits, r_meta = ref_tk.pack_tree_batch(docs)
    state, edits, meta = tk.pack_tree_batch(_port(docs))
    _assert_planes_equal(r_state, state)
    for f in tk.TreeEdits._fields:
        np.testing.assert_array_equal(np.asarray(getattr(r_edits, f)),
                                      getattr(edits, f), err_msg=f)
        assert getattr(edits, f).dtype == np.int32
    for key in ("n_nodes", "n_cont", "t_rows"):
        np.testing.assert_array_equal(r_meta[key], meta[key], err_msg=key)
    assert [p.fallback_reason for p in r_meta["doc_packs"]] == \
        [p.fallback_reason for p in meta["doc_packs"]]
    assert r_meta["values"].values == meta["values"].values


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_plain_fold_matches_replay_vmapped_on_every_plane(corpus):
    state, edits, _meta = tk.pack_tree_batch(_port(CORPORA[corpus]()))
    ref, got = _fold_both(state, edits)
    _assert_planes_equal(ref, got)


@pytest.mark.parametrize("seed", range(6))
def test_plain_fold_matches_replay_vmapped_on_random_planes(seed):
    """Indices drawn from each plane's whole domain, NIL included, with no
    forest structure: cycles, aliasing writes and unmasked NIL reads."""
    state, edits = tw.random_tree_arrays(seed, 12, 32, 16, 48)
    ref, got = _fold_both(state, edits)
    _assert_planes_equal(ref, got)


@pytest.mark.parametrize("seed", range(3))
def test_plain_fold_matches_replay_vmapped_on_wild_planes(seed):
    """Indices and values far outside their planes (the int32 extremes,
    counts from the end past the plane): XLA's read and write rules at
    both ends of the range, in the reference and the plain fold alike."""
    state, edits = tw.wild_tree_arrays(seed, 12, 32, 16, 48)
    ref, got = _fold_both(state, edits)
    _assert_planes_equal(ref, got)


@pytest.mark.parametrize("case", sorted(tw.crafted_tree_cases()))
def test_plain_fold_matches_replay_vmapped_on_crafted_nil_cases(case):
    state, edits = tw.crafted_tree_cases()[case]
    ref, got = _fold_both(state, edits)
    _assert_planes_equal(ref, got)


def test_crafted_cases_hit_the_index_rules():
    """What each crafted case is for actually happens (on the port's
    plain fold, which the tests above hold equal to the reference)."""
    cases = tw.crafted_tree_cases()

    def fold(name):
        st, ed = cases[name]
        return st, tk.tree_fold_reference(tensors_to(st, CPU),
                                          tensors_to(ed, CPU))

    # the detach of an unlinked node writes head[NIL], the last slot
    st, got = fold("unlinked_move_target")
    assert st.head[0, -1] != tk.NIL and int(got.head[0, -1]) == tk.NIL
    # a NIL owner is gated by the last node row's expiry
    st, got = fold("nil_dest_owner")
    assert int(got.node_container[0, 2]) == 0      # not moved (expired)
    assert int(got.node_container[1, 2]) == 2      # moved
    # a move anchored at itself lands at the field start
    _st, got = fold("anchor_is_target")
    assert int(got.head[0, 0]) == 4
    # a hit inside the walk still overflows; a target past it moves
    _st, got = fold("deep_chain")
    assert got.overflow.tolist() == [True, True]
    assert int(got.node_container[0, 70]) == 69     # hit: not moved
    assert int(got.node_container[1, 3]) == 75      # not reached: moved


def test_wrapper_runs_the_plain_fold_on_cpu_and_refuses_other_devices():
    state, edits = tw.random_tree_arrays(3, 4, 16, 8, 16)
    st, ed = tensors_to(state, CPU), tensors_to(edits, CPU)
    n = torch.full((4,), 16, dtype=torch.int32)
    c = torch.full((4,), 8, dtype=torch.int32)
    before = (tree_fold_cuda.fold.launches,
              tree_fold_cuda.fold_digest.launches)
    _assert_planes_equal(tk.tree_fold_reference(st, ed),
                         tree_fold_cuda.fold(st, ed))
    final, dig = tree_fold_cuda.fold_digest(st, ed, n, c)
    _assert_planes_equal(tk.tree_fold_reference(st, ed), final)
    assert dig.shape == (4, 2) and dig.dtype == torch.int32
    # the plain version is no launch
    assert (tree_fold_cuda.fold.launches,
            tree_fold_cuda.fold_digest.launches) == before
    meta = tk.TreeState(*(x.to("meta") for x in st))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tree_fold_cuda.fold(meta, tk.TreeEdits(*(x.to("meta") for x in ed)))


@pytest.mark.parametrize("build", ["fold", "fold_digest"])
def test_wrapper_counts_no_launch_for_an_empty_chunk(build):
    """A chunk of no documents launches nothing, so it adds nothing to the
    entry's counts: the count is taken where the kernel launches."""
    st_np, ed_np = tk.empty_tree_arrays(0, 16, 8, 16)
    st = tensors_to(tk.TreeState(**st_np), CPU)
    ed = tensors_to(tk.TreeEdits(**ed_np), CPU)
    entry = getattr(tree_fold_cuda, build)
    counts = None if build == "fold" else \
        (torch.zeros((0,), dtype=torch.int32),) * 2
    before = (entry.launches, dict(entry.placements))
    out, dig = tree_fold_cuda._launch(st, ed, counts, entry)
    assert (entry.launches, entry.placements) == before
    assert out.next.shape == (0, 16) and out.head.shape == (0, 8)
    assert (dig is None) == (build == "fold")


def test_wrapper_checks_what_the_kernel_reads():
    state, edits = tw.random_tree_arrays(4, 3, 16, 8, 16)
    st, ed = tensors_to(state, CPU), tensors_to(edits, CPU)
    assert tree_fold_cuda._check(st, ed, CPU) == (3, 16, 8, 16)
    bad = [
        (st._replace(next=st.next.long()), ed, "state.next is torch.int64"),
        (st._replace(head=st.head[:2]), ed, "state.head has shape"),
        (st, ed._replace(anchor=ed.anchor.t().contiguous().t()),
         "edits.anchor is not contiguous"),
        (st._replace(overflow=st.overflow.int()), ed,
         "state.overflow is torch.int32"),
    ]
    for s, e, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tree_fold_cuda._check(s, e, CPU)
    assert tree_fold_cuda.placement(256, 128) == "smem"
    assert tree_fold_cuda.placement(8192, 4096) == "gmem"
    assert tree_fold_cuda.launch_shape(1024, 256, 128)["docs_per_block"] \
        == 1


def test_shared_memory_a_document_matches_the_source():
    """``doc_bytes`` is the source's ``doc_words``: the mbarrier, the raw
    edit tile and the decoded rows, and in shared memory the forest and
    (in the full layout) the walk table; ``smem_layout`` picks the full
    layout, else the lean one with the most rows that fit."""
    import os
    import re

    with open(os.path.join(os.path.dirname(tree_fold_cuda.__file__),
                           "..", "csrc", "tree_fold.cu")) as f:
        src = f.read()
    assert re.search(rf"constexpr int kTile = {tree_fold_cuda.EDIT_TILE};",
                     src)
    assert re.search(r"constexpr int kRowWords = 16;", src)
    assert re.search(rf"constexpr int kSmemLimit = "
                     rf"{tree_fold_cuda.SMEM_LIMIT};", src)
    rows = 4 + 8 * 64 + 16 * 65
    assert tree_fold_cuda.doc_bytes(256, 128) == 4 * (
        rows + 7 * 256 + 2 * 128 + 2 * 258) == 16480
    assert tree_fold_cuda.doc_bytes(256, 128, "gmem") == 4 * rows
    # odd sizes: the forest rounds up to an even count, the whole to 16 B
    assert rows + 280 + 78 == 1914
    assert tree_fold_cuda.doc_bytes(37, 10) == 4 * 1916
    # the lean layout: no walk table, fewer rows a tile
    assert tree_fold_cuda.doc_bytes(8192, 128, "smem", 20, False) == 4 * (
        4 + 8 * 20 + 16 * 21 + 7 * 8192 + 2 * 128) == 232400
    # the edges at C = 64: the full layout up to N = 6,268, the lean one
    # (64 rows a tile, then fewer) up to N = 8,266, then device memory
    assert tree_fold_cuda.smem_layout(6268, 64) == (64, True)
    assert tree_fold_cuda.smem_layout(6272, 64) == (64, False)
    assert tree_fold_cuda.smem_layout(8266, 64) == (4, False)
    assert tree_fold_cuda.smem_layout(8267, 64) is None
    assert tree_fold_cuda.placement(8266, 64) == "smem"
    assert tree_fold_cuda.placement(8267, 64) == "gmem"


def test_shared_memory_holds_every_forest_the_earlier_design_did():
    """Every bucket shape (powers of two, as the packer sizes N and C)
    whose forest alone fits a block, which the earlier design folded in
    shared memory, still folds there."""
    limit = tree_fold_cuda.SMEM_LIMIT
    held = [(N, C) for N in (2 ** k for k in range(4, 16))
            for C in (2 ** k for k in range(3, 16))
            if 4 * (7 * N + 2 * C) <= limit]
    assert (8192, 256) in held and (8192, 512) not in held
    assert [(N, C) for N, C in held
            if tree_fold_cuda.placement(N, C) != "smem"] == []


@pytest.mark.parametrize("D, N, C, where, tile, table, smem", [
    (1024, 256, 128, "smem", 64, True, 16480),   # the pinned chunk
    (37, 37, 10, "smem", 64, True, 7664),
    (1024, 8192, 128, "smem", 20, False, 232400),  # lean
    (1024, 8192, 256, "smem", 8, False, 232272),   # lean, fewer rows
    (5, 8192, 4096, "gmem", 64, False, 6224),   # device memory
])
def test_launch_shape_is_one_document_a_block(D, N, C, where, tile, table,
                                              smem):
    """One block of one warp a document, with the working set of the
    placement and layout ``fold`` picks as its shared memory."""
    assert tree_fold_cuda.launch_shape(D, N, C) == {
        "placement": where, "docs_per_block": 1, "blocks": D,
        "threads_per_block": 32, "edit_tile": tile, "walk_table": table,
        "smem_bytes": smem}
    assert tree_fold_cuda.doc_bytes(N, C, where, tile, table) == smem


class _Entry:
    """A stand-in for a kernel library's ``tree_fold`` entry that records
    the launch it is asked for."""

    def __init__(self):
        self.asked = []

    def tree_fold(self, ptrs, D, N, C, T, gmem, docs_per_block, stream):
        self.asked.append((gmem, docs_per_block))
        return 0


@pytest.mark.parametrize("N, C, gmem, per_block", [
    (256, 128, 0, 4),       # the pinned chunk: 8 KiB forests, 4 a block
    (2048, 1024, 0, 3),     # 65,536 B forests: 3 fit a block
    (8192, 128, 0, 1),      # 230,400 B: one fits, barely
    (8192, 512, 1, 4),      # 233,472 B: past a block, device memory
])
def test_earlier_design_launches_by_its_own_rule(N, C, gmem, per_block):
    """The yardstick takes the launch its own wrapper made (the forest
    alone in shared memory when it fits, as many a block as fit, at most
    4), whatever ``fold`` passes, and hands back the entry's code."""
    lib = _Entry()
    rc = tree_fold_cuda.EarlierLaunch(lib).tree_fold(
        None, 8, N, C, 64, 0, 1, None)
    assert rc == 0
    assert lib.asked == [(gmem, per_block)]


@pytest.mark.parametrize("name, entry", [
    ("tree_fold", "int tree_fold(void* const* ptrs, int D, int N, int C, "
                  "int T, int gmem,\n              int docs_per_block, "
                  "void* stream)"),
    ("map_lww", "int map_lww(void* const* ptrs, int N, int G, int M, "
                "int docs, void* stream)"),
])
def test_earlier_design_keeps_the_kernels_c_entry(name, entry):
    """The yardstick source and the kernel's source declare the same C
    entry, so one binding (``bind``) drives both."""
    import os

    csrc = os.path.join(os.path.dirname(tree_fold_cuda.__file__), "..",
                        "csrc")
    for source in (f"{name}.cu", f"{name}_earlier.cu"):
        with open(os.path.join(csrc, source)) as f:
            assert f.read().count(entry) == 1, source


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_replay_tree_batch_matches_reference_and_oracle(corpus):
    docs = CORPORA[corpus]()
    r_stats, p_stats = {}, {}
    want = [s.digest() for s in ref_tk.replay_tree_batch(docs,
                                                         stats=r_stats)]
    port = _port(docs)
    got = [s.digest() for s in tk.replay_tree_batch(port, stats=p_stats,
                                                    device="cpu")]
    assert got == want
    assert p_stats == r_stats
    assert got == [tk.oracle_fallback_summary(d).digest() for d in port]


def test_replay_tree_batch_per_reason_counts_on_every_shape():
    docs = _workload_docs()
    assert {bk.tree_shape(i) for i in range(32)} == set(tw.SHAPES)
    stats = {}
    tk.replay_tree_batch(_port(docs), stats=stats, device="cpu")
    assert stats["fallback_revive"] >= 1
    assert stats["fallback_multi_id_move"] >= 1
    assert stats["fallback_max_depth"] >= 1
    assert stats["device_docs"] + stats["fallback_docs"] == len(docs)


def test_revive_limbo_and_empty_documents():
    """The reference's directed cases: a revive (oracle fallback), a
    limbo rescue cold and from a limbo base (fallback), and empty docs."""
    def op(seq, min_seq, edits):
        return SequencedMessage(
            seq=seq, client_id="c0", client_seq=seq, ref_seq=seq - 1,
            min_seq=min_seq, type=MessageType.OP, contents={"edits": edits})

    def ins(nid, parent, field, val):
        return {"kind": "insert", "parent": parent, "field": field,
                "anchor": None,
                "content": [{"id": nid, "type": "n", "value": val}]}

    log = [
        op(1, 0, [ins("A", "", "a", 1)]),
        op(2, 0, [ins("B", "", "a", 2)]),
        op(3, 0, [{"kind": "move", "ids": ["B"], "parent": "A",
                   "field": "kids", "anchor": None}]),
        op(4, 0, [{"kind": "remove", "ids": ["A"]}]),
        op(5, 4, [ins("C", "", "a", 3)]),
        op(6, 4, [ins("D", "", "a", 4)]),
        op(7, 4, [{"kind": "move", "ids": ["B"], "parent": "", "field": "a",
                   "anchor": None}]),
        op(8, 4, [{"kind": "revive", "ids": ["A"], "parent": "",
                   "field": "b", "anchor": None,
                   "content": [{"id": "A", "type": "n", "value": 1}]}]),
    ]
    mid = RefTree("t")
    for m in log[:6]:
        mid.process(m, local=False)
    docs = [
        ref_tk.TreeDocInput("cold", ops=log[:7], final_seq=7, final_msn=4),
        ref_tk.TreeDocInput("limbo-base", ops=log[6:7],
                            base_summary=mid.summarize(), final_seq=7,
                            final_msn=4),
        ref_tk.TreeDocInput("revive", ops=log, final_seq=8, final_msn=4),
        ref_tk.TreeDocInput("empty", ops=[]),
    ]
    r_stats, p_stats = {}, {}
    want = [s.digest() for s in ref_tk.replay_tree_batch(docs,
                                                         stats=r_stats)]
    got = [s.digest() for s in tk.replay_tree_batch(
        _port(docs), stats=p_stats, device="cpu")]
    assert got == want and p_stats == r_stats
    assert p_stats["fallback_base_limbo"] == 1
    assert p_stats["fallback_revive"] == 1
    assert tk.replay_tree_batch([], device="cpu") == []


def test_port_oracle_matches_reference_oracle():
    """The port's copy of ``dds/tree.py`` (with its attributor) gives the
    reference oracle's bytes, cold, warm and with attribution."""
    docs = _fuzz_docs([5, 6]) + _warm_docs([7]) + _warm_docs(
        [8], attribution=True)
    for ref_doc, doc in zip(docs, _port(docs)):
        assert tk.oracle_fallback_summary(doc).digest() == \
            ref_tk.oracle_fallback_summary(ref_doc).digest()
    live = SharedTree("t")
    nid = live.insert("", "a", 0, [live.build("n", value=1)])
    assert json.loads(live.summarize().blob_bytes("header"))["fields"] \
        and nid


@pytest.mark.parametrize("n_edits", [24, 48])
def test_tree_workload_matches_reference_message_for_message(n_edits):
    for i in range(64):
        ref = bk.synth_tree_messages(i, n_edits)
        got = tw.synth_tree_messages(i, n_edits)
        assert tw.tree_shape(i) == bk.tree_shape(i)
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            assert (a.seq, a.client_id, a.client_seq, a.ref_seq, a.min_seq,
                    a.type.value, a.contents) == \
                (b.seq, b.client_id, b.client_seq, b.ref_seq, b.min_seq,
                 b.type.value, b.contents)
    base, grown = tw.tree_windows(16, n_edits)
    grow = max(2, n_edits // 8)
    for i, (b, g) in enumerate(zip(base, grown)):
        s = bk.synth_tree_messages(i, n_edits)
        ref_b = bk.tree_doc(i, s, len(s) - grow)
        assert (b.doc_id, len(b.ops), b.final_seq, b.final_msn,
                b.cache_token) == (ref_b.doc_id, len(ref_b.ops),
                                   ref_b.final_seq, ref_b.final_msn,
                                   ref_b.cache_token)
        assert len(g.ops) == (len(s) if i % 8 == 0 else len(s) - grow)


def test_converted_arrays_keep_dtypes():
    docs = _workload_docs(4, 24)
    r_state, r_edits, _m = ref_tk.pack_tree_batch(docs)
    state, edits = tree_arrays_from(r_state, r_edits)
    assert state.overflow.dtype == np.bool_
    assert all(getattr(state, f).dtype == np.int32
               for f in tk.TreeState._fields if f != "overflow")
    got = tk.tree_fold_reference(tensors_to(state, CPU),
                                 tensors_to(edits, CPU))
    _assert_planes_equal(ref_tk.replay_vmapped(r_state, r_edits), got)
