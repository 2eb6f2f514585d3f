"""The tier-0 forest digest in the port (``tree_pipeline.tree_doc_digests``,
int64 arithmetic masked to 32 bits) against the JAX package's uint32 one,
bit for bit, and its invariance to bucket padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import tree_kernel as ref_tk
from fluidframework_tpu.ops import tree_pipeline as ref_tp
from fluidframework_tpu_torch.convert import tensors_to, tree_doc_input_from
from fluidframework_tpu_torch.ops import tree_fold_cuda
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops import tree_pipeline as tp
from fluidframework_tpu_torch.testing import tree_workload as tw
from tools import bench_kernels as bk

CPU = torch.device("cpu")


def _ref_digest(state_np, n_nodes, n_cont):
    return np.asarray(ref_tp.tree_doc_digests(
        ref_tk.TreeState(*state_np), jnp.asarray(n_nodes),
        jnp.asarray(n_cont)))


def _port_digest(state_np, n_nodes, n_cont):
    return tp.tree_doc_digests(
        tensors_to(state_np, CPU), torch.from_numpy(np.asarray(n_nodes)),
        torch.from_numpy(np.asarray(n_cont))).numpy()


def _workload(n, edits):
    return [tree_doc_input_from(bk.tree_doc(i, bk.synth_tree_messages(
        i, edits), edits)) for i in range(n)]


@pytest.mark.parametrize("n_docs,edits", [(8, 24), (32, 40)])
def test_digest_of_final_forest_matches_reference(n_docs, edits):
    state, edits_np, meta = tk.pack_tree_batch(_workload(n_docs, edits))
    final = tk.tree_fold_reference(tensors_to(state, CPU),
                                   tensors_to(edits_np, CPU))
    final_np = tk.TreeState(*(x.numpy() for x in final))
    want = _ref_digest(final_np, meta["n_nodes"], meta["n_cont"])
    got = _port_digest(final_np, meta["n_nodes"], meta["n_cont"])
    assert got.dtype == np.int32 and got.shape == (n_docs, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_digest_matches_reference_on_random_planes_and_counts(seed):
    """Every value domain (NIL, NOT_REMOVED, overflow on and off), and row
    counts from 0 to past the plane (the mask saturates)."""
    state, _edits = tw.random_tree_arrays(seed, 10, 32, 16, 8)
    rng = np.random.RandomState(seed)
    n_nodes = rng.randint(0, 40, size=10).astype(np.int32)
    n_cont = rng.randint(0, 20, size=10).astype(np.int32)
    n_nodes[0], n_cont[0] = 0, 0
    np.testing.assert_array_equal(
        _port_digest(state, n_nodes, n_cont),
        _ref_digest(state, n_nodes, n_cont))


def test_fold_digest_is_fold_then_digest_on_cpu():
    state, edits = tw.random_tree_arrays(9, 6, 32, 16, 24)
    st, ed = tensors_to(state, CPU), tensors_to(edits, CPU)
    n = torch.full((6,), 20, dtype=torch.int32)
    c = torch.full((6,), 10, dtype=torch.int32)
    final, dig = tree_fold_cuda.fold_digest(st, ed, n, c)
    want = tp.tree_doc_digests(tk.tree_fold_reference(st, ed), n, c)
    assert torch.equal(dig, want)


def test_digest_is_padding_invariant():
    """An unchanged document's digest survives a neighbour's growth (its
    bucket padding moves, its own rows do not), and two documents
    differ — as the reference's test pins it."""
    small = [bk.tree_doc(5, bk.synth_tree_messages(5, 24), 24),
             bk.tree_doc(7, bk.synth_tree_messages(7, 12), 12)]
    big = [small[0], bk.tree_doc(9, bk.synth_tree_messages(9, 100), 100)]

    def digest_of(docs, d):
        state, edits, meta = tk.pack_tree_batch(
            [tree_doc_input_from(x) for x in docs])
        final, dig = tree_fold_cuda.fold_digest(
            tensors_to(state, CPU), tensors_to(edits, CPU),
            torch.from_numpy(meta["n_nodes"]),
            torch.from_numpy(meta["n_cont"]))
        return tuple(dig[d].tolist()), state.next.shape

    (a, shape_a), (b, shape_b) = digest_of(small, 0), digest_of(big, 0)
    assert shape_a != shape_b   # the buckets did grow
    assert a == b
    assert digest_of(small, 0)[0] != digest_of(small, 1)[0]


def test_digest_moves_with_overflow_and_counts():
    state, _edits = tw.random_tree_arrays(2, 4, 16, 8, 4)
    n = np.full(4, 10, np.int32)
    c = np.full(4, 5, np.int32)
    base = _port_digest(state, n, c)
    flipped = state._replace(overflow=~state.overflow)
    assert (_port_digest(flipped, n, c) != base).all(axis=1).all()
    assert (_port_digest(state, n + 1, c) != base).all(axis=1).all()
    assert (_port_digest(state, n, c + 1) != base).all(axis=1).all()
