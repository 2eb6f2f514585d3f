"""The port's fold against the JAX package's: exact parity on the CPU.

``fold_reference`` (the plain PyTorch fold) is held against the
reference's ``jax.jit(replay_vmapped)`` on every corpus and against its
Pallas kernel in interpret mode on one batch; ``export_state`` against
the reference's int32 full ``_export_state`` layout.  The hand-written
CUDA kernel is held against ``fold_reference`` on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu.ops.pallas_fold import replay_vmapped_pallas
from fluidframework_tpu_torch.convert import tensors_to
from fluidframework_tpu_torch.ops import fold_cuda
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from tests.torch_corpora import (FOLD_CORPORA, assert_states_equal,
                                 bench_docs, hard_docs, overflow_doc)


def _packed(docs):
    state, ops, meta = ref_mt.pack_mergetree_batch(docs)
    return state, ops, meta


def _fold_cpu(state, ops):
    return mt.fold_reference(tensors_to(state, "cpu"),
                             tensors_to(ops, "cpu"))


@pytest.mark.parametrize("corpus", sorted(FOLD_CORPORA))
def test_fold_reference_matches_jax_scan(corpus):
    docs = FOLD_CORPORA[corpus]()
    state, ops, _meta = _packed(docs)
    ref = jax.jit(ref_mt.replay_vmapped)(state, ops)
    got = _fold_cpu(state, ops)
    assert_states_equal(ref, got, len(docs))


def test_fold_reference_matches_pallas_interpret():
    docs = hard_docs() + [overflow_doc()]
    state, ops, _meta = _packed(docs)
    ref = replay_vmapped_pallas(state, ops, interpret=True)
    got = _fold_cpu(state, ops)
    assert_states_equal(ref, got, len(docs))


def _dead_planes(state, n):
    """Each plane's values on slots [n, S), as (plane name, per-doc list)."""
    planes = {f: np.asarray(getattr(state, f)) for f in mt.EXPORT_SLOT_FIELDS}
    props = np.asarray(state.props)
    planes.update({f"props{k}": props[:, :, k] for k in range(props.shape[2])})
    n = np.asarray(n)
    return {f: [x[d, n[d]:] for d in range(len(n))] for f, x in planes.items()}


@pytest.mark.parametrize("corpus", sorted(FOLD_CORPORA))
def test_fold_leaves_dead_slots_at_their_fill(corpus):
    """The invariant the CUDA kernel relies on when it never touches slots
    [n, S): the input's dead region holds one value per plane, and after
    the plain fold (and the JAX package's scan) the dead slots [n, S)
    still hold exactly that value."""
    docs = FOLD_CORPORA[corpus]()
    state, ops, _meta = _packed(docs)
    fills = {}
    for f, rows in _dead_planes(state, state.n).items():
        values = np.unique(np.concatenate(rows))
        assert len(values) == 1, (f, values)
        fills[f] = values[0]
    got = _fold_cpu(state, ops)
    ref = jax.jit(ref_mt.replay_vmapped)(state, ops)
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(ref.n))
    got_dead = _dead_planes(got, got.n.numpy())
    ref_dead = _dead_planes(ref, np.asarray(ref.n))
    for f, fill in fills.items():
        for d, (mine, theirs) in enumerate(zip(got_dead[f], ref_dead[f])):
            np.testing.assert_array_equal(mine, np.full_like(mine, fill),
                                          err_msg=f"{f} doc {d}")
            np.testing.assert_array_equal(mine, theirs,
                                          err_msg=f"{f} doc {d} vs JAX")


@pytest.mark.parametrize("dim", ["S", "T"])
def test_kernel_refuses_rows_it_cannot_bulk_copy(dim):
    """The kernel moves whole rows with bulk copies, so a plane of S int32
    or an op field of T int32 must be a multiple of 16 bytes; the wrapper
    names the shape it refuses (checked on CPU tensors: no card needed)."""
    S, T = (30, 16) if dim == "S" else (32, 18)
    ops = mt.MTOps(*[torch.zeros((2, T), dtype=torch.int32)
                     for _ in range(9)],
                   pvals=torch.full((2, T, 1), mt.PROP_NOT_TOUCHED,
                                    dtype=torch.int32))
    state = mt.cold_start(ops, S)
    with pytest.raises(ValueError, match=f"{dim}={S if dim == 'S' else T}"):
        fold_cuda._check(state, ops, torch.device("cpu"))
    ok_ops = mt.MTOps(*[torch.zeros((2, 16), dtype=torch.int32)
                        for _ in range(9)],
                      pvals=torch.full((2, 16, 1), mt.PROP_NOT_TOUCHED,
                                       dtype=torch.int32))
    assert fold_cuda._check(mt.cold_start(ok_ops, 32), ok_ops,
                            torch.device("cpu")) == (2, 32, 16, 1)


def test_overflow_doc_sets_overflow():
    """The directed overflow document really overflows (a third remover
    of one segment), so the fallback path is exercised."""
    state, ops, _meta = _packed([overflow_doc()])
    got = _fold_cpu(state, ops)
    assert bool(got.overflow[0])


@pytest.mark.parametrize("corpus", ["bench-24x48", "hard", "overflow"])
def test_export_matches_jax_int32_full_layout(corpus):
    docs = FOLD_CORPORA[corpus]()
    state, ops, _meta = _packed(docs)
    D = len(docs)
    final_ref = jax.jit(ref_mt.replay_vmapped)(state, ops)
    ref = np.asarray(ref_mt._export_state(
        final_ref, jnp.zeros((D,), jnp.int32), i16=False, ob_rows=True,
        ov_rows=True, i8=False, props_rows=True))
    got = mt.export_state(_fold_cpu(state, ops)).numpy()
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[:, -1], ref[:, -1], err_msg="misc")
    n = ref[:, -1, 0]
    for d in range(D):
        np.testing.assert_array_equal(got[d, :-1, :n[d]], ref[d, :-1, :n[d]],
                                      err_msg=f"doc {d}")
    # dead slots' tstart is zeroed in both layouts
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])


def test_cpu_wrapper_uses_plain_fold_and_counts_no_launch():
    docs = bench_docs(6, 24)
    state, ops, _meta = _packed(docs)
    before = fold_cuda.fold.launches
    got = fold_cuda.fold(tensors_to(state, "cpu"),
                         tensors_to(ops, "cpu"))
    assert fold_cuda.fold.launches == before
    want = _fold_cpu(state, ops)
    for f in mt.MTState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_cold_start_matches_packed_empty_state():
    docs = bench_docs(5, 16)
    state, ops, _meta = _packed(docs)
    cold = mt.cold_start(tensors_to(ops, "cpu"), state.tstart.shape[1])
    for f in mt.MTState._fields:
        np.testing.assert_array_equal(getattr(cold, f).numpy(),
                                      getattr(state, f), err_msg=f)
