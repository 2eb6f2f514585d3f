"""The hand-written CUDA fold kernel against the plain PyTorch fold, on
the card.  These tests need an NVIDIA GPU (sm_90a) and ``nvcc``; without
a CUDA device they skip.  They import neither JAX nor the JAX package, so
on a machine without JAX they run with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import pytest
import torch

from fluidframework_tpu_torch.convert import ops_from_numpy, state_from_numpy
from fluidframework_tpu_torch.ops import fold_cuda
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
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
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_kernel_matches_plain_fold(cuda, corpus):
    docs = CORPORA[corpus]()
    st_np, ops_np, _meta = mt.pack_mergetree_batch(docs)
    state, ops = state_from_numpy(st_np, cuda), ops_from_numpy(ops_np, cuda)
    before = fold_cuda.fold.launches
    got = fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    assert fold_cuda.fold.launches == before + 1
    want = mt.fold_reference(state, ops)
    _assert_all_equal(want, got)


def test_entry_point_on_card_matches_oracle(cuda):
    docs = workload.hard_docs() + [workload.synth_doc(i, 48)
                                   for i in range(16)]
    before = fold_cuda.fold.launches
    got = mt.replay_mergetree_batch(docs)
    assert fold_cuda.fold.launches == before + 1
    want = [workload.oracle_replay(d).summarize().digest() for d in docs]
    assert [s.digest() for s in got] == want


def test_state_too_large_for_shared_memory_is_refused(cuda):
    ops = mt.MTOps(*[torch.zeros((1, 4), dtype=torch.int32, device=cuda)
                     for _ in range(9)],
                   pvals=torch.full((1, 4, 1), mt.PROP_NOT_TOUCHED,
                                    dtype=torch.int32, device=cuda))
    state = mt.cold_start(ops, 8192)
    with pytest.raises(ValueError, match="S=8192 slots and K=1"):
        fold_cuda.fold(state, ops)
