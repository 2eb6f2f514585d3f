"""The port's state digest (``_doc_digests``, uint32 arithmetic in int64)
against the JAX package's, bit for bit, and its invariances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.convert import tensors_to
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.protocol.messages import (MessageType,
                                                        SequencedMessage)
from tests.torch_corpora import (FOLD_CORPORA, bench_docs, interval_docs,
                                 port_docs, warm_doc)

CPU = torch.device("cpu")
DIGEST_CORPORA = dict(
    FOLD_CORPORA,
    warm=lambda: [warm_doc()] + bench_docs(3, 20),
    intervals=lambda: interval_docs(range(2)),
)


def test_mix_u32_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, (1 << 31), (1 << 32) - 1]
    want = np.asarray(ref_mt._mix_u32(jnp.asarray(x.astype(np.uint32))))
    got = mt._mix_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _finals(docs):
    """(reference final state, port final state, doc_base) of one chunk,
    each folded by its own package."""
    r_st, r_ops, meta = ref_mt.pack_mergetree_batch(docs)
    p_st, p_ops, _m = mt.pack_mergetree_batch(port_docs(docs))
    ref = jax.jit(ref_mt.replay_vmapped)(r_st, r_ops)
    port = mt.fold_reference(tensors_to(p_st, CPU), tensors_to(p_ops, CPU))
    return ref, port, meta["doc_base"]


@pytest.mark.parametrize("corpus", sorted(DIGEST_CORPORA))
def test_digest_matches_reference(corpus):
    ref, port, base = _finals(DIGEST_CORPORA[corpus]())
    want = np.asarray(ref_mt._doc_digests(ref, jnp.asarray(base)))
    got = mt._doc_digests(port, torch.from_numpy(base)).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_digest_matches_reference_on_sentinels_and_overflow():
    """NOT_REMOVED in every seq plane, -1 clients, an overflowed document
    and a negative rebased tstart: the same bits as the reference."""
    ref, port, base = _finals(FOLD_CORPORA["overflow"]()
                              + bench_docs(2, 16))
    assert bool(port.overflow[0])
    for plane in mt.SENTINEL_SEQ_FIELDS:
        assert (getattr(port, plane) == mt._NR).any(), plane
    shifted = np.asarray(base) + 1000  # tstart - base < 0 on live slots
    want = np.asarray(ref_mt._doc_digests(ref, jnp.asarray(shifted)))
    got = mt._doc_digests(port, torch.from_numpy(shifted)).numpy()
    np.testing.assert_array_equal(got, want)


def _msg(seq, contents):
    return SequencedMessage(seq=seq, client_id="c0", client_seq=seq,
                            ref_seq=seq - 1, min_seq=0, type=MessageType.OP,
                            contents=contents)


def _annotated_doc(doc_id, keys):
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        MergeTreeDocInput)

    ops = [_msg(1, {"kind": "insert", "pos": 0, "text": "stable txt"})]
    for i, key in enumerate(keys):
        ops.append(_msg(2 + i, {"kind": "annotate", "start": 0, "end": 4,
                                "props": {key: 1}}))
    return MergeTreeDocInput(doc_id=doc_id, ops=ops, final_seq=len(ops),
                             final_msn=0)


def _digest_of(docs, want_id):
    state, ops, meta = mt.pack_mergetree_batch(docs)
    _core, dig = mt.split_export_digest(mt.replay_export(
        None, ops, meta, S=state.tstart.shape[1], digest=True,
        device="cpu"), True)
    d = [x.doc_id for x in meta["docs"]].index(want_id)
    return tuple(int(v) for v in dig[d])


def test_digest_invariant_to_props_K_bucket_growth():
    """Another document introducing new annotate keys grows the chunk's
    props-K bucket; an unchanged document's digest does not move (absent
    keys hash zero), while a set value id 0 stays distinct from absent."""
    a = _annotated_doc("A", ["f"])
    with_k1 = _digest_of([a, _annotated_doc("B", ["f"])], "A")
    with_k4 = _digest_of([a, _annotated_doc("B", ["f", "g", "h"])], "A")
    assert with_k1 == with_k4
    plain = _annotated_doc("A", [])
    full = plain.__class__(
        doc_id="A", ops=plain.ops + [_msg(2, {
            "kind": "annotate", "start": 0, "end": 10, "props": {"f": 1}})],
        final_seq=2, final_msn=0)
    assert _digest_of([plain], "A") != _digest_of([full], "A")


def test_digest_invariant_to_arena_offsets_and_slot_bucket():
    """tstart enters relative to the document's own arena base and only
    live slots count: the same document digests the same whether other
    documents precede it in the arena or grow the chunk's S bucket."""
    doc = port_docs(bench_docs(3, 24))[2]
    alone = _digest_of([doc], doc.doc_id)
    behind = _digest_of(port_docs(bench_docs(2, 96)) + [doc], doc.doc_id)
    assert alone == behind
