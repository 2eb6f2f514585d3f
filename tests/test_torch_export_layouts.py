"""The port's transfer layouts against the JAX package's, exactly.

``replay_export(..., device="cpu")`` (narrow upload, plain decode, plain
fold, plain export and digest) gives the same leaves as the reference's
``replay_export`` — dtype, shape and bytes — in the chunk's own layout and
in every layout reachable by turning a fact off (a narrowing fact, or a
row elision), digest on and off, cold and warm.  The reference runs with
``FF_PALLAS_FOLD`` unset (its default XLA fold)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import (FOLD_CORPORA, bench_docs, interval_docs,
                                 port_docs, warm_doc)

#: the corpora of the fold tests, plus warm (base summary) and interval
#: chunks
EXPORT_CORPORA = dict(
    FOLD_CORPORA,
    warm=lambda: [warm_doc()] + bench_docs(3, 20),
    intervals=lambda: interval_docs(range(2)),
)
#: corpora walked through every reachable layout: a props-free i8 chunk
#: (every elision on), an annotating one, the hard fixture (every row
#: kept, warm), and cold obliterate-carrying copies of it
LAYOUT_CORPORA = {
    "text-7x24": lambda: bench_docs(7, 24),
    "bench-10x24": lambda: bench_docs(10, 24),
    "hard": FOLD_CORPORA["hard"],
    "obliterate-lagged": lambda: _reference_docs(
        workload.cold_fixture_docs(2)),
}


def _reference_docs(port):
    from tests.torch_corpora import reference_doc

    return [reference_doc(d) for d in port]


@pytest.fixture(autouse=True)
def _xla_fold(monkeypatch):
    monkeypatch.delenv("FF_PALLAS_FOLD", raising=False)


def _leaves(ex):
    return ex if isinstance(ex, tuple) else (ex,)


def _assert_leaves_equal(want, got, label):
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), np.asarray(g)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (label, i)
        assert w.tobytes() == g.tobytes(), (label, i)


def _packed(docs):
    ref = ref_mt.pack_mergetree_batch(docs)
    port = mt.pack_mergetree_batch(port_docs(docs))
    return ref, port


def _warmths(docs):
    return ["warm"] if any(d.base_records for d in docs) \
        else ["cold", "warm"]


@pytest.mark.parametrize("digest", [False, True], ids=["core", "digest"])
@pytest.mark.parametrize("corpus", sorted(EXPORT_CORPORA))
def test_replay_export_matches_reference(corpus, digest):
    docs = EXPORT_CORPORA[corpus]()
    (r_st, r_ops, r_meta), (p_st, p_ops, p_meta) = _packed(docs)
    S = r_st.tstart.shape[1]
    warm = any(d.base_records for d in docs)
    want = ref_mt.export_to_numpy(ref_mt.replay_export(
        r_st if warm else None, r_ops, r_meta, S=S, digest=digest))
    got = mt.export_to_numpy(mt.replay_export(
        p_st if warm else None, p_ops, p_meta, S=S, digest=digest,
        device="cpu"))
    _assert_leaves_equal(want, got, corpus)
    assert mt._export_flags(p_meta) == ref_mt._export_flags(r_meta)


@pytest.mark.parametrize("corpus", sorted(LAYOUT_CORPORA))
def test_every_reachable_layout_matches_reference(corpus):
    """Each layout the chunk's facts allow, digest on and off, cold and
    warm: the port's leaves against the reference's export of the
    reference's own fold (the full XLA fold, whose state any layout's
    specialised fold equals)."""
    docs = LAYOUT_CORPORA[corpus]()
    (r_st, r_ops, r_meta), (p_st, p_ops, p_meta) = _packed(docs)
    S = r_st.tstart.shape[1]
    base = jnp.asarray(r_meta["doc_base"])
    fold = jax.jit(ref_mt.replay_vmapped)
    finals = {"warm": fold(r_st, r_ops)}
    if "cold" in _warmths(docs):
        finals["cold"] = finals["warm"]  # the packed state is the empty one
    seen = set()
    for label, m in workload.layout_metas(p_meta):
        layout = mt._export_flags(m)
        for warmth in _warmths(docs):
            for digest in (False, True):
                want = ref_mt._export_with_digest(
                    finals[warmth], base, *layout[:4], layout[4], digest)
                got = mt.export_to_numpy(mt.replay_export(
                    p_st if warmth == "warm" else None, p_ops, m, S=S,
                    digest=digest, device="cpu"))
                _assert_leaves_equal(want, got, (label, warmth, digest))
                assert _leaves(got)[0].shape[1] == mt.export_layout_rows(m)
                seen.add(label)
    assert len(seen) == len(list(workload.layout_metas(p_meta)))


def test_layouts_cover_every_width_and_elision():
    """The layout walk reaches every width and every elision somewhere."""
    labels = set()
    for corpus in LAYOUT_CORPORA.values():
        _st, _ops, meta = mt.pack_mergetree_batch(port_docs(corpus()))
        labels |= {label for label, _m in workload.layout_metas(meta)}
    for part in ("i8", "i16", "i32", "ob0", "ob1", "ov0", "ov1", "props0",
                 "props1"):
        assert any(part in label.split("-") for label in labels), part


@pytest.mark.parametrize("corpus", sorted(LAYOUT_CORPORA))
def test_export_layout_rows_matches_reference(corpus):
    _st, _ops, meta = mt.pack_mergetree_batch(
        port_docs(LAYOUT_CORPORA[corpus]()))
    for label, m in workload.layout_metas(meta):
        assert mt.export_layout_rows(m) == ref_mt.export_layout_rows(m), \
            label


def test_export_flags_ignore_ff_pallas_fold(monkeypatch):
    """The reference forces the props rows on under ``FF_PALLAS_FOLD``;
    the port reads no environment: props rows follow ``has_props``."""
    _st, _ops, meta = mt.pack_mergetree_batch(bench_docs(7, 24))
    assert meta["has_props"] is False
    unset = mt._export_flags(meta)
    monkeypatch.setenv("FF_PALLAS_FOLD", "interpret")
    assert mt._export_flags(meta) == unset
    assert unset[4] is False
    assert ref_mt._export_flags(meta)[4] is True  # the reference's switch


def test_i8_pairs_carry_negative_clients_and_round_trip():
    """A client index of -1 rides the i8 pair's high byte as 0xFF and
    widens back to -1; the whole export widens back to the int32 layout,
    natively and in Python, and its bytes equal the reference's."""
    docs = bench_docs(7, 40)
    (r_st, r_ops, r_meta), (p_st, p_ops, p_meta) = _packed(docs)
    assert mt._export_flags(p_meta)[3], "the chunk should pack to i8"
    final = mt.fold_reference(*(_tensors(p_st), _tensors(p_ops)))
    base = torch.from_numpy(p_meta["doc_base"])
    rows, misc = mt._export_state(final, base, i16=True, ob_rows=False,
                                  ov_rows=False, i8=True, props_rows=False)
    rows = rows.numpy()
    # fields: tstart | tlen, ins_seq | ins_client, rem_seq | rem_client, pad
    live = np.arange(rows.shape[2])[None, :] < final.n.numpy()[:, None]
    live_alive = live & (final.rem_client.numpy() == -1)
    assert live_alive.any()
    high = (rows[:, 3, :].astype(np.uint16) >> 8)
    assert (high[live_alive] == 0xFF).all()
    canon = mt.export_state(final).numpy()
    args = (p_meta["doc_base"], False, False, True, p_meta["props_K"],
            False)
    np.testing.assert_array_equal(mt.widen_export((rows, misc.numpy()),
                                                  *args), canon)
    np.testing.assert_array_equal(
        mt.widen_export_native((rows, misc.numpy()), *args), canon)
    ref_final = jax.jit(ref_mt.replay_vmapped)(r_st, r_ops)
    want = ref_mt._export_state(ref_final, jnp.asarray(r_meta["doc_base"]),
                                i16=True, ob_rows=False, ov_rows=False,
                                i8=True, props_rows=False)
    _assert_leaves_equal(want, (rows, misc.numpy()), "i8")


def _tensors(tree):
    from fluidframework_tpu_torch.convert import tensors_to

    return tensors_to(tree, torch.device("cpu"))


@pytest.mark.parametrize("corpus", ["hard", "text-7x24"])
def test_summaries_from_every_layout_match_the_oracle(corpus):
    """Extraction widens first, so every layout's export gives the same
    summaries: the oracle's, byte for byte."""
    ref_docs = LAYOUT_CORPORA[corpus]()
    docs = port_docs(ref_docs)
    st, ops, meta = mt.pack_mergetree_batch(docs)
    warm = any(d.base_records for d in docs)
    want = [ref_mt.oracle_fallback_summary(d).digest() for d in ref_docs]
    for label, m in workload.layout_metas(meta):
        ex = mt.replay_export(st if warm else None, ops, m,
                              S=st.tstart.shape[1], device="cpu")
        got = mt.summaries_from_export(m, mt.export_to_numpy(ex))
        assert [s.digest() for s in got] == want, label
