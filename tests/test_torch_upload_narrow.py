"""The port's upload-side narrow encoding against the JAX package's, and
its round trips (mirrors tests/test_upload_narrow.py).

``narrow_ops_for_upload`` / ``narrow_state_for_upload`` give the same
arrays as the reference's (dtype and bytes); the device decode
(``_widen_ops`` / ``_widen_state``, and the kernel wrapper's encoding
check) restores the wide arrays and refuses any other encoding; every
bounds re-check falls back to the wide stream; the native widen of an
export equals the Python widen on every layout."""

import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.convert import tensors_to
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops.native_pack import load_library
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import (FOLD_CORPORA, bench_docs, port_docs,
                                 warm_doc)

CPU = torch.device("cpu")
NARROW_CORPORA = dict(
    FOLD_CORPORA,
    warm=lambda: [warm_doc(9), warm_doc(11)],
)


def _both(docs):
    return (ref_mt.pack_mergetree_batch(docs),
            mt.pack_mergetree_batch(port_docs(docs)))


def _assert_trees_equal(want, got):
    assert type(want).__name__ == type(got).__name__
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        assert (w.dtype, w.shape) == (g.dtype, g.shape), f
        assert w.tobytes() == g.tobytes(), f


@pytest.mark.parametrize("corpus", sorted(NARROW_CORPORA))
def test_narrow_arrays_match_reference(corpus):
    (r_st, r_ops, r_meta), (p_st, p_ops, p_meta) = _both(
        NARROW_CORPORA[corpus]())
    _assert_trees_equal(ref_mt.narrow_ops_for_upload(r_ops, r_meta),
                        mt.narrow_ops_for_upload(p_ops, p_meta))
    _assert_trees_equal(ref_mt.narrow_state_for_upload(r_st, r_meta),
                        mt.narrow_state_for_upload(p_st, p_meta))


def test_narrow_dtype_table_matches_reference():
    assert set(mt._UPLOAD_NARROW_DTYPES) == set(mt.MTOps._fields)
    assert mt._UPLOAD_NARROW_DTYPES == ref_mt._UPLOAD_NARROW_DTYPES


def _export_bytes(state, ops, meta, S):
    ex = mt.export_to_numpy(mt.replay_export(state, ops, meta, S=S,
                                             device="cpu"))
    return tuple(leaf.tobytes() for leaf in (ex if isinstance(ex, tuple)
                                             else (ex,)))


@pytest.mark.parametrize("corpus,warm", [("bench", False), ("fuzz", False),
                                         ("warm", True)])
def test_narrow_and_wide_uploads_export_the_same_bytes(corpus, warm):
    """Numpy inputs are narrowed for the upload; tensors already on the
    device ride as they are (wide).  The exports are byte-identical."""
    docs = {"bench": lambda: port_docs(bench_docs(24, 48)),
            "fuzz": lambda: port_docs(FOLD_CORPORA["fuzz-1"]()),
            "warm": lambda: port_docs([warm_doc(220), warm_doc(221)])}[corpus]()
    state, ops, meta = mt.pack_mergetree_batch(docs)
    assert meta["i16_ok"]
    narrow = mt.narrow_ops_for_upload(ops, meta)
    assert narrow.seq.dtype == np.int16 and narrow.kind.dtype == np.int8
    saved = sum(x.nbytes for x in ops) - sum(x.nbytes for x in narrow)
    assert saved > 0
    S = state.tstart.shape[1]
    st = state if warm else None
    with_narrow = _export_bytes(st, ops, meta, S)
    wide = _export_bytes(tensors_to(st, CPU), tensors_to(ops, CPU), meta, S)
    assert with_narrow == wide


def test_narrow_state_roundtrip_exact():
    state, _ops, meta = mt.pack_mergetree_batch(port_docs([warm_doc(230)]))
    narrow = mt.narrow_state_for_upload(state, meta)
    assert narrow.ins_seq.dtype == np.int16, "warm chunk should narrow"
    widened = mt._widen_state(tensors_to(narrow, CPU),
                              torch.from_numpy(meta["doc_base"]))
    for f in state._fields:
        np.testing.assert_array_equal(getattr(widened, f).numpy(),
                                      getattr(state, f), err_msg=f)


def test_narrow_ops_roundtrip_exact():
    _state, ops, meta = mt.pack_mergetree_batch(port_docs(bench_docs(8, 40)))
    narrow = mt.narrow_ops_for_upload(ops, meta)
    widened = mt._widen_ops(tensors_to(narrow, CPU),
                            torch.from_numpy(meta["doc_base"]))
    for f in ops._fields:
        np.testing.assert_array_equal(getattr(widened, f).numpy(),
                                      getattr(ops, f), err_msg=f)


def test_narrow_state_sentinel_collision_falls_back():
    """A genuine seq of 32767 (the remapped sentinel's value) in a
    sentinel plane forces the wide upload."""
    state, _ops, meta = mt.pack_mergetree_batch(port_docs([warm_doc(231)]))
    assert meta["i16_ok"] and int(state.n[0]) > 0
    bad_rem = np.array(state.rem_seq)
    bad_rem[0, 0] = 32767  # == I16_NOT_REMOVED, but a "real" value here
    bad = state._replace(rem_seq=bad_rem)
    out = mt.narrow_state_for_upload(bad, meta)
    assert out.rem_seq.dtype == np.int32 and out.ins_seq is bad.ins_seq
    assert ref_mt.narrow_state_for_upload(bad, meta).rem_seq.dtype \
        == np.int32


def test_widen_refuses_unknown_dtype():
    """A non-int32, non-narrow encoding is refused with ``TypeError`` by
    the one encoding check, ``upload_encoding``, which the plain decode
    and the kernel wrapper (before any launch) both go through."""
    _state, ops, meta = mt.pack_mergetree_batch(port_docs(bench_docs(2, 16)))
    t = tensors_to(ops, CPU)
    bad = t._replace(seq=t.seq.to(torch.int8))
    base = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(TypeError, match="seq dtype"):
        mt._widen_ops(bad, base)
    with pytest.raises(TypeError, match="seq dtype"):
        mt.upload_encoding(bad)
    mixed = tensors_to(mt.narrow_ops_for_upload(ops, meta), CPU)
    mixed = mixed._replace(kind=mixed.kind.to(torch.int16))
    with pytest.raises(TypeError, match="kind"):
        mt._widen_ops(mixed, base)
    assert mt.upload_encoding(t) is False
    assert mt.upload_encoding(
        tensors_to(mt.narrow_ops_for_upload(ops, meta), CPU)) is True
    st = tensors_to(mt.cold_start(t, 32), CPU)
    assert mt.upload_encoding(st) is False
    with pytest.raises(TypeError, match="ins_seq dtype"):
        mt._widen_state(st._replace(ins_seq=st.ins_seq.to(torch.int8)), base)
    with pytest.raises(TypeError, match="ins_seq dtype"):
        mt.upload_encoding(st._replace(ins_seq=st.ins_seq.long()))
    with pytest.raises(TypeError, match="overflow"):
        mt.upload_encoding(st._replace(overflow=st.overflow.int()))


def test_narrow_skips_non_qualifying_and_device_streams():
    state, ops, meta = mt.pack_mergetree_batch(port_docs(bench_docs(4, 32)))
    # not i16_ok → identity (same objects, no copies)
    wide = mt.narrow_ops_for_upload(ops, dict(meta, i16_ok=False))
    assert wide.seq is ops.seq
    # already-narrow stream → identity
    narrow = mt.narrow_ops_for_upload(ops, meta)
    assert mt.narrow_ops_for_upload(narrow, meta).seq is narrow.seq
    # a stream already on a device → identity
    on_dev = tensors_to(ops, CPU)
    assert mt.narrow_ops_for_upload(on_dev, meta).seq is on_dev.seq
    assert mt.narrow_state_for_upload(tensors_to(state, CPU), meta) \
        .ins_seq.dtype == torch.int32


def test_narrow_bounds_recheck_falls_back_to_wide():
    _state, ops, meta = mt.pack_mergetree_batch(port_docs(bench_docs(4, 32)))
    bad_client = np.array(ops.client)
    bad_client[0, 0] = 1000  # exceeds the int8 client row
    bad = ops._replace(client=bad_client)
    out = mt.narrow_ops_for_upload(bad, meta)
    assert out.client.dtype == np.int32 and out.seq is bad.seq


def _layout_exports():
    """(label, meta, export) over every layout of three chunks: props-free
    i8 (every elision), annotating, and warm."""
    cases = {
        "text": (port_docs(bench_docs(7, 40)), False),
        "props": (port_docs([bench_docs(12, 40)[i] for i in (7, 8, 9, 1)]),
                  False),
        "warm": (port_docs([warm_doc(240), warm_doc(241)]), True),
    }
    for name, (docs, warm) in cases.items():
        state, ops, meta = mt.pack_mergetree_batch(docs)
        for label, m in workload.layout_metas(meta):
            ex = mt.export_to_numpy(mt.replay_export(
                state if warm else None, ops, m, S=state.tstart.shape[1],
                device="cpu"))
            yield f"{name}:{label}", m, ex


def test_native_widen_matches_python_widen_all_layouts():
    """oppack_widen vs widen_export: byte-identical canonical buffers on
    every transfer layout the export can emit; int32 buffers pass through
    to the Python path (the native widen declines them)."""
    assert load_library() is not None
    widths = set()
    for label, m, ex in _layout_exports():
        _i16, ob, ov, i8, props = mt._export_flags(m)
        args = (m.get("doc_base"), ob, ov, i8, m["props_K"], props)
        py = mt.widen_export(ex, *args)
        native = mt.widen_export_native(ex, *args)
        if m["i16_ok"]:
            assert native is not None, label
            np.testing.assert_array_equal(native, py, err_msg=label)
            assert native.dtype == np.int32
        else:
            assert native is None, label
        widths.add(label.split(":")[1].split("-")[0])
    assert widths == {"i8", "i16", "i32"}


def test_native_widen_rejects_malformed_desc_table():
    """oppack_widen bounds-checks the desc table: a ROW16 source index past
    R_src, a PAIR8 pair index past R_src, an unknown mode, or a MISC row
    without the misc leaf all return -1."""
    lib = load_library()
    assert lib is not None
    D, S, R_src = 1, 4, 2
    src = np.zeros((D, R_src, S), np.int16)
    dst = np.zeros((D, 2, S), np.int32)

    def widen(desc_rows, misc=None):
        desc = np.asarray(desc_rows, np.int32).reshape(-1)
        misc_ptr = misc.ctypes.data if misc is not None else None
        misc_cols = misc.shape[1] if misc is not None else 0
        return lib.oppack_widen(src, D, S, R_src, len(desc_rows), misc_ptr,
                                misc_cols, desc, None, 32767, 2147483647, dst)

    assert widen([(1, 0, 0, 0), (1, 1, 0, 0)]) == 0
    assert widen([(1, 2, 0, 0), (1, 1, 0, 0)]) == -1
    assert widen([(2, 4, 0, 0), (1, 1, 0, 0)]) == -1
    assert widen([(7, 0, 0, 0), (1, 1, 0, 0)]) == -1
    assert widen([(3, 0, 0, 0), (1, 1, 0, 0)]) == -1
    misc = np.zeros((D, 4), np.int16)
    assert widen([(3, 0, 0, 0), (1, 1, 0, 0)], misc) == 0
