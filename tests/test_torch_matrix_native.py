"""SharedMatrix message records, the native matrix pack and the native
matrix summary writer against the Python pack and writer.

``encode_matrix_ops`` / ``decode_matrix_ops`` give back every message;
``matrix_native.pack_records`` fills every op plane of
``pack_matrix_batch`` bit for bit, with the same cell tables, policy
switches and buckets; ``write_summaries`` writes the ``header`` and
``body`` bytes of ``summary_from_matrix_state`` from the same folded
planes, on seeded ``gen_matrix_doc`` pools, on the committed fixture
(``hard_matrix_docs``: the LWW and FWW fuzz logs; its base-summary
documents keep the Python pack, which the pipeline tests cover) and on
every crafted case."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import matrix_kernel as mk
from fluidframework_tpu_torch.ops import matrix_native as mn
from fluidframework_tpu_torch.ops.matrix_fold_cuda import fold_resolving
from fluidframework_tpu_torch.ops.matrix_pipeline import (
    EXPORT_FIELDS, _matrix_dispatch, _matrix_pack)
from fluidframework_tpu_torch.protocol.messages import (MessageType,
                                                        SequencedMessage)
from fluidframework_tpu_torch.testing import config_workloads as cw

torch.set_num_threads(1)


def _pool(seed: int, n_docs: int = 12, n_ops: int = 160):
    return [cw.gen_matrix_doc(seed * 1000 + i, n_ops) for i in range(n_docs)]


def _no_base(docs):
    return [d for d in docs if d.base_summary is None]


CORPORA = {
    "pool0": lambda: _pool(0),
    "pool1": lambda: _pool(1, n_docs=9, n_ops=300),
    "pool2": lambda: _pool(2, n_docs=5, n_ops=40),
    "fixture": lambda: _no_base(cw.hard_matrix_docs()),
    "crafted": lambda: [cw.crafted_matrix_doc(c) for c in cw.CRAFTED_MATRIX],
}


def _records(docs):
    return [dataclasses.replace(d, ops=[],
                                records=mn.encode_matrix_ops(d.ops))
            for d in docs]


def _cells_by_value(pack, values):
    """A pack's cell rows with each value id read through its table."""
    return [(s, r, c, values.lookup(v), rr, cr)
            for s, r, c, v, rr, cr in pack.cells]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_records_give_back_every_message(corpus):
    docs = CORPORA[corpus]()
    for doc, rec in zip(docs, _records(docs)):
        assert mn.decode_matrix_ops(rec.records) == list(doc.ops)
        assert mk.doc_messages(rec) == list(doc.ops)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_pack_equals_python_pack_plane_for_plane(corpus):
    docs = CORPORA[corpus]()
    state, ops, meta = mk.pack_matrix_batch(docs)
    none, n_ops, n_meta = mn.pack_records(_records(docs))
    assert none is None and n_meta["cold"] and meta["cold"]
    for f in mk.MTOps._fields:
        want, got = getattr(ops, f), getattr(n_ops, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    assert n_meta["S"] == state.tstart.shape[1]
    assert n_meta["native_docs"] == len(docs)
    for p, q in zip(meta["packs"], n_meta["packs"]):
        assert _cells_by_value(q, q.values) \
            == _cells_by_value(p, meta["values"])
        assert q.fww_from_seq == p.fww_from_seq
        assert q.clients.values == p.clients.values
    assert n_meta["resolve_rows"] == int((ops.kind == mk.K_RESOLVE).sum())


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_pack_in_ranges_equals_pack_whole(k):
    recs = _records(_pool(3, n_docs=11, n_ops=120))
    _n, whole, w_meta = mn.pack_records(recs)
    pack = mn.RecordPack(mn.load_library(), recs, k)
    pack.intern()
    for j in reversed(range(k)):
        pack.begin(j)
    pack.size()
    for j in range(k):
        pack.finish(j)
    _n, ranged, r_meta = pack.join()
    for f in mk.MTOps._fields:
        assert np.array_equal(getattr(ranged, f), getattr(whole, f)), f
    assert np.array_equal(r_meta["cells"], w_meta["cells"])
    assert np.array_equal(r_meta["fww"], w_meta["fww"])


def _folded(docs):
    """``docs`` packed both ways, folded on the CPU and exported as the
    pipeline exports a chunk: (Python meta, native meta, export dict)."""
    state, ops, meta = _matrix_pack(docs)
    _n, n_ops, n_meta = _matrix_pack(_records(docs))
    export = _matrix_dispatch(None, mk.MTOps(*(torch.from_numpy(x)
                                               for x in n_ops)),
                              n_meta, False, None)
    arr = {f: x.numpy() for f, x in zip(EXPORT_FIELDS, export)}
    return meta, n_meta, arr, (state, ops)


def _python_summaries(meta, state, ops):
    final, resolved, _v = fold_resolving(
        mk.MTState(*(torch.from_numpy(np.asarray(x)) for x in state)),
        mk.MTOps(*(torch.from_numpy(x) for x in ops)))
    state_np = {f: getattr(final, f).numpy() for f in mk.MTState._fields}
    return [mk.summary_from_matrix_state(meta, state_np, resolved.numpy(), d)
            for d in range(len(meta["docs"]))]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_native_writer_equals_python_writer_byte_for_byte(corpus):
    docs = CORPORA[corpus]()
    meta, n_meta, arr, (state, ops) = _folded(docs)
    want = _python_summaries(meta, state, ops)
    got = mn.write_summaries(n_meta, arr, range(len(docs)))
    overflowed = arr["overflow"].any(axis=1)
    assert overflowed.sum() == (corpus == "fixture")  # the third remover
    for d, ((header, body, cells), tree) in enumerate(zip(got, want)):
        assert tree.digest() == mk.oracle_matrix_fallback(docs[d]).digest()
        if overflowed[d]:
            assert (header, body, cells) == (None, None, mn.OVERFLOW)
            continue
        assert header == tree.blob_bytes("header"), d
        assert body == tree.blob_bytes("body"), d
        assert cells == len(json.loads(body)["cells"])


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_no_stream_outgrows_the_exported_width(corpus):
    """The width bound (two slots an insert or remove) holds on every
    stream, so the cut export holds every slot the summaries read."""
    docs = CORPORA[corpus]()
    _meta, n_meta, arr, _packed = _folded(docs)
    assert arr["n"].max() <= n_meta["width"] == arr["tstart"].shape[2]
    assert n_meta["width"] <= n_meta["S"]


def test_writer_leaves_an_overflowed_axis_and_a_slot_past_the_width():
    docs = _pool(4, n_docs=6, n_ops=80)
    _meta, n_meta, arr, _packed = _folded(docs)
    arr["overflow"] = arr["overflow"].copy()
    arr["overflow"][1, 1] = True
    arr["n"] = arr["n"].copy()
    arr["n"][3, 0] = arr["tstart"].shape[2] + 1
    got = mn.write_summaries(n_meta, arr, range(len(docs)))
    assert got[1] == (None, None, mn.OVERFLOW)
    assert got[3] == (None, None, mn.OUTSIDE)
    assert all(g[0] is not None for d, g in enumerate(got)
               if d not in (1, 3))


def test_writer_writes_a_chosen_subset_of_rows():
    docs = _pool(5, n_docs=8, n_ops=90)
    _meta, n_meta, arr, _packed = _folded(docs)
    whole = mn.write_summaries(n_meta, arr, range(len(docs)))
    some = mn.write_summaries(n_meta, arr, [6, 1, 4])
    assert some == [whole[6], whole[1], whole[4]]


def _msg(seq, contents, client="c0", type_=MessageType.OP):
    return SequencedMessage(seq=seq, client_id=client, client_seq=seq,
                            ref_seq=seq - 1, min_seq=0, type=type_,
                            contents=contents)


@pytest.mark.parametrize("msgs", [
    [_msg(1, {"kind": "insertRows", "pos": 0, "count": 1, "x": 1})],
    [_msg(1, {"kind": "setPolicy", "policy": "lww"})],
    [_msg(1, {"kind": "insertRows", "pos": 0, "count": 2 ** 31})],
    [_msg(1, {"kind": "insertRows", "pos": True, "count": 1})],
    [_msg(1, {"kind": "setCell", "row": 0, "col": 0, "value": 1}),
     _msg(2, {"kind": "setCell", "row": 0, "col": 0, "value": True})],
    [_msg(1, {"kind": "setCell", "row": 0, "col": 0, "value": {1, 2}})],
    [_msg(1, None, type_=MessageType.JOIN)],
], ids=["extra-key", "lww-policy", "int32", "bool-pos", "1-and-true",
        "no-json", "join"])
def test_encoder_refuses_what_records_cannot_carry(msgs):
    with pytest.raises(ValueError):
        mn.encode_matrix_ops(msgs)


def test_records_carry_timestamps_null_clients_and_the_policy():
    msgs = [_msg(1, {"kind": "insertRows", "pos": 0, "count": 2}),
            _msg(2, {"kind": "insertCols", "pos": 0, "count": 1},
                 client=None),
            _msg(3, {"kind": "setPolicy", "policy": "fww"}),
            _msg(4, {"kind": "setCell", "row": 1, "col": 0,
                     "value": {"b": [1, "é"], "a": None}})]
    msgs[1] = dataclasses.replace(msgs[1], timestamp=12.5)
    rec = mn.encode_matrix_ops(msgs)
    assert mn.decode_matrix_ops(rec) == msgs
    assert (rec.n_cells, rec.row_rows, rec.col_rows) == (1, 2, 2)
    header = np.frombuffer(rec.blob, np.int32, mn.HEADER_FIELDS)
    assert header[7] == mn.F_NULL_CLIENT | mn.F_TIMESTAMPS


def _truncated(blob: bytes) -> bytes:
    return blob[:-1]


def _cells_understated(blob: bytes) -> bytes:
    """The header counts one setCell fewer than the stream holds (the
    pack sizes the cell table from that count)."""
    header = np.frombuffer(blob, np.int32, mn.HEADER_FIELDS).copy()
    header[4] -= 1
    return header.tobytes() + blob[header.nbytes:]


@pytest.mark.parametrize("spoil", [_truncated, _cells_understated],
                         ids=["truncated", "cells-understated"])
def test_a_malformed_stream_names_its_document(spoil):
    recs = _records(_pool(6, n_docs=3, n_ops=30))
    bad = recs[1].records
    assert bad.n_cells > 0
    recs[1] = dataclasses.replace(recs[1], records=dataclasses.replace(
        bad, blob=spoil(bad.blob)))
    with pytest.raises(ValueError, match=recs[1].doc_id):
        mn.pack_records(recs)
