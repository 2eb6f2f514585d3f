"""The merge-tree record pack by document ranges (CPU).

``slice_mergetree_pack`` cuts a batch of binary streams into ``k``
ranges whose begin and finish steps run on several threads at once; its
join equals ``pack_mergetree_batch`` plane for plane and in meta, and the
JAX package's pack, while its ops come out in the upload encoding exactly
where ``narrow_ops_for_upload`` would narrow the whole pack's, and wide
where a bound breaks in any one range.  A malformed stream raises what the
whole pack raises.  Through the pipeline a binary chunk of 128 documents
or more packs in ranges (``stage["pack_tasks"]``), with the one-batch
entry's summaries; message documents and a pack cache keep one task a
chunk.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import native_pack
from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.ops.interning import Interner
from fluidframework_tpu_torch.protocol.messages import (MessageType,
                                                        SequencedMessage)
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import reference_doc

_META_FACTS = ("_S", "props_K", "i16_ok", "i8_ok", "ob_rows", "ov_rows",
               "has_props", "sequential", "prop_keys")
#: the documents of the late corpus that carry no op: first and last
#: documents of ranges at k = 2, 3 and 7 over its 42 documents
_EMPTY = {6, 13, 14, 20, 21, 28, 35, 36}
_VALUES = (1, "blue", None, {"w": [1, 2]}, 2.5, "é", 7)


def _msgs(i, n_ops, text="ab", annotate=False, n_clients=3, seq0=0):
    """A valid op stream: inserts of ``text``, removes and (with
    ``annotate``) annotates whose keys and values first appear here."""
    rng = random.Random(i)
    out, length = [], 0
    for t in range(n_ops):
        seq = seq0 + t + 1
        r = rng.random()
        if length < 4 or r < 0.55:
            s = text * rng.randint(1, 3)
            contents = {"kind": "insert", "pos": rng.randint(0, length),
                        "text": s}
            length += len(s)
        else:
            start = rng.randint(0, length - 2)
            end = min(length, start + rng.randint(1, 5))
            if annotate and r > 0.8:
                contents = {"kind": "annotate", "start": start, "end": end,
                            "props": {f"k{(i + t) % 3}":
                                      _VALUES[(i * 3 + t) % len(_VALUES)]}}
            else:
                contents = {"kind": "remove", "start": start, "end": end}
                length -= end - start
        out.append(SequencedMessage(
            seq=seq, client_id=f"c{t % n_clients}", client_seq=seq,
            ref_seq=seq - 1, min_seq=0, type=MessageType.OP,
            contents=contents))
    return out


def _doc(i, msgs):
    clients, keys, vals = Interner(), Interner(), Interner()
    blob = native_pack.encode_string_ops(msgs, clients, keys, vals)
    return mt.MergeTreeDocInput(
        doc_id=f"d{i}", ops=[], binary_ops=blob,
        binary_clients=list(clients.values),
        binary_prop_keys=list(keys.values) or None,
        binary_values=list(vals.values) or None,
        final_seq=msgs[-1].seq if msgs else 0, final_msn=0)


def _late_corpus():
    """42 documents: multi-byte text in the first ranges, empty documents
    at range boundaries, and annotates (their keys and values) only from
    document 30 on, in the last ranges at every k."""
    docs = []
    for i in range(42):
        if i in _EMPTY:
            docs.append(_doc(i, []))
        elif i < 6:
            docs.append(_doc(i, _msgs(i, 30 + i, text="é中😀x")))
        else:
            docs.append(_doc(i, _msgs(i, 20 + i % 9, annotate=i >= 30)))
    return docs


def _sliced(docs, k, narrow=True):
    """The record pack's steps as the pipeline runs them: the ranges'
    begins, then their finishes, on threads of their own."""
    pack = (mt.slice_mergetree_pack(docs, k) if narrow
            else native_pack.RecordPack(native_pack.load_library(), docs, k,
                                        narrow=False))
    try:
        pack.intern()
        with ThreadPoolExecutor(max_workers=k) as ex:
            for fut in [ex.submit(pack.begin, j) for j in range(k)]:
                fut.result()
            pack.size()
            for fut in [ex.submit(pack.finish, j)
                        for j in reversed(range(k))]:
                fut.result()
        return pack.join()
    finally:
        pack.close()


def _assert_ops_equal(want, got):
    for f in mt.MTOps._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_packs_equal(want, got):
    """State and meta bit for bit (the ops are the callers' to compare)."""
    (w_state, _w_ops, w_meta), (g_state, _g_ops, g_meta) = want, got
    for f in mt.MTState._fields:
        a, b = getattr(w_state, f), getattr(g_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for k in _META_FACTS:
        assert w_meta[k] == g_meta[k], k
    assert g_meta.keys() == w_meta.keys()
    assert g_meta["doc_base"].dtype == np.int32
    np.testing.assert_array_equal(w_meta["doc_base"], g_meta["doc_base"])
    assert len(w_meta["arena"]) == len(g_meta["arena"])
    assert w_meta["arena"].finalize() == g_meta["arena"].finalize()
    assert list(w_meta["values"].values) == list(g_meta["values"].values)
    for wp, gp in zip(w_meta["doc_packs"], g_meta["doc_packs"],
                      strict=True):
        assert list(wp.clients.values) == list(gp.clients.values)
        assert wp.needs_fallback == gp.needs_fallback
        assert wp.interval_ops == gp.interval_ops == []


@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_the_sliced_pack_equals_the_whole_and_the_jax_package(k):
    """Cut into ``k`` ranges, the record pack's join equals the whole pack
    and the JAX package's: keys and values that first appear in a later
    range keep the batch's order, multi-byte text keeps ``doc_base`` in
    chars, empty documents sit at range boundaries; its ops are
    ``narrow_ops_for_upload`` of the whole pack's, and without ``narrow``
    the whole pack's int32 rows."""
    docs = _late_corpus()
    whole = mt.pack_mergetree_batch(docs)
    ref = ref_mt.pack_mergetree_batch([reference_doc(d) for d in docs])
    _assert_packs_equal(ref, whole)
    _assert_ops_equal(ref[1], whole[1])
    got = _sliced(docs, k)
    _assert_packs_equal(whole, got)
    assert got[2]["docs"] is docs
    narrowed = mt.narrow_ops_for_upload(whole[1], whole[2])
    assert narrowed.seq.dtype == np.int16
    _assert_ops_equal(narrowed, got[1])
    assert mt.narrow_ops_for_upload(got[1], got[2]) is got[1]
    wide = _sliced(docs, k, narrow=False)
    _assert_packs_equal(whole, wide)
    _assert_ops_equal(whole[1], wide[1])
    # the late corpus holds what the test names
    meta = got[2]
    assert sorted(meta["prop_keys"]) == ["k0", "k1", "k2"]
    assert len(meta["values"]) == len(_VALUES) - 1   # None: PROP_ABSENT
    assert min(d for d, doc in enumerate(docs) if doc.binary_prop_keys) \
        >= 30
    text = meta["arena"].finalize()
    assert len(text.encode("utf-8")) > len(text)
    assert all(not docs[d].binary_ops for d in _EMPTY)


def _big_text_doc(i, n_chars):
    msgs = [SequencedMessage(seq=1, client_id="c0", client_seq=1, ref_seq=0,
                             min_seq=0, type=MessageType.OP,
                             contents={"kind": "insert", "pos": 0,
                                       "text": "x" * n_chars})]
    return _doc(i, msgs)


def _empty_insert_doc(i):
    msgs = [SequencedMessage(seq=1, client_id="c0", client_seq=1, ref_seq=0,
                             min_seq=0, type=MessageType.OP,
                             contents={"kind": "insert", "pos": 0,
                                       "text": ""})]
    return _doc(i, msgs)


def _breaking(case):
    """The late corpus with one bound of the narrow encoding broken in one
    range only (the last, or a middle one); whether ``i16_ok`` still
    holds."""
    docs = _late_corpus()
    if case == "seq":          # a seq past the int16 fact
        docs[40] = _doc(40, _msgs(40, 12, seq0=40_000))
        return docs, False
    if case == "text":         # a document longer than the int16 fact
        docs[24] = _big_text_doc(24, 40_000)
        return docs, False
    if case == "client":       # 130 clients: int16 holds, int8 does not
        docs[33] = _doc(33, _msgs(33, 140, n_clients=130))
        return docs, True
    if case == "remove_text":  # text on a remove: its tstart is not 0
        docs[30].binary_ops = _records((1, 1, b"abc", []), (2, 2, b"z", []))
        docs[30].binary_prop_keys = docs[30].binary_values = None
        return docs, True
    # an empty insert past 32,768 chars of earlier text: its rebased
    # tstart (-doc_base) leaves int16
    for d in (22, 23, 24):
        docs[d] = _big_text_doc(d, 12_000)
    docs[38] = _empty_insert_doc(38)
    return docs, True


@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("case", ["seq", "text", "client", "remove_text",
                                  "empty_insert"])
def test_a_bound_broken_in_one_range_keeps_the_whole_chunk_wide(case, k):
    docs, i16_ok = _breaking(case)
    whole = mt.pack_mergetree_batch(docs)
    assert whole[2]["i16_ok"] is i16_ok
    assert mt.narrow_ops_for_upload(whole[1], whole[2]) is whole[1]
    got = _sliced(docs, k)
    _assert_packs_equal(whole, got)
    _assert_ops_equal(whole[1], got[1])
    assert got[1].seq.dtype == np.int32


def _records(*recs):
    """Raw binary records: (kind, seq, text bytes, pairs)."""
    out = b""
    for kind, seq, text, pairs in recs:
        out += native_pack._HEADER.pack(kind, seq, seq - 1, 0, 0, 0, 0,
                                        len(pairs), len(text))
        for pair in pairs:
            out += native_pack._PAIR.pack(*pair)
        out += text
    return out


def _malformed(case, k):
    docs = _late_corpus()
    late = len(docs) * (k - 1) // k + 1
    if case == "truncated":
        for d in (late, len(docs) - 1):
            docs[d].binary_ops = docs[d].binary_ops[:-3]
    elif case == "key_id":     # a key id past the document's key table
        docs[late].binary_ops = _records((3, 1, b"", [(5, 0)]))
        docs[late].binary_prop_keys = ["k9"]
        docs[late].binary_values = [3]
    else:                      # a character split across two documents
        docs[late - 1].binary_ops = _records((1, 1, b"a\xc3", []))
        docs[late].binary_ops = _records((1, 1, b"\xa9b", []))
    return docs


@pytest.mark.parametrize("k", [2, 3, 7])
@pytest.mark.parametrize("case", ["truncated", "key_id", "split_char"])
def test_the_sliced_pack_raises_what_the_whole_pack_raises(case, k):
    docs = _malformed(case, k)
    with pytest.raises((ValueError, UnicodeDecodeError)) as whole:
        mt.pack_mergetree_batch(docs)
    with pytest.raises((ValueError, UnicodeDecodeError)) as sliced:
        _sliced(docs, k)
    assert type(sliced.value) is type(whole.value)
    assert str(sliced.value) == str(whole.value)


def _binary_docs(n, n_ops=12):
    return [workload.synth_doc(i, n_ops) for i in range(n)]


def _message_docs(docs):
    return [mt.MergeTreeDocInput(
        doc_id=d.doc_id, ops=native_pack.decode_string_ops(
            d.binary_ops, list(d.binary_clients), d.binary_prop_keys,
            d.binary_values),
        final_seq=d.final_seq, final_msn=d.final_msn) for d in docs]


def test_a_binary_chunk_packs_in_ranges_through_the_pipeline():
    """1,024 + 130 binary documents at the defaults pack as 7 + 2 ranges,
    with the one-batch entry's summaries and the unsliced pipeline's
    counts; the same documents as messages, or with a pack cache, pack
    one task a chunk."""
    import dataclasses

    docs = _binary_docs(1024 + 130)
    want = [s.digest() for s in mt.replay_mergetree_batch(docs,
                                                          device="cpu")]
    stage, stats = {}, {}
    got = pipeline.pipelined_mergetree_replay(docs, stage=stage, stats=stats,
                                              device="cpu")
    assert stage["pack_tasks"] == 7 + 2
    assert [s.digest() for s in got] == want
    whole_family = dataclasses.replace(pipeline.MERGETREE_FAMILY,
                                       slice_pack=None)
    w_stage, w_stats = {}, {}
    whole = pipeline.pipelined_family_replay(
        whole_family, docs, stage=w_stage, stats=w_stats, device="cpu")
    assert w_stage["pack_tasks"] == 2
    assert [s.digest() for s in whole] == want
    assert stats == w_stats
    assert stage["h2d_bytes"] == w_stage["h2d_bytes"]
    m_stage = {}
    msgs = pipeline.pipelined_mergetree_replay(
        _message_docs(docs), stage=m_stage, device="cpu")
    assert m_stage["pack_tasks"] == 2
    assert [s.digest() for s in msgs] == want
    c_stage = {}
    cached = pipeline.pipelined_mergetree_replay(
        docs, stage=c_stage, pack_cache=pipeline.PackCache(), device="cpu")
    assert c_stage["pack_tasks"] == 2
    assert [s.digest() for s in cached] == want
