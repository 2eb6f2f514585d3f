"""The native tree summary writer (CPU): ``tree_native.write_headers``, which
``tree_pipeline.summaries_from_tree_export`` routes every document it can
take to, against ``tree_kernel.summary_from_state``, the Python route.

For every document the headers are the same bytes, and ``stats`` and the
stage counts the same (``extract_native_docs`` apart, which counts the
documents the writer wrote).  The corpora: the benchmark's ``tree_long``
pool, the pinned tree workload's five shapes as messages and as records,
limbo, a base summary above the final ``min_seq``, removed nodes not yet
purged, empty documents, adversarial strings, values of every JSON type,
a chain cycle (the oracle's route, counted), an attribution document and
a batch without the library (the Python route, the same bytes), and the
pipeline's document slices with those documents on the slice boundaries.
The JAX package's pipeline gives the same summaries and stats where it
runs the documents (record documents through their decoded messages).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.tree import SharedTree as RefTree
from fluidframework_tpu.ops import tree_kernel as ref_tk
from fluidframework_tpu.ops import tree_pipeline as ref_tp
from fluidframework_tpu.protocol.messages import MessageType as RefType
from fluidframework_tpu.protocol.messages import \
    SequencedMessage as RefMessage
from fluidframework_tpu_torch.convert import tensors_to, tree_doc_input_from
from fluidframework_tpu_torch.ops import pipeline
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops import tree_native as tn
from fluidframework_tpu_torch.ops import tree_pipeline as tp
from fluidframework_tpu_torch.ops.tree_fold_cuda import fold
from portbench import run, sharedtree
from tools.bench_kernels import synth_tree_messages, tree_doc, tree_shape

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- documents -----------------------------------------------------------------


def _msg(seq, min_seq, *edits, client="c"):
    return RefMessage(seq=seq, client_id=client, client_seq=seq,
                      ref_seq=seq - 1, min_seq=min_seq, type=RefType.OP,
                      contents={"edits": list(edits)}, timestamp=0.0)


def _ref_msg(m):
    return RefMessage(seq=m.seq, client_id=m.client_id,
                      client_seq=m.client_seq, ref_seq=m.ref_seq,
                      min_seq=m.min_seq, type=RefType(m.type.value),
                      contents=m.contents, timestamp=m.timestamp)


def _leaf(nid, typ="leaf", **extra):
    return {"id": nid, "type": typ, **extra}


def _insert(parent, field, *content, anchor=None):
    return {"kind": "insert", "parent": parent, "field": field,
            "anchor": anchor, "content": list(content)}


def _ref_doc(doc_id, msgs, final_msn=None, **kw):
    return ref_tk.TreeDocInput(
        doc_id, ops=msgs, final_seq=msgs[-1].seq if msgs else 0,
        final_msn=(msgs[-1].min_seq if msgs else 0) if final_msn is None
        else final_msn,
        **kw)


def _limbo():
    """A parent removed and purged under its kept children: they surface
    in ``limbo``, sorted by id in code-point order (the astral id after
    U+FFFF, where UTF-16 order would put it before)."""
    kids = [_leaf(i, value=n) for n, i in enumerate(
        ["z", "\U0001F600", "\uffff", "a\"b", "é", "a", "A\\"])]
    return _ref_doc("limbo", [
        _msg(1, 0, _insert("", "a", _leaf("p", "box", fields={"x": kids}))),
        _msg(2, 0, _insert("", "b", _leaf("keep", value=1))),
        _msg(3, 1, {"kind": "remove", "ids": ["p"]}),
        _msg(4, 3, {"kind": "set", "id": "keep", "value": 2}),
        _msg(5, 4, {"kind": "set", "id": "é", "value": [1, {"b": 2}]}),
    ])


def _removed_unpurged():
    """Removals the final ``min_seq`` has not reached: emitted with their
    ``removedSeq``; one purged beside them."""
    return _ref_doc("unpurged", [
        _msg(1, 0, _insert("", "a", _leaf("x", value=1), _leaf("y"),
                           _leaf("z", fields={"k": [_leaf("zz")]}))),
        _msg(2, 0, {"kind": "remove", "ids": ["x"]}),
        _msg(3, 1, {"kind": "remove", "ids": ["z"]}),
        _msg(4, 2, {"kind": "set", "id": "y", "value": "v"}),
    ])


#: ids, types and field names a JSON writer can get wrong
ODD = ['q"uote', "back\\slash", "nul\x00in", "ctl\x01\x1f\x7f", "tab\tnl\n",
       "\r\b\f", "é中文", "astral\U0001F600\U00010000", "", " ", "\ud7ff",
       "\ue000", "\uffff"]


def _adversarial():
    # "" is the root's id: the odd strings name the other nodes
    specs = [_leaf(s, typ=s, value=s) for s in ODD if s]
    nested = _leaf("outer", typ="o", fields={f: [_leaf(f"in{i}", typ=f)]
                                             for i, f in enumerate(ODD)})
    return _ref_doc("odd", [
        _msg(1, 0, _insert("", "a\"\\\x00é\U0001F600", *specs)),
        _msg(2, 0, _insert("", "\U0001F600", nested)),
        _msg(3, 0, _insert("", "\uffff", _leaf("w"))),
    ])


#: a value of every JSON type; no two top-level values equal in Python
#: (0, False and -0.0 share one interned value, as 1 and True do)
VALUES = [None, True, 0, -7, 2 ** 40, 0.1, 1e16, 1.5e-7, 3.141592653589793,
          "", "s\"\\\x00é\U0001F600", [], {}, [False, -0.0, 1],
          [1, [2.5, None], {"z": 1, "a": [True]}],
          {"é": {"\U0001F600": "x", "a\"": [False]}, "b": None}]


def _values():
    return _ref_doc("values", [
        _msg(1, 0, _insert("", "a", *[_leaf(f"v{i}", value=v)
                                      for i, v in enumerate(VALUES)])),
        _msg(2, 0, {"kind": "set", "id": "v1", "value": {"set": [1, 2]}}),
        _msg(3, 1, {"kind": "set", "id": "v3", "value": None}),
    ])


def _empty():
    return [_ref_doc("empty", []),
            _ref_doc("root-only", [_msg(1, 0, {"kind": "remove",
                                               "ids": ["ghost"]})])]


#: a document of the workload's wide shape (no known fallback)
WIDE = next(i for i in range(64) if tree_shape(i) == "wide-container")


def _base_above():
    """A base summary whose minSeq is above the tail's final min_seq: the
    header's minSeq and every clamp read the base's (or the tail's
    messages', where they pass it)."""
    msgs = synth_tree_messages(WIDE, 80)
    base = RefTree("tree")
    for msg in msgs[:50]:
        base.process(msg, local=False)
    base.advance(msgs[49].seq, msgs[49].seq - 2)
    return _ref_doc("base", msgs[50:], final_msn=0,
                    base_summary=base.summarize())


def _attribution():
    from fluidframework_tpu.runtime.attributor import Attributor

    msgs = synth_tree_messages(WIDE, 60)
    base = RefTree("tree")
    base._attributor = Attributor()
    for msg in msgs[:30]:
        base.process(msg, local=False)
    return _ref_doc("attr", msgs[30:], base_summary=base.summarize(),
                    attribution=True)


def _workload(n=40, edits=120):
    """The pinned workload's five shapes (the fallback shapes included)."""
    return [tree_doc(i, synth_tree_messages(i, edits), edits)
            for i in range(n)]


CRAFTED = {"limbo": lambda: [_limbo()],
           "removed_unpurged": lambda: [_removed_unpurged()],
           "adversarial_strings": lambda: [_adversarial()],
           "values": lambda: [_values()],
           "empty": _empty,
           "base_above_final_msn": lambda: [_base_above()],
           "attribution": lambda: [_attribution()]}


def _records(doc):
    """The port document carrying records in place of messages."""
    return dataclasses.replace(doc, ops=[],
                               records=tn.encode_tree_ops(doc.ops))


# -- the two routes ------------------------------------------------------------


def _fold(docs):
    state, edits, meta = tk.pack_tree_batch(docs)
    final = fold(tensors_to(state, CPU), tensors_to(edits, CPU))
    return meta, tuple(x.numpy() for x in final)


def _headers(trees):
    return [{k: v.content for k, v in t.children.items()} for t in trees]


def _both_routes(meta, arr):
    """``(native, python)``: each route's summaries, stats and counts over
    the same folded planes."""
    state_np = dict(zip(tk.TreeState._fields, arr))
    p_stats, p_counts = {}, {}
    want = [tk.summary_from_state(meta, state_np, d, stats=p_stats,
                                  counts=p_counts)
            for d in range(len(meta["docs"]))]
    n_stats, n_counts = {}, {}
    got = tp.summaries_from_tree_export(meta, arr, stats=n_stats,
                                        counts=n_counts)
    return (got, n_stats, n_counts), (want, p_stats, p_counts)


def _eligible(meta, arr):
    overflow = arr[tk.TreeState._fields.index("overflow")]
    return [d for d, (doc, p) in enumerate(zip(meta["docs"],
                                               meta["doc_packs"]))
            if not p.needs_fallback and not overflow[d]
            and not doc.attribution]


def _assert_writer_is_python(docs, written=None):
    """Fold ``docs``; the writer's route equals the Python route in bytes,
    stats and counts, and wrote ``written`` documents (all it may take by
    default).  Returns the summaries and stats."""
    meta, arr = _fold(docs)
    (got, n_stats, n_counts), (want, p_stats, p_counts) = \
        _both_routes(meta, arr)
    assert _headers(got) == _headers(want)
    assert n_stats == p_stats
    native = n_counts.pop("extract_native_docs", 0)
    assert n_counts == p_counts
    assert native == (len(_eligible(meta, arr)) if written is None
                      else written)
    return got, n_stats


def _ref_run(ref_docs):
    stats = {}
    got = ref_tp.pipelined_tree_replay(ref_docs, chunk_docs=16, stats=stats)
    return [s.digest() for s in got], stats


def _assert_reference_agrees(ref_docs, trees, stats):
    """The JAX package's pipeline on the same documents (records through
    their decoded messages) gives the same summaries and stats."""
    want, r_stats = _ref_run(ref_docs)
    assert [t.digest() for t in trees] == want
    stats = dict(stats)
    stats.pop("native_pack_docs", None)
    assert stats == r_stats


# -- the tests -----------------------------------------------------------------


def test_tree_long_pool_headers_are_the_python_routes():
    """The benchmark's tree cell at 64 x 2,000, records packed natively:
    every header the writer's, byte for byte the Python route's, and the
    reference's (its pipeline on the decoded messages)."""
    spec = run.load_cell("tree_long.forest_cold")
    pool = sharedtree.generate(spec.config, spec.traffic, 2 ** 31 + 9,
                               n_docs=64)
    docs = sharedtree.inputs(pool)
    assert pool.n_ops == 2000
    got, stats = _assert_writer_is_python(docs)
    assert stats == {"device_docs": 64}
    ref_docs = [_ref_doc(d.doc_id, [_ref_msg(m) for m in
                                    tn.decode_tree_ops(d.records)],
                         final_msn=d.final_msn) for d in docs[:16]]
    want, _r_stats = _ref_run(ref_docs)
    assert [t.digest() for t in got[:16]] == want


@pytest.mark.parametrize("records", [False, True])
def test_workload_shapes_as_messages_and_records(records):
    ref_docs = _workload()
    docs = [tree_doc_input_from(d) for d in ref_docs]
    if records:
        docs = [_records(d) for d in docs]
    got, stats = _assert_writer_is_python(docs)
    assert stats["device_docs"] > 0 and stats["fallback_docs"] > 0
    _assert_reference_agrees(ref_docs, got, stats)


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_crafted_documents(name):
    ref_docs = CRAFTED[name]()
    docs = [tree_doc_input_from(d) for d in ref_docs]
    got, stats = _assert_writer_is_python(
        docs, written=0 if name == "attribution" else len(docs))
    headers = [json.loads(t.children["header"].content) for t in got]
    if name == "limbo":
        assert [n["id"] for n in headers[0]["limbo"]] == sorted(
            ["z", "\U0001F600", "\uffff", "a\"b", "é", "a", "A\\"])
    if name == "removed_unpurged":
        assert "removedSeq" in json.dumps(headers[0])
    if name == "base_above_final_msn":
        base = json.loads(docs[0].base_summary.blob_bytes("header"))
        assert headers[0]["minSeq"] >= base["minSeq"] > docs[0].final_msn
    if name == "attribution":
        assert "attribution" in got[0].children
    _assert_reference_agrees(ref_docs, got, stats)
    assert [t.digest() for t in got] == [
        tk.oracle_fallback_summary(d).digest() for d in docs]
    if name not in ("attribution", "base_above_final_msn"):
        recorded = [_records(d) for d in docs]
        again, _stats = _assert_writer_is_python(recorded)
        assert _headers(again) == _headers(got)


def test_a_lone_surrogate_the_header_emits_raises_as_before():
    """Canonical JSON cannot encode a lone surrogate: the writer leaves
    the document to the Python route, which raises as it always did; a
    lone surrogate the header does not emit (a purged node's id) does not
    stop the writer."""
    purged = tree_doc_input_from(_ref_doc("purged-surrogate", [
        _msg(1, 0, _insert("", "a", _leaf("\udc00x"), _leaf("k"))),
        _msg(2, 0, {"kind": "remove", "ids": ["\udc00x"]}),
        _msg(3, 2, {"kind": "set", "id": "k", "value": 1}),
    ]))
    _assert_writer_is_python([purged])
    emitted = tree_doc_input_from(_ref_doc("surrogate", [
        _msg(1, 0, _insert("", "a", _leaf("\ud800"))),
    ]))
    meta, arr = _fold([emitted])
    state_np = dict(zip(tk.TreeState._fields, arr))
    [(header, status)] = tn.write_headers(meta, state_np, [0])
    assert header is None and status != tn.WRITTEN
    with pytest.raises(UnicodeEncodeError):
        tk.summary_from_state(meta, state_np, 0)
    with pytest.raises(UnicodeEncodeError):
        tp.summaries_from_tree_export(meta, arr)


def test_a_chain_cycle_takes_the_oracle_route_counted():
    docs = [tree_doc_input_from(d) for d in _workload(8, 60)]
    meta, arr = _fold(docs)
    d = _eligible(meta, arr)[0]
    arr = tuple(np.copy(a) for a in arr)
    f = tk.TreeState._fields
    head, nxt = arr[f.index("head")], arr[f.index("next")]
    c = next(c for c in range(int(meta["n_cont"][d]))
             if head[d, c] != tk.NIL and nxt[d, head[d, c]] != tk.NIL)
    last = head[d, c]
    while nxt[d, last] != tk.NIL:
        last = nxt[d, last]
    nxt[d, last] = head[d, c]
    state_np = dict(zip(f, arr))
    written = tn.write_headers(meta, state_np, [d])
    assert written == [(None, tn.CYCLE)]
    (got, n_stats, n_counts), (want, p_stats, _p) = _both_routes(meta, arr)
    assert _headers(got) == _headers(want)
    assert n_stats == p_stats and n_stats["fallback_chain_cycle"] == 1
    assert n_counts["extract_native_docs"] == len(_eligible(meta, arr)) - 1
    assert got[d].digest() == tk.oracle_fallback_summary(docs[d]).digest()


def test_without_the_library_the_python_route_writes_the_same(monkeypatch):
    ref_docs = _workload(12, 60) + [_limbo(), _adversarial(), _values()]
    docs = [tree_doc_input_from(d) for d in ref_docs]
    with_lib = tp.pipelined_tree_replay(docs, device="cpu")
    monkeypatch.setattr(tn, "load_library", lambda: None)
    stage, stats = {}, {}
    without = tp.pipelined_tree_replay(docs, device="cpu", stage=stage,
                                       stats=stats)
    assert _headers(without) == _headers(with_lib)
    assert stage["extract_native_docs"] == 0
    assert stats["device_docs"] > 0


@pytest.mark.parametrize("k", [1, 2, 7])
def test_slices_with_special_documents_on_their_boundaries(monkeypatch, k):
    """A chunk cut into ``k`` slices, with a limbo, an attribution, an
    empty, an adversarial, a values and a removed-unpurged document on
    either side of every cut (the workload's oracle-routed documents
    around the chunk): the summaries, stats and stage counts of the same
    pipeline on the Python route, and the oracle's summaries."""
    work = [tree_doc_input_from(d) for d in _workload(60, 40)]
    chunk = [d for d in work if not tk.known_tree_fallback(d)]
    special = [tree_doc_input_from(d) for d in
               [_limbo(), _attribution(), _empty()[1], _adversarial(),
                _values(), _removed_unpurged()]]
    n = len(chunk)
    cuts = [n * j // k for j in range(k + 1)]
    at = sorted({i for c in cuts for i in (c - 1, c) if 0 <= i < n})
    for j, i in enumerate(at):
        chunk[i] = special[j % len(special)]
    docs = chunk + [d for d in work if tk.known_tree_fallback(d)]
    monkeypatch.setattr(pipeline, "MIN_SLICE_DOCS",
                        n + 1 if k == 1 else n // k)

    def replay():
        stage, stats = {}, {}
        got = tp.pipelined_tree_replay(docs, chunk_docs=n, stage=stage,
                                       stats=stats, device="cpu")
        return got, stage, stats

    got, stage, stats = replay()
    assert stage["extract_tasks"] == k
    meta, arr = _fold(chunk)
    assert stage["extract_native_docs"] == len(_eligible(meta, arr))
    with monkeypatch.context() as m:
        m.setattr(tn, "load_library", lambda: None)
        want, w_stage, w_stats = replay()
    assert _headers(got) == _headers(want)
    assert stats == w_stats and stats["device_docs"] > 0
    assert w_stage["extract_native_docs"] == 0
    assert stage["extract_nodes"] == w_stage["extract_nodes"] > 0
    assert [t.digest() for t in got] == [
        tk.oracle_fallback_summary(d).digest() for d in docs]
