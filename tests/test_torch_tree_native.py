"""SharedTree edit records and the native tree pack (CPU).

The records round-trip to the messages they were encoded from; the
routing verdict read from them is the one read from the messages; the
native pack fills the planes and the meta of the Python pack bit for bit,
on the five shapes of the pinned tree workload (the three that route to
the oracle included) and on the benchmark generator's pools; the Python
route without the native library gives the same; and the tree pipeline,
fed records, writes summaries byte-identical to the benchmark's plain
reference, whose control (one edit stale) fails that comparison.
"""

import time

import numpy as np
import pytest

from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.ops import tree_native as tn
from fluidframework_tpu_torch.ops import tree_pipeline as tp
from fluidframework_tpu_torch.ops.pipeline import seed_stage
from fluidframework_tpu_torch.protocol.messages import (MessageType,
                                                        SequencedMessage)
from fluidframework_tpu_torch.testing.tree_workload import (
    SHAPES, synth_tree_messages, tree_shape)
from portbench import run, sharedtree
from portbench.reference import sharedtree as ref

#: a document index of each shape of the pinned workload
SHAPE_DOCS = {shape: next(i for i in range(64) if tree_shape(i) == shape)
              for shape in SHAPES}
CELL = "tree_long.forest_cold"


def _doc(i, msgs, records=False):
    return tk.TreeDocInput(
        doc_id=f"t{i}", ops=[] if records else msgs,
        final_seq=msgs[-1].seq, final_msn=msgs[-1].min_seq,
        records=tn.encode_tree_ops(msgs) if records else None)


def _assert_packs_equal(want, got):
    (ws, we, wm), (gs, ge, gm) = want, got
    for f in tk.TreeState._fields:
        assert np.array_equal(getattr(ws, f), getattr(gs, f)), f
        assert getattr(ws, f).dtype == getattr(gs, f).dtype, f
    for f in tk.TreeEdits._fields:
        assert np.array_equal(getattr(we, f), getattr(ge, f)), f
    for key in ("n_nodes", "n_cont", "t_rows"):
        assert np.array_equal(wm[key], gm[key]), key
        assert np.asarray(wm[key]).dtype == np.asarray(gm[key]).dtype
    assert wm["values"].values == gm["values"].values
    assert wm["values"]._by_key == gm["values"]._by_key
    assert [d.doc_id for d in wm["docs"]] == [d.doc_id for d in gm["docs"]]
    for p, q in zip(wm["doc_packs"], gm["doc_packs"], strict=True):
        for attr in ("fallback_reason", "header_seq", "base_min_seq",
                     "boundary", "removal_time", "node_types"):
            assert getattr(p, attr) == getattr(q, attr), attr
        for table in ("node_ids", "containers"):
            assert getattr(p, table).values == getattr(q, table).values
            assert getattr(p, table)._by_key == getattr(q, table)._by_key


@pytest.mark.parametrize("shape", SHAPES)
def test_records_round_trip_to_the_messages(shape):
    i = SHAPE_DOCS[shape]
    msgs = synth_tree_messages(i, 160)
    rec = tn.encode_tree_ops(msgs)
    assert tn.decode_tree_ops(rec) == msgs
    assert tn.encode_tree_ops(tn.decode_tree_ops(rec)) == rec
    assert rec.nodes[0] == "" and len(rec.node_types) == rec.n_packed


@pytest.mark.parametrize("shape", SHAPES)
def test_routing_reads_the_same_from_records(shape):
    i = SHAPE_DOCS[shape]
    msgs = synth_tree_messages(i, 160)
    plain, recorded = _doc(i, msgs), _doc(i, msgs, records=True)
    want = tk.known_tree_fallback(plain)
    assert tk.known_tree_fallback(recorded) == want
    assert tn._route_py(recorded.records.blob) == want
    if shape in ("revive", "multi_id_move"):
        assert want == shape


@pytest.mark.parametrize("shape", SHAPES)
def test_native_pack_equals_the_python_pack(shape):
    base = SHAPE_DOCS[shape]
    idx = [base + 32 * k for k in range(3)]
    streams = [synth_tree_messages(i, 300) for i in idx]
    want = tk.pack_tree_batch([_doc(i, m) for i, m in zip(idx, streams)])
    got = tk.pack_tree_batch([_doc(i, m, records=True)
                              for i, m in zip(idx, streams)])
    assert got[2]["native_docs"] == len(idx)
    assert "native_docs" not in want[2]
    _assert_packs_equal(want, got)


def test_native_pack_equals_the_python_pack_on_a_mixed_batch():
    idx = list(range(40))
    streams = [synth_tree_messages(i, 120) for i in idx]
    want = tk.pack_tree_batch([_doc(i, m) for i, m in zip(idx, streams)])
    got = tk.pack_tree_batch([_doc(i, m, records=True)
                              for i, m in zip(idx, streams)])
    _assert_packs_equal(want, got)


def _pool(seed, n_docs=8, n_ops=200):
    spec = run.load_cell(CELL)
    return sharedtree.generate(spec.config, spec.traffic, seed,
                               n_docs=n_docs, n_ops=n_ops)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7, 9_300_000_123])
def test_native_pack_equals_the_python_pack_on_generated_pools(seed):
    pool = _pool(seed)
    docs = sharedtree.inputs(pool)
    plain = [tk.TreeDocInput(doc_id=d.doc_id,
                             ops=tn.decode_tree_ops(d.records),
                             final_seq=d.final_seq, final_msn=d.final_msn)
             for d in docs]
    _assert_packs_equal(tk.pack_tree_batch(plain), tk.pack_tree_batch(docs))
    for d in docs:
        assert tn.encode_tree_ops(tn.decode_tree_ops(d.records)) == d.records


def test_without_the_library_the_python_route_packs_the_records(
        monkeypatch):
    idx = [SHAPE_DOCS[s] for s in SHAPES]
    streams = [synth_tree_messages(i, 200) for i in idx]
    native = tk.pack_tree_batch([_doc(i, m, records=True)
                                 for i, m in zip(idx, streams)])
    monkeypatch.setattr(tn, "load_library", lambda: None)
    docs = [_doc(i, m, records=True) for i, m in zip(idx, streams)]
    python = tk.pack_tree_batch(docs)
    assert "native_docs" not in python[2]
    _assert_packs_equal(python, native)
    assert [tk.known_tree_fallback(d) for d in docs] == \
        [tk.known_tree_fallback(_doc(i, m)) for i, m in zip(idx, streams)]


@pytest.mark.parametrize("edit", [
    {"kind": "set", "id": "x", "value": 1, "prev": 0},
    {"kind": "insert", "parent": "", "field": "a", "anchor": None,
     "content": []},
    {"kind": "insert", "parent": "", "field": "a", "anchor": None,
     "content": [{"id": "x", "type": "n", "fields": {"k": []}}]},
    {"kind": "rename", "id": "x"},
    {"kind": "insert", "parent": "", "field": "a", "anchor": None,
     "content": [{"id": "x", "type": "n", "value": 1},
                 {"id": "y", "type": "n", "value": True}]},
])
def test_the_encoder_refuses_what_records_cannot_carry(edit):
    msg = SequencedMessage(seq=1, client_id="c", client_seq=1, ref_seq=0,
                           min_seq=0, type=MessageType.OP,
                           contents={"edits": [edit]})
    with pytest.raises(ValueError):
        tn.encode_tree_ops([msg])


def test_a_malformed_stream_raises():
    msgs = synth_tree_messages(SHAPE_DOCS["wide-container"], 40)
    doc = _doc(0, msgs, records=True)
    doc.records.blob = doc.records.blob[:-3]
    with pytest.raises(ValueError):
        tk.pack_tree_batch([doc])


def _sliced_pack(docs, k, N=None, T=None):
    """The native record pack of ``docs`` cut into ``k`` ranges, each
    range's begin and finish on a thread of its own, submitted last range
    first."""
    from concurrent.futures import ThreadPoolExecutor

    if N is None:
        pack = tk.slice_tree_pack(docs, k)
    else:
        pack = tn.RecordPack(tn.load_library(), docs, N, T, k)
    pack.intern()
    with ThreadPoolExecutor(max_workers=k) as pool:
        for f in [pool.submit(pack.begin, j) for j in reversed(range(k))]:
            f.result()
        pack.size()
        for f in [pool.submit(pack.finish, j) for j in reversed(range(k))]:
            f.result()
    return pack.join()


def _late_corpus():
    """Record documents of the pinned workload, of several lengths, the
    one with the most containers last, and their message twins."""
    idx = list(range(48))
    streams = [synth_tree_messages(i, 40 + 5 * (i % 9)) for i in idx]
    docs = [_doc(i, m, records=True) for i, m in zip(idx, streams)]
    plain = [_doc(i, m) for i, m in zip(idx, streams)]
    n_cont = tk.pack_tree_batch(docs)[2]["n_cont"]
    last = int(np.argmax(n_cont))
    order = [d for d in range(len(docs)) if d != last] + [last]
    return [docs[d] for d in order], [plain[d] for d in order]


@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_the_sliced_pack_equals_the_whole_and_the_python_pack(k):
    """Cut into ``k`` ranges, the record pack fills the planes and the
    meta of the whole native pack and of the Python pack, bit for bit:
    values that first appear in a later range keep the batch's
    first-appearance order, and a document outside range 0 sets ``C``."""
    from fluidframework_tpu_torch.ops.interning import next_bucket

    docs, plain = _late_corpus()
    whole = tk.pack_tree_batch(docs)
    python = tk.pack_tree_batch(plain)
    got = _sliced_pack(docs, k)
    _assert_packs_equal(whole, got)
    _assert_packs_equal(python, got)
    assert got[2]["native_docs"] == len(docs)
    for a, b in zip(got[2]["value_json"], whole[2]["value_json"],
                    strict=True):
        assert np.array_equal(a, b)
    assert [p.containers.values for p in got[2]["doc_packs"]] == \
        [p.containers.values for p in python[2]["doc_packs"]]
    cut = len(docs) // k
    first = {}
    for d, doc in enumerate(docs):
        for v in doc.records.values[:doc.records.n_packed_values]:
            first.setdefault(v, d)
    if k > 1:
        assert max(first.values()) >= cut
        n_cont = got[2]["n_cont"]
        assert next_bucket(max(int(n_cont[:cut].max()), 1), floor=8) \
            < got[0].head.shape[1]


@pytest.mark.parametrize("k", [2, 3, 7])
def test_the_sliced_pack_names_the_first_malformed_document(k):
    """A malformed stream inside a later range (and another after it)
    raises what the whole pack raises: the first such document."""
    docs, _plain = _late_corpus()
    for d in (len(docs) * (k - 1) // k + 1, len(docs) - 1):
        docs[d].records.blob = docs[d].records.blob[:-3]
    with pytest.raises(ValueError) as whole:
        tk.pack_tree_batch(docs)
    with pytest.raises(ValueError) as sliced:
        _sliced_pack(docs, k)
    assert str(sliced.value) == str(whole.value)
    assert docs[len(docs) * (k - 1) // k + 1].doc_id in str(whole.value)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_the_sliced_pack_names_the_first_overflowing_document(k):
    """Edit rows past ``T`` inside a later range raise what the whole pack
    raises at the same buckets: the first such document, with the same
    message."""
    docs, _plain = _late_corpus()
    docs.append(_doc(99, synth_tree_messages(99, 160), records=True))
    t_rows = tk.pack_tree_batch(docs)[2]["t_rows"]
    lo = len(docs) * (k - 1) // k
    T = int(t_rows[:lo].max())
    assert int(t_rows[lo:].max()) > T
    N, _T = tk.tree_buckets(docs)
    with pytest.raises(ValueError) as whole:
        tn.pack_records(docs, N, T)
    with pytest.raises(ValueError) as sliced:
        _sliced_pack(docs, k, N, T)
    assert str(sliced.value) == str(whole.value)
    first = next(d for d in range(len(docs)) if t_rows[d] > T)
    assert first >= lo
    assert str(whole.value).startswith(f"{docs[first].doc_id}: ")


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1, 7_777_777_777])
def test_pipeline_on_records_equals_the_plain_reference(seed):
    pool = _pool(seed)
    stats, stage = {}, {}
    got = tp.pipelined_tree_replay(sharedtree.inputs(pool), device="cpu",
                                   stats=stats, stage=stage)
    for d in range(pool.n_docs):
        want = ref.replay(pool.records(d), pool.final_msn)
        assert {k: v.content for k, v in got[d].children.items()} == want
        assert ref.replay(pool.records(d), pool.final_msn,
                          control=True) != want
    assert stats == {"native_pack_docs": pool.n_docs,
                     "device_docs": pool.n_docs}
    assert stage["extract_nodes"] == sum(
        pool.live_nodes(d) for d in range(pool.n_docs))


def test_pipeline_on_records_equals_the_messages_and_the_oracle():
    idx = list(range(36))
    streams = [synth_tree_messages(i, 150) for i in idx]
    plain = [_doc(i, m) for i, m in zip(idx, streams)]
    recorded = [_doc(i, m, records=True) for i, m in zip(idx, streams)]
    p_stats, r_stats = {}, {}
    want = tp.pipelined_tree_replay(plain, device="cpu", stats=p_stats,
                                    chunk_docs=16)
    got = tp.pipelined_tree_replay(recorded, device="cpu", stats=r_stats,
                                   chunk_docs=16)
    assert [s.digest() for s in got] == [s.digest() for s in want]
    oracle = [tk.oracle_fallback_summary(d).digest() for d in recorded]
    assert [s.digest() for s in got] == oracle
    assert r_stats.pop("native_pack_docs") == len(idx) - \
        sum(1 for d in plain if tk.known_tree_fallback(d))
    assert r_stats == p_stats
    assert p_stats["fallback_max_depth"] > 0


def test_record_documents_bypass_the_pack_tiers():
    msgs = synth_tree_messages(SHAPE_DOCS["deep-move"], 80)
    assert tp.TREE_FAMILY.bypass(_doc(0, msgs, records=True))
    assert not tp.TREE_FAMILY.bypass(_doc(0, msgs))


def test_stage_counts_extract_nodes():
    stage = {}
    seed_stage(stage)
    assert stage["extract_nodes"] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_tree_cell_runs_correct_on_the_cpu(trace):
    spec = run.load_cell(CELL)
    res, notes = run.run_cell(spec, 2 ** 35 + 3, 0.0, bool(trace), "cpu",
                              time.perf_counter(), n_docs=20, n_ops=120)
    assert res["correct"] is True and res["failed"] == 0
    assert notes["compared"] == 16
    assert list(res["check"]) == ["missing", "header_mismatch",
                                  "forest_mismatch", "sample_mismatch"]
    if trace:
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert m["tree_native_pack_doc_pct"] == 100.0
        assert m["tree_fallback_doc_pct"] == 0.0
        assert m["tree_pack_busy_ms_per_kop"] > 0
        assert m["tree_extract_busy_us_per_node"] > 0
    else:
        assert set(res["metrics"]) == {"catchup_ops_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 41])
def test_the_control_reads_not_correct(seed, monkeypatch):
    from portbench import control

    spec = run.load_cell(CELL)
    pool = sharedtree.generate(spec.config, spec.traffic, seed, n_docs=20,
                               n_ops=120)
    monkeypatch.setattr(sharedtree, "entry",
                        lambda traffic: control.control_pass(sharedtree,
                                                             pool))
    res, _notes = run.run_cell(spec, seed, 0.0, False, "cpu",
                               time.perf_counter(), n_docs=20, n_ops=120)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == 16
    assert res["check"]["header_mismatch"]["value"] == 20
