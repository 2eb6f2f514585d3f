"""The port's SharedMatrix catch-up against the JAX package's and the
oracle's: ``pack_matrix_batch`` (every plane and the host meta, its cold
flag, no obliterate stamp), the plain resolving fold, cold and warm,
against ``_replay_matrix_batch`` (every plane, ``n``, ``overflow`` and
every resolved handle, padding rows included), the kernel wrapper's CPU
path and its fact checks, ``replay_matrix_batch(device="cpu")``
summaries, per-reason ``stats`` and transfer bytes, the workload copy,
the committed fixture, and the crafted resolve cases.

Regenerate the fixture (after a change to the JAX package's matrix fuzz)
with ``python -m tests.test_torch_matrix_kernel --write-fixture``."""

import json
import sys

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds import SharedMatrix as RefSharedMatrix
from fluidframework_tpu.ops import matrix_kernel as ref_mk
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.protocol.summary import SummaryTree as RefTree
from fluidframework_tpu.testing import MockContainerRuntimeFactory
from fluidframework_tpu.testing.fuzz import MatrixFuzzSpec, run_fuzz
from fluidframework_tpu.testing.mocks import channel_log
from fluidframework_tpu_torch.convert import matrix_doc_input_from, tensors_to
from fluidframework_tpu_torch.dds import SharedMatrix
from fluidframework_tpu_torch.ops import matrix_fold_cuda
from fluidframework_tpu_torch.ops import matrix_kernel as mk
from fluidframework_tpu_torch.testing import config_workloads as cw
from tools import bench_configs

torch.set_num_threads(1)


def _from_factory(factory, doc_id, base_summary=None, min_seq_exclusive=0):
    return ref_mk.MatrixDocInput(
        doc_id=doc_id,
        ops=channel_log(factory, "fuzz", min_seq_exclusive=min_seq_exclusive),
        base_summary=base_summary, final_seq=factory.sequencer.seq,
        final_msn=factory.sequencer.min_seq)


def _removed_by_three():
    """Four clients: A inserts three rows and two columns and writes a
    cell; then B, C and D each remove row 0 concurrently."""
    factory = MockContainerRuntimeFactory()
    clients = [factory.create_client(n).attach(RefSharedMatrix("fuzz"))
               for n in "ABCD"]
    clients[0].insert_rows(0, 3)
    clients[0].insert_cols(0, 2)
    factory.process_all_messages()
    clients[0].set_cell(0, 0, "a")
    for c in clients[1:]:
        c.remove_rows(0, 1)
    factory.process_all_messages()
    return factory, clients


def fresh_fixture():
    """The matrix fixture, from the JAX package's fuzz harness: the fuzz
    logs of tests/test_matrix_kernel.py (LWW seeds 0-7, FWW seeds 700-703),
    its base-summary tail and directed concurrent document, a base whose
    row record has two overlap removers (the pre-pack fallback) and a
    third remover of one row (the post-fold overflow fallback)."""
    docs = []
    for seed in range(8):
        _r, factory = run_fuzz(MatrixFuzzSpec(), seed=seed, n_clients=3,
                               rounds=20)
        docs.append(_from_factory(factory, f"fuzz-lww-{seed}"))
    for seed in range(4):
        _r, factory = run_fuzz(MatrixFuzzSpec(fww=True), seed=700 + seed,
                               n_clients=3, rounds=20)
        docs.append(_from_factory(factory, f"fuzz-fww-{seed}"))
    # test_matrix_kernel_replays_tail_from_base_summary
    replicas, factory = run_fuzz(MatrixFuzzSpec(), seed=90, n_clients=3,
                                 rounds=12)
    base = replicas[0].summarize()
    base_seq = factory.sequencer.seq
    tail = [
        lambda m: m.insert_rows(0, 1),
        lambda m: m.set_cell(0, 0, "tail1"),
        lambda m: m.remove_cols(0, 1) if m.col_count > 1 else None,
        lambda m: m.set_cell(m.row_count - 1, m.col_count - 1, "tail2"),
    ]
    for i, fn in enumerate(tail):
        fn(replicas[i % len(replicas)])
    factory.process_all_messages()
    docs.append(_from_factory(factory, "base-tail", base_summary=base,
                              min_seq_exclusive=base_seq))
    # test_matrix_kernel_directed_concurrent_structure
    factory = MockContainerRuntimeFactory()
    a = factory.create_client("A").attach(RefSharedMatrix("fuzz"))
    b = factory.create_client("B").attach(RefSharedMatrix("fuzz"))
    a.insert_rows(0, 2)
    a.insert_cols(0, 2)
    factory.process_all_messages()
    a.set_cell(1, 1, "x")
    b.insert_rows(1, 1)
    a.remove_rows(0, 1)
    b.set_cell(0, 0, "y")
    factory.process_all_messages()
    docs.append(_from_factory(factory, "directed-concurrent"))
    # a base record with two overlap removers, then a tail
    factory, clients = _removed_by_three()
    base = clients[0].summarize()
    base_seq = factory.sequencer.seq
    clients[1].set_cell(0, 1, "t")
    clients[2].insert_cols(1, 1)
    factory.process_all_messages()
    docs.append(_from_factory(factory, "overlap-base", base_summary=base,
                              min_seq_exclusive=base_seq))
    # the same three removers in the tail: an axis overflow
    factory, _clients = _removed_by_three()
    docs.append(_from_factory(factory, "third-remover"))
    return {"docs": [cw.matrix_doc_to_json(d) for d in docs]}


def ref_doc(obj: dict) -> ref_mk.MatrixDocInput:
    """The JAX package's input for a fixture (or crafted) document."""
    base = None
    if obj.get("base_summary") is not None:
        base = RefTree()
        for name in ("header", "body"):
            base.add_blob(name, obj["base_summary"][name].encode())
    return ref_mk.MatrixDocInput(
        doc_id=obj["doc_id"], ops=[RefMsg.from_dict(m) for m in obj["ops"]],
        base_summary=base, final_seq=obj["final_seq"],
        final_msn=obj["final_msn"])


def crafted_doc(case: str) -> ref_mk.MatrixDocInput:
    """A crafted case of the port's workload module, as a JAX-package
    input."""
    return ref_doc(cw.matrix_doc_to_json(cw.crafted_matrix_doc(case)))


CRAFTED = cw.CRAFTED_MATRIX


def _fixture_ref_docs():
    return [ref_doc(d) for d in cw.load_json(cw.MATRIX_FIXTURE)["docs"]]


CORPORA = {
    "fixture": _fixture_ref_docs,
    "workload-12x64": lambda: [bench_configs.gen_matrix_doc(i, 64)
                               for i in range(12)],
    "crafted": lambda: [crafted_doc(c) for c in CRAFTED],
    **{f"crafted-{c}": (lambda c=c: [crafted_doc(c)]) for c in CRAFTED},
}


def _ref_fold(state, ops):
    final, resolved = ref_mk._replay_matrix_batch(state, ops)
    return {f: np.asarray(x) for f, x in final._asdict().items()}, \
        np.asarray(resolved)


def _port_fold(state_np, ops_np):
    final, resolved, _v = matrix_fold_cuda.fold_resolving(
        tensors_to(state_np, "cpu"), tensors_to(ops_np, "cpu"))
    return {f: x.numpy() for f, x in final._asdict().items()}, \
        resolved.numpy()


def test_committed_fixture_is_a_fresh_dump():
    fresh = json.loads(json.dumps(fresh_fixture()))
    assert cw.load_json(cw.MATRIX_FIXTURE) == fresh


def test_fixture_docs_round_trip_and_route_as_named():
    docs = cw.hard_matrix_docs()
    assert [cw.matrix_doc_to_json(d) for d in docs] == \
        cw.load_json(cw.MATRIX_FIXTURE)["docs"]
    fallback = [d.doc_id for d in docs if mk.known_matrix_fallback(d)]
    assert fallback == ["overlap-base"]


@pytest.mark.parametrize("n_ops", [16, 64])
def test_workload_matches_bench_configs(n_ops):
    for i in range(32):
        r = bench_configs.gen_matrix_doc(i, n_ops)
        p = cw.gen_matrix_doc(i, n_ops)
        assert (p.doc_id, p.final_seq, p.final_msn, p.base_summary) == \
            (r.doc_id, r.final_seq, r.final_msn, r.base_summary)
        assert [m.to_dict() for m in p.ops] == [m.to_dict() for m in r.ops]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_pack_matches_jax_package(corpus):
    ref_docs = [d for d in CORPORA[corpus]()
                if not ref_mk.known_matrix_fallback(d)]
    r_state, r_ops, r_meta = ref_mk.pack_matrix_batch(ref_docs)
    p_state, p_ops, p_meta = mk.pack_matrix_batch(
        [matrix_doc_input_from(d) for d in ref_docs])
    for group_r, group_p in ((r_state, p_state), (r_ops, p_ops)):
        for f in group_r._fields:
            a, b = getattr(group_r, f), getattr(group_p, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert list(r_meta["values"].values) == list(p_meta["values"].values)
    for rp, pp in zip(r_meta["packs"], p_meta["packs"]):
        assert list(rp.clients.values) == list(pp.clients.values)
        assert rp.cells == pp.cells
        assert rp.base_cells == pp.base_cells
        assert (rp.fww_from_seq, rp.base_policy, rp.base_seq) == \
            (pp.fww_from_seq, pp.base_policy, pp.base_seq)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_plain_resolving_fold_matches_jax_on_every_plane(corpus):
    ref_docs = [d for d in CORPORA[corpus]()
                if not ref_mk.known_matrix_fallback(d)]
    state, ops, _meta = ref_mk.pack_matrix_batch(ref_docs)
    want, want_resolved = _ref_fold(state, ops)
    got, got_resolved = _port_fold(state, ops)
    for f in want:
        assert want[f].dtype == got[f].dtype, f
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)
    assert got_resolved.dtype == np.int32
    np.testing.assert_array_equal(want_resolved, got_resolved)
    # every row that is not a resolve (padding included) gives -1
    assert (got_resolved[np.asarray(ops.kind) != mk.K_RESOLVE] == -1).all()


def _resolved_of(case):
    state, ops, _m = mk.pack_matrix_batch([cw.crafted_matrix_doc(case)])
    _final, resolved = _port_fold(state, ops)
    kind = np.asarray(ops.kind)
    return [resolved[s][kind[s] == mk.K_RESOLVE].tolist() for s in (0, 1)]


def test_resolve_skips_a_zero_width_slot_that_ends_a_chunk():
    """(b) Row handles are allocated in insert order, one a slot: row 31
    after the remove is slot 32 (handle 32); the lagged view still sees
    slot 31; row 32 lies past the view after the remove."""
    rows, cols = _resolved_of("zero-width-chunk-end")
    assert rows == [32, 31, -1]
    assert cols == [0, 0, 0]


def test_resolves_past_the_view_or_on_an_empty_axis_give_minus_one():
    """(c) No column yet; a row past the two rows; a column past the one
    column; then a resolve that lands."""
    rows, cols = _resolved_of("past-the-view")
    assert rows == [0, -1, 0, 1]
    assert cols == [-1, 0, -1, 0]


def test_resolve_reads_the_state_before_it_in_its_view():
    """(d) The insert at row 0 (handle 1) shifts the second write to
    handle 1; the lagged write (view before that insert) still hits 0."""
    rows, cols = _resolved_of("resolve-order")
    assert rows == [0, 1, 0]
    assert cols == [0, 0, 0]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_replay_matches_jax_package_and_oracle(corpus):
    ref_docs = CORPORA[corpus]()
    ref_stats, stats = {}, {}
    want = ref_mk.replay_matrix_batch(ref_docs, stats=ref_stats)
    docs = [matrix_doc_input_from(d) for d in ref_docs]
    got = mk.replay_matrix_batch(docs, stats=stats, device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in want]
    assert [s.digest() for s in got] == \
        [mk.oracle_matrix_fallback(d).digest() for d in docs]
    assert stats == ref_stats


def test_fixture_fallbacks_by_reason_equal_the_jax_package():
    """One pre-pack fallback (two overlap removers in the base), one
    post-fold overflow (a third remover), the rest on the device."""
    stats, ref_stats = {}, {}
    mk.replay_matrix_batch(cw.hard_matrix_docs(), stats=stats, device="cpu")
    ref_mk.replay_matrix_batch(_fixture_ref_docs(), stats=ref_stats)
    assert stats == ref_stats
    assert stats["fallback_docs"] == 2
    assert stats["device_docs"] == len(cw.hard_matrix_docs()) - 2


def test_replay_mixed_batch_of_fixture_and_workload():
    docs = cw.hard_matrix_docs() + [cw.gen_matrix_doc(i, 8 + 6 * i)
                                    for i in range(6)]
    got = mk.replay_matrix_batch(docs, device="cpu")
    assert [s.digest() for s in got] == \
        [mk.oracle_matrix_fallback(d).digest() for d in docs]


def test_oracle_copy_matches_jax_oracle_on_the_fixture():
    for obj in cw.load_json(cw.MATRIX_FIXTURE)["docs"]:
        ref = RefSharedMatrix(obj["doc_id"])
        port = SharedMatrix(obj["doc_id"])
        doc = cw.matrix_doc_from_json(obj)
        if doc.base_summary is not None:
            ref.load(ref_doc(obj).base_summary)
            port.load(doc.base_summary)
        for m in obj["ops"]:
            ref.process(RefMsg.from_dict(m), local=False)
        for m in doc.ops:
            port.process(m, local=False)
        ref.advance(obj["final_seq"], obj["final_msn"])
        port.advance(obj["final_seq"], obj["final_msn"])
        assert port.summarize().digest() == ref.summarize().digest()


def test_plain_version_counts_no_launch():
    entries = (matrix_fold_cuda.fold_resolving,)
    before = [(e.launches, dict(e.placements)) for e in entries]
    mk.replay_matrix_batch([cw.gen_matrix_doc(i, 16) for i in range(3)],
                           device="cpu")
    assert [(e.launches, e.placements) for e in entries] == before


COLD_CORPORA = sorted(c for c in CORPORA if c != "fixture")


@pytest.mark.parametrize("corpus", COLD_CORPORA)
def test_plain_cold_fold_matches_jax_on_the_fill_state(corpus):
    """``replay_scan_resolving(..., cold=True)`` builds the pack's fill
    state itself and folds it as the JAX package folds the packed one."""
    ref_docs = CORPORA[corpus]()
    state, ops, _meta = ref_mk.pack_matrix_batch(ref_docs)
    want, want_resolved = _ref_fold(state, ops)
    S = np.asarray(state.tstart).shape[1]
    final, resolved = mk.replay_scan_resolving(
        None, tensors_to(ops, "cpu"), cold=True, S=S)
    got = {f: x.numpy() for f, x in final._asdict().items()}
    for f in want:
        assert want[f].dtype == got[f].dtype, f
        np.testing.assert_array_equal(want[f], got[f], err_msg=f)
    np.testing.assert_array_equal(want_resolved, resolved.numpy())
    fill = mk.matrix_fill_state(len(state.n), S, "cpu")
    for f in mk.MTState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                      getattr(fill, f).numpy(), err_msg=f)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_kernel_wrapper_cpu_path_matches_jax_cold_and_warm(corpus):
    """``matrix_fold_cuda.fold_resolving`` on CPU tensors: warm from the
    packed state, and cold (no state) where no document has a base
    summary; every plane, ``n``, ``overflow`` and handle as the JAX
    package's, and no violation counted."""
    ref_docs = [d for d in CORPORA[corpus]()
                if not ref_mk.known_matrix_fallback(d)]
    state, ops, _m = ref_mk.pack_matrix_batch(ref_docs)
    want, want_resolved = _ref_fold(state, ops)
    _s, _o, meta = mk.pack_matrix_batch(
        [matrix_doc_input_from(d) for d in ref_docs])
    runs = [tensors_to(state, "cpu")] + ([None] if meta["cold"] else [])
    for st in runs:
        final, resolved, violations = matrix_fold_cuda.fold_resolving(
            st, tensors_to(ops, "cpu"), cold=st is None,
            S=np.asarray(state.tstart).shape[1])
        for f in want:
            np.testing.assert_array_equal(
                want[f], getattr(final, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(want_resolved, resolved.numpy())
        assert not violations.any()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_pack_never_writes_an_obliterate_plane(corpus):
    state, _ops, _meta = mk.pack_matrix_batch(
        [matrix_doc_input_from(d) for d in CORPORA[corpus]()])
    for f, fill in mk.MATRIX_OB_FILL.items():
        assert (getattr(state, f) == fill).all(), f


def test_cold_flag_is_false_when_any_document_has_a_base():
    fixture = cw.hard_matrix_docs()
    assert any(d.base_summary is not None for d in fixture)
    work = [cw.gen_matrix_doc(i, 16) for i in range(4)]
    assert mk.pack_matrix_batch(work)[2]["cold"] is True
    assert mk.pack_matrix_batch(fixture)[2]["cold"] is False
    based = [d for d in fixture if d.base_summary is not None][:1]
    assert mk.pack_matrix_batch(work + based)[2]["cold"] is False


def _violate(fact, state, ops):
    """The packed batch with one matrix fact broken."""
    st, op = tensors_to(state, "cpu"), tensors_to(ops, "cpu")
    if fact in ("obliterate-row", "annotate-row", "unknown-kind"):
        kind = op.kind.clone()
        kind[1, 2] = {"obliterate-row": 4, "annotate-row": 3,
                      "unknown-kind": 7}[fact]
        return st, op._replace(kind=kind)
    if fact == "props-write":
        pvals = op.pvals.clone()
        pvals[0, 1, 0] = 3
        return st, op._replace(pvals=pvals)
    if fact == "two-props-keys":
        return st, op._replace(pvals=op.pvals.repeat(1, 1, 2))
    plane = fact.split(":")[1]
    stamped = getattr(st, plane).clone()
    stamped[_based_stream(state), 0] = 5
    return st._replace(**{plane: stamped}), op


def _based_stream(state):
    """A stream whose base summary gave it live slots."""
    return int(np.nonzero(np.asarray(state.n))[0][0])


@pytest.mark.parametrize("fact", [
    "obliterate-row", "annotate-row", "unknown-kind", "props-write",
    "two-props-keys", "ob-stamp:ob1_seq", "ob-stamp:ob1_client",
    "ob-stamp:ob2_seq", "ob-stamp:ob2_client"])
def test_kernel_wrapper_cpu_path_raises_on_each_violated_fact(fact):
    """The facts the kernel holds (rows of kinds 0, 1, 2, 5; no props
    write, K = 1; no obliterate stamp on a live slot): the CPU path checks
    them on the host and raises, as the entry raises on the kernel's
    count."""
    docs = cw.hard_matrix_docs()
    state, ops, _meta = mk.pack_matrix_batch(
        [d for d in docs if not mk.known_matrix_fallback(d)])
    st, op = _violate(fact, state, ops)
    with pytest.raises(ValueError, match="facts do not hold"):
        matrix_fold_cuda.fold_resolving(st, op)
    assert matrix_fold_cuda.fact_violations(st, op)
    # a stamp on a dead slot, or the fill itself, is no violation
    if fact.startswith("ob-stamp"):
        plane = fact.split(":")[1]
        d = _based_stream(state)
        dead = getattr(tensors_to(state, "cpu"), plane).clone()
        dead[d, -1] = 5
        assert 0 < int(state.n[d]) < dead.shape[1]
        assert not matrix_fold_cuda.fact_violations(
            tensors_to(state, "cpu")._replace(**{plane: dead}),
            tensors_to(ops, "cpu"))


def test_check_facts_raises_on_a_counted_violation():
    matrix_fold_cuda.check_facts(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="streams"):
        matrix_fold_cuda.check_facts(np.array([0, 0, 2, 0], np.int32))
    with pytest.raises(ValueError, match="streams"):
        matrix_fold_cuda.check_facts(torch.tensor([1], dtype=torch.int32))


@pytest.mark.parametrize("cold", [True, False])
def test_entry_moves_only_the_summary_planes(cold):
    """The entry's transfer bytes: the ops up (and the state only when a
    document has a base), and down ``n``, ``overflow``, the violation
    counts, the handles and the summary planes up to the largest ``n``."""
    docs = [cw.gen_matrix_doc(i, 24) for i in range(6)]
    if not cold:
        docs += [d for d in cw.hard_matrix_docs()
                 if d.base_summary is not None
                 and not mk.known_matrix_fallback(d)]
    state, ops, meta = mk.pack_matrix_batch(docs)
    assert meta["cold"] is cold
    stage = {}
    got = mk.replay_matrix_batch(docs, stage=stage, device="cpu")
    assert [s.digest() for s in got] == \
        [mk.oracle_matrix_fallback(d).digest() for d in docs]
    final, _r = mk.replay_scan_resolving(tensors_to(state, "cpu"),
                                         tensors_to(ops, "cpu"))
    D2, T = ops.kind.shape
    width = int(final.n.max())
    up = sum(x.nbytes for x in ops) + (0 if cold else sum(
        x.nbytes for x in state))
    down = D2 * (4 + 1 + 4) + D2 * T * 4 \
        + len(mk.SUMMARY_FIELDS) * D2 * width * 4
    assert (stage["h2d_bytes"], stage["d2h_bytes"]) == (up, down)
    assert width < state.tstart.shape[1]


def test_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.replay_matrix_batch([cw.gen_matrix_doc(0, 8)])


def test_wrapper_refuses_non_cuda_non_cpu_tensors():
    state_np, ops_np, _m = mk.pack_matrix_batch([cw.gen_matrix_doc(0, 8)])
    with pytest.raises(ValueError, match="cpu or cuda"):
        matrix_fold_cuda.fold_resolving(tensors_to(state_np, "meta"),
                                        tensors_to(ops_np, "meta"))


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        with open(cw.MATRIX_FIXTURE, "w") as f:
            f.write(json.dumps(fresh_fixture(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    else:
        sys.exit("usage: python -m tests.test_torch_matrix_kernel "
                 "--write-fixture")
