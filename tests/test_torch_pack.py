"""The port's host legs against the JAX package's: packing, the pinned
workload generator and the committed hard-semantics fixture.

Regenerate the fixture (after a change to the JAX package's hard docs)
with ``python -m tests.test_torch_pack --write-fixture``."""

import json
import sys

import numpy as np
import pytest

import bench
from fluidframework_tpu.ops import mergetree_kernel as ref_mt
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from fluidframework_tpu_torch.ops import native_pack
from fluidframework_tpu_torch.testing import workload
from tests.torch_corpora import (FOLD_CORPORA, bench_docs, hard_docs,
                                 interval_docs, port_docs, warm_doc)

PACK_CORPORA = dict(FOLD_CORPORA)
PACK_CORPORA["intervals"] = interval_docs
PACK_CORPORA["warm"] = lambda: [warm_doc()]
# binary streams beside message documents: the per-document native fill
PACK_CORPORA["mixed"] = lambda: [warm_doc()] + bench_docs(5, 40) \
    + hard_docs()

_META_FACTS = ("_S", "props_K", "i16_ok", "i8_ok", "ob_rows", "ov_rows",
               "has_props", "sequential", "prop_keys")


def fresh_fixture():
    return {
        "hard_docs": [workload.doc_to_json(d) for d in hard_docs()],
        "overflow_doc": workload.doc_to_json(workload.overflow_doc()),
    }


@pytest.mark.parametrize("corpus", sorted(PACK_CORPORA))
def test_pack_matches_jax_package(corpus):
    ref_docs = PACK_CORPORA[corpus]()
    r_state, r_ops, r_meta = ref_mt.pack_mergetree_batch(ref_docs)
    p_state, p_ops, p_meta = mt.pack_mergetree_batch(port_docs(ref_docs))
    for f in r_state._fields:
        a, b = getattr(r_state, f), getattr(p_state, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in r_ops._fields:
        np.testing.assert_array_equal(getattr(r_ops, f), getattr(p_ops, f),
                                      err_msg=f)
    for k in _META_FACTS:
        assert r_meta[k] == p_meta[k], k
    np.testing.assert_array_equal(r_meta["doc_base"], p_meta["doc_base"])
    assert r_meta["arena"].finalize() == p_meta["arena"].finalize()
    assert list(r_meta["values"].values) == list(p_meta["values"].values)
    for rp, pp in zip(r_meta["doc_packs"], p_meta["doc_packs"]):
        assert list(rp.clients.values) == list(pp.clients.values)
        assert rp.needs_fallback == pp.needs_fallback
        assert [m.seq for m in rp.interval_ops] == \
            [m.seq for m in pp.interval_ops]


def test_pure_python_pack_matches_native(monkeypatch):
    """The port keeps the reference's pure-Python pack path (no g++):
    arrays equal to the C++ packer's (the record route, which every
    binary batch with no base takes)."""
    docs = [workload.synth_doc(i, 32) for i in range(12)]
    n_state, n_ops, _ = mt.pack_mergetree_batch(docs)
    monkeypatch.setattr(native_pack, "load_library", lambda: None)
    docs = [workload.synth_doc(i, 32) for i in range(12)]
    assert mt.slice_mergetree_pack(docs, 2) is None
    p_state, p_ops, _ = mt.pack_mergetree_batch(docs)
    for f in n_ops._fields:
        np.testing.assert_array_equal(getattr(n_ops, f), getattr(p_ops, f))
    for f in n_state._fields:
        np.testing.assert_array_equal(getattr(n_state, f),
                                      getattr(p_state, f))


def test_native_library_builds_into_port_build_dir():
    lib = native_pack.load_library()
    assert lib is not None
    assert native_pack._build_library().startswith(native_pack.BUILD_DIR)


@pytest.mark.parametrize("n_ops", [24, 96])
def test_synth_doc_matches_bench(n_ops):
    for i in range(64):
        r, p = bench.synth_doc(i, n_ops), workload.synth_doc(i, n_ops)
        assert r.binary_ops == p.binary_ops, i
        assert list(r.binary_clients) == list(p.binary_clients)
        assert r.binary_prop_keys == p.binary_prop_keys
        assert r.binary_values == p.binary_values
        assert (r.doc_id, r.final_seq, r.final_msn) == \
            (p.doc_id, p.final_seq, p.final_msn)


def test_committed_fixture_is_a_fresh_dump():
    fresh = json.loads(json.dumps(fresh_fixture()))
    assert workload.load_fixture() == fresh


def test_fixture_docs_round_trip():
    docs = workload.hard_docs()
    assert [d.doc_id for d in docs][-1] == "overflow"
    assert [workload.doc_to_json(d) for d in docs[:-1]] == \
        workload.load_fixture()["hard_docs"]


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        with open(workload.FIXTURE, "w") as f:
            f.write(json.dumps(fresh_fixture(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    else:
        sys.exit("usage: python -m tests.test_torch_pack --write-fixture")
