"""The port's SharedMap catch-up against the JAX package's and the oracle's:
``pack_map_batch`` (every array and meta), the plain LWW reduction (K7)
against ``_map_lww_kernel`` on every key entry, padding included,
``replay_map_batch(device="cpu")`` summaries and ``stats``, the workload
copy, the committed fixture, and the crafted empty-segment cases.

Regenerate the fixture (after a change to the JAX package's map fuzz)
with ``python -m tests.test_torch_map_kernel --write-fixture``."""

import json
import sys

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds import SharedMap as RefSharedMap
from fluidframework_tpu.ops import map_kernel as ref_mp
from fluidframework_tpu.protocol.messages import MessageType as RefType
from fluidframework_tpu.protocol.messages import SequencedMessage as RefMsg
from fluidframework_tpu.testing.fuzz import MapFuzzSpec, run_fuzz
from fluidframework_tpu.testing.mocks import channel_log
from fluidframework_tpu_torch.convert import map_batch_from, map_doc_input_from
from fluidframework_tpu_torch.ops import map_kernel as mp
from fluidframework_tpu_torch.ops import map_lww_cuda
from fluidframework_tpu_torch.testing import config_workloads as cw
from tools import bench_configs

torch.set_num_threads(1)


def _ref_msg(seq, client, contents, ref_seq=None):
    return RefMsg(seq=seq, client_id=client, client_seq=seq,
                  ref_seq=seq - 1 if ref_seq is None else ref_seq,
                  min_seq=0, type=RefType.OP, contents=contents)


def fresh_fixture():
    """The map fixture, from the JAX package's fuzz harness: the fuzz logs
    of tests/test_map_kernel.py (seeds 0-5 and the batch's 100-104), its
    base-summary tail, an empty and a clear-only document."""
    docs = []
    for seed in range(6):
        _r, factory = run_fuzz(MapFuzzSpec(), seed=seed, n_clients=3,
                               rounds=25)
        docs.append(ref_mp.MapDocInput(f"fuzz-{seed}",
                                       channel_log(factory, "fuzz")))
    for seed in range(100, 105):
        _r, factory = run_fuzz(MapFuzzSpec(), seed=seed, n_clients=2,
                               rounds=10)
        docs.append(ref_mp.MapDocInput(f"fuzz-{seed}",
                                       channel_log(factory, "fuzz")))
    _r, factory = run_fuzz(MapFuzzSpec(), seed=7, n_clients=3, rounds=12)
    ops = channel_log(factory, "fuzz")
    mid_seq = ops[len(ops) // 2].seq
    partial = RefSharedMap("fuzz")
    for msg in ops:
        if msg.seq <= mid_seq:
            partial.process(msg, local=False)
    base = json.loads(partial.summarize().blob_bytes("header"))["data"]
    docs.append(ref_mp.MapDocInput("base-tail",
                                   [m for m in ops if m.seq > mid_seq],
                                   base=base))
    docs.append(ref_mp.MapDocInput("empty", ops=[]))
    docs.append(ref_mp.MapDocInput(
        "cleared", ops=[_ref_msg(5, "A", {"kind": "clear"}, ref_seq=0)],
        base={"k": 1}))
    return {"docs": [cw.map_doc_to_json(d) for d in docs]}


def ref_doc(obj: dict) -> ref_mp.MapDocInput:
    """The JAX package's input for a fixture document."""
    return ref_mp.MapDocInput(
        doc_id=obj["doc_id"], ops=[RefMsg.from_dict(m) for m in obj["ops"]],
        base=obj["base"])


def crafted_docs(case: str):
    """A crafted case of the port's workload module, as JAX-package
    inputs."""
    return [ref_doc(cw.map_doc_to_json(d)) for d in cw.crafted_map_docs(case)]




def _fixture_ref_docs():
    return [ref_doc(d) for d in cw.load_json(cw.MAP_FIXTURE)["docs"]]


CORPORA = {
    "fixture": _fixture_ref_docs,
    "workload-24x96": lambda: [bench_configs.gen_map_doc(i, 96)
                               for i in range(24)],
    **{f"crafted-{c}": (lambda c=c: crafted_docs(c)) for c in cw.CRAFTED_MAP},
}


def test_committed_fixture_is_a_fresh_dump():
    fresh = json.loads(json.dumps(fresh_fixture()))
    assert cw.load_json(cw.MAP_FIXTURE) == fresh


def test_fixture_docs_round_trip():
    docs = cw.hard_map_docs()
    assert [cw.map_doc_to_json(d) for d in docs] == \
        cw.load_json(cw.MAP_FIXTURE)["docs"]
    assert [d.doc_id for d in docs][-2:] == ["empty", "cleared"]


@pytest.mark.parametrize("n_ops", [24, 96])
def test_workload_matches_bench_configs(n_ops):
    for i in range(32):
        r, p = bench_configs.gen_map_doc(i, n_ops), cw.gen_map_doc(i, n_ops)
        assert p.doc_id == r.doc_id and p.base == r.base
        assert [m.to_dict() for m in p.ops] == [m.to_dict() for m in r.ops]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_pack_matches_jax_package(corpus):
    ref_docs = CORPORA[corpus]()
    r = ref_mp.pack_map_batch(ref_docs)
    p = mp.pack_map_batch([map_doc_input_from(d) for d in ref_docs])
    for f in ("key_gid", "op_seq", "is_set", "val_idx", "key_doc",
              "clear_doc", "clear_seq"):
        a, b = getattr(r, f), getattr(p, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (r.num_keys, r.num_docs, r.doc_ids) == \
        (p.num_keys, p.num_docs, p.doc_ids)
    assert r.keys == p.keys
    assert list(r.values.values) == list(p.values.values)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_plain_lww_matches_jax_kernel_on_every_key(corpus):
    ref_docs = CORPORA[corpus]()
    packed = ref_mp.pack_map_batch(ref_docs)
    want_present, want_val = ref_mp._map_lww_kernel(
        packed.key_gid, packed.op_seq, packed.is_set, packed.val_idx,
        packed.key_doc, packed.clear_doc, packed.clear_seq,
        num_keys=packed.num_keys, num_docs=packed.num_docs)
    got_present, got_val = map_lww_cuda.lww(map_batch_from(packed, "cpu"),
                                            packed.num_docs)
    assert got_present.dtype == torch.bool and got_val.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_present),
                                  got_present.numpy())
    np.testing.assert_array_equal(np.asarray(want_val), got_val.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_plain_lww_matches_jax_kernel_on_adversarial_inputs(seed):
    """Inputs no packer emits (``adversarial_lww_inputs``: shuffled rows,
    a key of thousands of rows, payloads below -1 and above 1, ids out of
    range on both sides, negative ``key_doc``, ties at INT32_MIN): the
    plain reduction equals the JAX package's on every key entry."""
    x, docs = cw.adversarial_lww_inputs(seed)
    N, G, M, _docs = cw.ADVERSARIAL_LWW_SHAPE
    want_present, want_val = ref_mp._map_lww_kernel(
        *x, num_keys=G, num_docs=docs)
    got_present, got_val = map_lww_cuda.lww(
        mp.LWWInputs(*(torch.from_numpy(a) for a in x)), docs)
    np.testing.assert_array_equal(np.asarray(want_present),
                                  got_present.numpy())
    np.testing.assert_array_equal(np.asarray(want_val), got_val.numpy())


def test_adversarial_inputs_hold_the_cases_they_name():
    """The generator's inputs do hold what its tests rely on: rows out of
    document order, a key of thousands of rows, payloads below -1 that
    win beside a loser (the -1 a loser adds shows in both outputs), every
    out-of-range id, and the three fixed keys' answers."""
    x, docs = cw.adversarial_lww_inputs(0)
    N, G, M, _docs = cw.ADVERSARIAL_LWW_SHAPE
    gid = x.key_gid
    assert np.bincount(gid[(gid >= 0) & (gid < G)]).max() >= 2000
    assert (np.diff(gid) < 0).sum() > N // 8
    for a in (x.is_set, x.val_idx):
        assert (a < -1).sum() > 100 and (a > 1).sum() > 100
        assert a.min() == -2 ** 31 and a.max() == 2 ** 31 - 1
    assert (gid < 0).any() and (gid >= G).any()
    assert (x.clear_doc < 0).any() and (x.clear_doc >= docs).any()
    assert (x.key_doc < 0).any() and (x.key_doc >= docs).any()
    present, win_val = map_lww_cuda.lww(
        mp.LWWInputs(*(torch.from_numpy(a) for a in x)), docs)
    assert win_val[7:10].tolist() == [-1, -3, -2 ** 31]
    assert not present[7:10].any()


def test_padding_keys_read_int32_min():
    """Key entries past the real keys are empty segments: INT32_MIN in
    ``win_val``, never present.  The last one takes the padding op rows
    (seq INT32_MIN, a delete of value -1), which win there: -1."""
    docs = [map_doc_input_from(d) for d in crafted_docs("base-no-clear")]
    batch = mp.pack_map_batch(docs)
    present, win_val = map_lww_cuda.lww(mp.lww_inputs(batch, "cpu"),
                                        batch.num_docs)
    real = len(batch.keys)
    assert real < batch.num_keys - 1
    assert (win_val[real:-1] == mp.INT32_MIN).all()
    assert int(win_val[-1]) == -1
    assert not present[real:].any()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_replay_matches_jax_package_and_oracle(corpus):
    ref_docs = CORPORA[corpus]()
    ref_stats, stats = {}, {}
    want = ref_mp.replay_map_batch(ref_docs, stats=ref_stats)
    docs = [map_doc_input_from(d) for d in ref_docs]
    got = mp.replay_map_batch(docs, stats=stats, device="cpu")
    assert [s.digest() for s in got] == [s.digest() for s in want]
    assert [s.digest() for s in got] == \
        [mp.oracle_map_summary(d).digest() for d in docs]
    assert stats == ref_stats == {"device_docs": len(docs)}


def test_replay_mixed_batch_of_fixture_and_workload():
    docs = cw.hard_map_docs() + [cw.gen_map_doc(i, 40 + 8 * i)
                                 for i in range(6)]
    got = mp.replay_map_batch(docs, device="cpu")
    assert [s.digest() for s in got] == \
        [mp.oracle_map_summary(d).digest() for d in docs]


def test_oracle_map_summary_matches_jax_oracle_on_fixture():
    for obj in cw.load_json(cw.MAP_FIXTURE)["docs"]:
        ref = RefSharedMap(obj["doc_id"])
        if obj["base"]:
            ref._kernel.load_obj({"data": obj["base"]})
        for m in obj["ops"]:
            ref.process(RefMsg.from_dict(m), local=False)
        assert mp.oracle_map_summary(cw.map_doc_from_json(obj)).digest() \
            == ref.summarize().digest(), obj["doc_id"]


def test_replay_of_no_docs_is_empty_and_launches_nothing():
    before = map_lww_cuda.lww.launches
    stats = {}
    assert mp.replay_map_batch([], stats=stats, device="cpu") == []
    assert stats == {"device_docs": 0}
    assert map_lww_cuda.lww.launches == before


def test_plain_version_counts_no_launch():
    docs = [cw.gen_map_doc(i, 16) for i in range(3)]
    before = map_lww_cuda.lww.launches
    mp.replay_map_batch(docs, device="cpu")
    assert map_lww_cuda.lww.launches == before


def test_launch_shape_follows_the_source():
    """``launch_shape`` mirrors the C entry: its thread count and grid cap
    are the source's, the row pass covers ``max(N, M)`` rows, and the
    scratch is two 64-bit and one 32-bit word a key and a word a
    document."""
    import os
    import re

    with open(os.path.join(os.path.dirname(map_lww_cuda.__file__), "..",
                           "csrc", "map_lww.cu")) as f:
        src = f.read()
    assert re.search(rf"constexpr int kThreads = {map_lww_cuda.THREADS};",
                     src)
    assert re.search(r"constexpr int kMaxBlocks = 132 \* 16;", src)
    assert map_lww_cuda.MAX_BLOCKS == 132 * 16
    shape = map_lww_cuda.launch_shape(1048576, 262144, 32768, 10240)
    assert shape == {"threads_per_block": 256, "row_blocks": 2112,
                     "key_blocks": 1024, "smem_bytes": 0,
                     "scratch_bytes": 20 * 262144 + 4 * 10240}
    assert map_lww_cuda.launch_shape(64, 64, 100, 1)["row_blocks"] == 1
    assert map_lww_cuda.launch_shape(0, 1, 0, 1)["row_blocks"] == 1


def test_entry_point_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.replay_map_batch([cw.gen_map_doc(0, 8)])


def test_wrapper_refuses_non_cuda_non_cpu_tensors():
    inputs = mp.LWWInputs(*[torch.zeros(64, dtype=torch.int32,
                                        device="meta") for _ in range(7)])
    with pytest.raises(ValueError, match="cpu or cuda"):
        map_lww_cuda.lww(inputs, 1)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        with open(cw.MAP_FIXTURE, "w") as f:
            f.write(json.dumps(fresh_fixture(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    else:
        sys.exit("usage: python -m tests.test_torch_map_kernel "
                 "--write-fixture")
