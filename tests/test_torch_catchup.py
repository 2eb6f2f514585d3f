"""The service seam: the port's ``CatchupService(device="cpu")`` against
the JAX package's ``CatchupService(mesh=None)`` on the same store and op
log, carried across with ``convert.load_service_corpus``.  Each scenario
mirrors one of the reference's service tests (named in its docstring);
``tests/torch_service.ServicePair`` asserts equal results, stats deltas,
route counters, stage byte counters and keys, and every tier's
``stats()`` at each catch-up."""

import json
import random

import pytest
import torch

import bench
from fluidframework_tpu.drivers import LocalDocumentServiceFactory
from fluidframework_tpu.loader import Loader
from fluidframework_tpu.runtime.container import (
    ContainerRuntime as RefRuntime)
from fluidframework_tpu.service import LocalOrderingService as RefOrdering
from fluidframework_tpu_torch.parallel import doc_mesh
from fluidframework_tpu_torch.runtime.container import ContainerRuntime
from fluidframework_tpu_torch.service import LocalOrderingService
from fluidframework_tpu_torch.service.catchup import CatchupService
from fluidframework_tpu_torch.testing import service_workload as sw
from tests.test_attribution import build, build_string_only, make_stack
from tests.test_service import _drive_mixed_doc, _seed_string_doc
from tests.torch_service import ServicePair, reference_service

# The CPU folds here run on small tensors, where torch's intra-op thread
# pool costs several times the work it splits.
torch.set_num_threads(1)


def _loaded(pair, doc_id):
    """A port runtime loaded from the port service's latest summary."""
    tree, seq = pair.port_service.storage.latest(doc_id)
    rt = ContainerRuntime()
    rt.load(tree)
    return rt, tree, seq


# --- tests/test_service.py ---------------------------------------------------


def test_catchup_cpu_vs_device_byte_identical():
    """tests/test_service.py::test_catchup_cpu_vs_device_byte_identical:
    the device route equals the forced container fold, on both sides."""
    service = RefOrdering()
    for d in range(3):
        _seed_string_doc(service, f"doc{d}", edits=12)
    cpu = ServicePair(service, cpu=True)
    cpu_results = cpu.catch_up(upload=False)
    dev = ServicePair(service)
    dev_results = dev.catch_up(upload=False)
    assert dev.port.device_docs == 3 and cpu.port.cpu_docs == 3
    assert cpu_results == dev_results


def test_catchup_uploads_and_is_incremental():
    """tests/test_service.py::test_catchup_uploads_and_is_incremental."""
    service = RefOrdering()
    runtimes = _seed_string_doc(service, "doc", edits=8)
    pair = ServicePair(service)
    handle, seq = pair.catch_up()["doc"]
    rt, tree, latest_seq = _loaded(pair, "doc")
    assert tree.digest() == handle and latest_seq == seq
    assert pair.catch_up()["doc"] == (handle, seq)  # no new ops
    assert pair.port_service.oplog.get("doc", from_seq=rt.ref_seq) == []
    live = runtimes[0].get_datastore("ds").get_channel("text").text
    assert rt.get_datastore("ds").get_channel("text").text == live


def test_catchup_preserves_seeded_attach_content():
    """tests/test_service.py::test_catchup_preserves_seeded_attach_content:
    a seeded attach summary warm-folds on the device."""
    service = RefOrdering()
    loader = Loader(LocalDocumentServiceFactory(service))

    def seed(rt):
        rt.create_datastore("ds").create_channel(
            "sequence-tpu", "text").insert_text(0, "SEEDED-")

    a = loader.create("doc", "alice", seed)
    a.runtime.get_datastore("ds").get_channel("text").insert_text(7, "tail")
    a.drain()
    pair = ServicePair(service)
    pair.catch_up()
    assert pair.port.device_docs == 1 and pair.port.cpu_docs == 0
    rt, _tree, _seq = _loaded(pair, "doc")
    assert rt.get_datastore("ds").get_channel("text").text == "SEEDED-tail"


def test_catchup_warm_start_from_prior_summary_on_device():
    """tests/test_service.py::
    test_catchup_warm_start_from_prior_summary_on_device: prior summary +
    tail, folded on the device each round, equal to the container fold."""
    service = RefOrdering()
    runtimes = _seed_string_doc(service, "doc", edits=10)
    pair = ServicePair(service)
    pair.catch_up()
    rng = random.Random("warm")
    for round_idx in range(3):
        for i in range(8):
            t = runtimes[i % len(runtimes)].get_datastore("ds") \
                .get_channel("text")
            L = len(t.text)
            if L < 4 or rng.random() < 0.7:
                t.insert_text(rng.randint(0, L), f"w{round_idx}")
            else:
                s = rng.randint(0, L - 2)
                t.remove_range(s, min(L, s + 2))
            for r in runtimes:
                r.drain()
        before = pair.port.device_docs
        cpu = ServicePair(service, cpu=True)
        cpu_result = cpu.catch_up(upload=False)
        result = pair.catch_up()
        assert pair.port.device_docs == before + 1
        assert cpu_result["doc"] == result["doc"]
    rt, _tree, seq = _loaded(pair, "doc")
    assert pair.port_service.oplog.get("doc", from_seq=seq) == []
    live = runtimes[0].get_datastore("ds").get_channel("text").text
    assert rt.get_datastore("ds").get_channel("text").text == live


def test_catchup_mixed_eligibility():
    """tests/test_service.py::test_catchup_mixed_eligibility: string and
    map documents both ride the device plan."""
    service = RefOrdering()
    _seed_string_doc(service, "strdoc", edits=6)
    ep = service.create_document("mapdoc")
    seeded = RefRuntime()
    seeded.create_datastore("ds").create_channel("map-tpu", "kv")
    service.storage.upload("mapdoc", seeded.summarize(), 0)
    rt = RefRuntime()
    rt.load(service.storage.latest("mapdoc")[0])
    rt.connect(ep, "m0")
    rt.drain()
    kv = rt.get_datastore("ds").get_channel("kv")
    kv.set("x", 1)
    kv.set("y", 2)
    rt.drain()
    pair = ServicePair(service)
    assert set(pair.catch_up()) == {"strdoc", "mapdoc"}
    assert pair.port.device_docs == 2 and pair.port.cpu_docs == 0
    check, _tree, _seq = _loaded(pair, "mapdoc")
    loaded_kv = check.get_datastore("ds").get_channel("kv")
    assert loaded_kv.get("x") == 1 and loaded_kv.get("y") == 2


def _reference_mixed_corpus(service, rng, n_docs=3):
    """The reference's mixed-types setup (five channels, two clients)."""
    all_runtimes = {}
    for d in range(n_docs):
        doc_id = f"mixed{d}"
        ep = service.create_document(doc_id)
        seeded = RefRuntime()
        ds = seeded.create_datastore("ds")
        for type_name, channel_id in sw.MIXED_CHANNELS:
            ds.create_channel(type_name, channel_id)
        service.storage.upload(doc_id, seeded.summarize(), 0)
        runtimes = []
        for c in range(2):
            rt = RefRuntime()
            rt.load(service.storage.latest(doc_id)[0])
            rt.connect(ep, f"client{c}")
            rt.drain()
            runtimes.append(rt)
        all_runtimes[doc_id] = runtimes
        _drive_mixed_doc(runtimes, rng, rounds=8)
    return all_runtimes


def test_catchup_mixed_types_fold_on_device():
    """tests/test_service.py::test_catchup_mixed_types_fold_on_device:
    string + map + matrix + tree + counter documents, a cold and a warm
    round; kernel channels on the device, the counter host-side, every
    summary equal to the forced container fold."""
    service = RefOrdering()
    rng = random.Random("mixed")
    all_runtimes = _reference_mixed_corpus(service, rng)
    pair = ServicePair(service)
    cpu = ServicePair(service, cpu=True)
    for round_idx in range(2):
        cpu_results = cpu.catch_up(upload=False)
        results = pair.catch_up()
        assert pair.port.device_docs == 3 * (round_idx + 1)
        assert pair.port.cpu_docs == 0 and pair.port.host_channels > 0
        assert results == cpu_results
        for runtimes in all_runtimes.values():
            _drive_mixed_doc(runtimes, rng, rounds=6)


def test_catchup_host_fold_observes_leave():
    """tests/test_service.py::test_catchup_host_fold_observes_leave: the
    host-side consensus fold sees the tail's LEAVE."""
    service = RefOrdering()
    ep = service.create_document("qdoc")
    seeded = RefRuntime()
    ds = seeded.create_datastore("ds")
    ds.create_channel("ordered-collection-tpu", "queue")
    ds.create_channel("sequence-tpu", "text")
    service.storage.upload("qdoc", seeded.summarize(), 0)
    worker, other = RefRuntime(), RefRuntime()
    for rt, name in ((worker, "worker"), (other, "observer")):
        rt.load(service.storage.latest("qdoc")[0])
        rt.connect(ep, name)
        rt.drain()
    q = worker.get_datastore("ds").get_channel("queue")
    q.add("job-1")
    worker.drain()
    other.drain()
    q.acquire()
    worker.drain()
    other.drain()
    ep.disconnect("worker")
    other.drain()
    pair = ServicePair(service)
    cpu = ServicePair(service, cpu=True)
    assert pair.catch_up(upload=False) == cpu.catch_up(upload=False)
    assert pair.port.device_docs == 1 and pair.port.host_channels >= 1


# --- tests/test_attribution.py -----------------------------------------------


def _two_author_clamp(a, b, channel="text"):
    """foo by alice, bar by bob, then traffic that lifts the window past
    both inserts (the reference's clamp setup)."""
    ta = a.runtime.get_datastore("ds").get_channel(channel)
    tb = b.runtime.get_datastore("ds").get_channel(channel)
    ta.insert_text(0, "foo")
    a.runtime.flush()
    a.drain(), b.drain()
    tb.insert_text(3, "bar")
    b.runtime.flush()
    a.drain(), b.drain()
    for _k in range(3):
        ta.insert_text(len(ta.text), ".")
        a.runtime.flush()
        a.drain(), b.drain()
        tb.insert_text(len(tb.text), "!")
        b.runtime.flush()
        a.drain(), b.drain()
    return ta, tb


def test_catchup_service_preserves_attribution():
    """tests/test_attribution.py::test_catchup_service_preserves_attribution
    (string + tree channels)."""
    service, loader = make_stack()
    a = loader.create("doc", "alice", build)
    ta = a.runtime.get_datastore("ds").get_channel("text")
    ta.insert_text(0, "served")
    a.runtime.flush()
    a.drain()
    cpu = ServicePair(service, cpu=True)
    cpu_results = cpu.catch_up(upload=False)
    pair = ServicePair(service)
    assert pair.catch_up(upload=False) == cpu_results
    assert pair.port.device_docs == 1 and pair.port.cpu_docs == 0
    pair.catch_up()
    rt, tree, _seq = _loaded(pair, "doc")
    assert json.loads(tree.blob_bytes(".metadata"))["attribution"] is True
    assert ".attribution" in tree.children
    assert rt.get_datastore("ds").get_channel("text") \
        .attribution_at(0)["user"] == "alice"


def test_catchup_device_path_preserves_attribution():
    """tests/test_attribution.py::
    test_catchup_device_path_preserves_attribution: a clamped,
    author-merged run keeps both authors through the device fold."""
    service, loader = make_stack()
    a = loader.create("doc", "alice", build_string_only)
    b = loader.resolve("doc", client_id="bob")
    _two_author_clamp(a, b)
    cpu = ServicePair(service, cpu=True)
    cpu_results = cpu.catch_up(upload=False)
    pair = ServicePair(service)
    assert pair.catch_up(upload=False) == cpu_results
    assert pair.port.device_docs == 1 and pair.port.cpu_docs == 0
    pair.catch_up()
    rt, tree, _seq = _loaded(pair, "doc")
    string_summary = tree.get(".datastores").get("ds").get("text")
    assert "attribution" in string_summary.children
    text = rt.get_datastore("ds").get_channel("text")
    assert text.attribution_at(0)["user"] == "alice"
    assert text.attribution_at(3)["user"] == "bob"


def test_catchup_device_tree_attribution_with_window_clamp():
    """tests/test_attribution.py::
    test_catchup_device_tree_attribution_with_window_clamp."""
    def build_tree_only(rt):
        rt.create_datastore("ds").create_channel("tree-tpu", "tree")

    service, loader = make_stack()
    a = loader.create("doc", "alice", build_tree_only)
    b = loader.resolve("doc", client_id="bob")
    tra = a.runtime.get_datastore("ds").get_channel("tree")
    trb = b.runtime.get_datastore("ds").get_channel("tree")
    tra.insert("", "items", 0, [{"id": "n0", "type": "t", "value": 1}])
    a.runtime.flush()
    a.drain(), b.drain()
    trb.set_value("n0", 2)
    trb.insert("", "items", 1, [{"id": "n1", "type": "t", "value": 7}])
    b.runtime.flush()
    a.drain(), b.drain()
    for k in range(3):
        tra.set_value("n1", 10 + k)
        a.runtime.flush()
        a.drain(), b.drain()
        trb.set_value("n1", 20 + k)
        b.runtime.flush()
        a.drain(), b.drain()
    cpu = ServicePair(service, cpu=True)
    cpu_results = cpu.catch_up(upload=False)
    pair = ServicePair(service)
    assert pair.catch_up(upload=False) == cpu_results
    assert pair.port.device_docs == 1 and pair.port.cpu_docs == 0
    pair.catch_up()
    rt, _tree, _seq = _loaded(pair, "doc")
    tree = rt.get_datastore("ds").get_channel("tree")
    assert tree.attribution_of("n0")["user"] == "alice"
    assert tree.attribution_of("n1")["user"] == "bob"


def test_catchup_device_warm_string_attribution_base():
    """tests/test_attribution.py::
    test_catchup_device_warm_string_attribution_base: a warm base that
    carries a key blob re-folds to identical body and keys."""
    service, loader = make_stack()
    a = loader.create("doc", "alice", build_string_only)
    b = loader.resolve("doc", client_id="bob")
    ta, _tb = _two_author_clamp(a, b)
    first = ServicePair(service)
    first.catch_up()
    _rt, base, _seq = _loaded(first, "doc")
    assert "attribution" in base.get(".datastores").get("ds") \
        .get("text").children
    ta.insert_text(0, "warm:")
    a.runtime.flush()
    a.drain(), b.drain()
    cpu = ServicePair(service, cpu=True)
    cpu_results = cpu.catch_up(upload=False)
    assert first.catch_up(upload=False) == cpu_results
    assert first.port.device_docs == 2 and first.port.cpu_docs == 0
    first.catch_up()
    rt, _tree, _seq = _loaded(first, "doc")
    text = rt.get_datastore("ds").get_channel("text")
    assert text.text.startswith("warm:")
    assert text.attribution_at(5)["user"] == "alice"
    assert text.attribution_at(8)["user"] == "bob"


# --- tests/test_delta_download.py, tests/test_device_cache.py ----------------


def test_service_tier0_serves_when_tier1_is_off():
    """tests/test_delta_download.py::
    test_service_tier0_serves_when_tier1_is_off."""
    service = RefOrdering()
    doc_ids = bench.build_catchup_corpus(service, 6, 14)
    pair = ServicePair(service, cache=None)
    plain = ServicePair(service, cache=None, pack_cache=None,
                        delta_cache=None, device_cache=None)
    expect = plain.catch_up(doc_ids, upload=False)
    assert pair.catch_up(doc_ids, upload=False) == expect
    assert pair.catch_up(doc_ids, upload=False) == expect
    assert pair.port.delta_cache.stats()["served"] == 6
    assert pair.port.pipeline_stats.get("delta_docs", 0) == 6


@pytest.mark.parametrize("gate,tiers", [
    ("CATCHUP_CACHE", ("cache",)),
    ("CATCHUP_PACKCACHE", ("_pack_cache", "tree_pack_cache")),
    ("CATCHUP_DELTADOWNLOAD", ("delta_cache",)),
    ("CATCHUP_DEVICERESIDENT", ("device_cache", "tree_device_cache")),
])
def test_service_tier_gate_off(monkeypatch, gate, tiers):
    """tests/test_delta_download.py::test_service_delta_gate_off and
    tests/test_device_cache.py::test_service_device_gate_off, for every
    tier gate: the gate turns its tier off for every family."""
    from fluidframework_tpu.service.catchup import CatchupService as Ref

    monkeypatch.setenv(f"FLUID_TPU_{gate}", "off")
    port = CatchupService(LocalOrderingService(), mesh=None, device="cpu")
    ref = Ref(RefOrdering(), mesh=None)
    for name in tiers:
        assert getattr(port, name) is None and getattr(ref, name) is None
    on = {"cache", "_pack_cache", "delta_cache", "device_cache",
          "tree_pack_cache", "tree_device_cache"} - set(tiers)
    assert all(getattr(port, name) is not None for name in on)


# --- the card's corpora at small sizes ----------------------------------------


def test_port_corpus_builders_match_reference():
    """The port's service corpora are the reference builders' message for
    message: ``build_catchup_corpus`` (bench.py), the tree corpus
    (tools/bench_kernels.py) and the mixed driver (tests/test_service.py)."""
    from tools import bench_kernels

    def logs(svc):
        return {d: [m.to_dict() for m in svc.oplog.get(d)]
                for d in svc.doc_ids()}

    def heads(svc):
        return {d: svc.storage.latest(d)[0].digest() for d in svc.doc_ids()}

    for build_ref, build_port, args in (
            (bench.build_catchup_corpus, sw.build_catchup_corpus, (5, 24)),
            (bench_kernels.build_tree_catchup_corpus,
             sw.build_tree_catchup_corpus, (5, 24))):
        ref, port = RefOrdering(), LocalOrderingService()
        assert build_port(port, *args) == build_ref(ref, *args)
        assert logs(port) == logs(ref) and heads(port) == heads(ref)
    ref, port = RefOrdering(), LocalOrderingService()
    ref_rt = _reference_mixed_corpus(ref, random.Random("mixed"), n_docs=2)
    port_rng = random.Random("mixed")
    port_rt = sw.build_mixed_corpus(port, 2, port_rng)
    assert logs(port) == logs(ref) and heads(port) == heads(ref)
    ref_rng = random.Random("next")
    port_rng = random.Random("next")
    for doc_id in ref_rt:
        _drive_mixed_doc(ref_rt[doc_id], ref_rng, rounds=4)
        sw.drive_mixed_doc(port_rt[doc_id], port_rng, rounds=4)
    assert logs(port) == logs(ref)


def test_service_warm_tiers_without_tier1():
    """The card's S3 shape at a small size: tier 1 off, a cold pass, the
    exact pass again (no upload), then every 8th document grown along its
    stream (suffix splice and delta download) — equal to the reference
    at every pass and to a tiers-off instance."""
    port_service = LocalOrderingService()
    doc_ids = sw.build_catchup_corpus(port_service, 16, 26)
    service = reference_service(port_service)
    pair = ServicePair(service, cache=None)
    plain = ServicePair(service, cache=None, pack_cache=None,
                        delta_cache=None, device_cache=None)
    cold = pair.catch_up(doc_ids, upload=False)
    assert cold == plain.catch_up(doc_ids, upload=False)
    h2d = pair.port.pipeline_stage["h2d_bytes"]
    assert pair.catch_up(doc_ids, upload=False) == cold
    assert pair.port.pipeline_stage["h2d_bytes"] == h2d  # exact: 0 B up
    assert sw.grow_catchup_corpus(port_service, doc_ids, 26, 32,
                                  grow_every=8) == ["cdoc0", "cdoc8"]
    reference_service(port_service, into=service)
    grown = pair.catch_up(doc_ids, upload=False)
    assert grown == plain.catch_up(doc_ids, upload=False)
    assert pair.port.device_cache.stats()["spliced"] > 0
    assert pair.port.pipeline_stats.get("delta_docs", 0) > 0
    for doc_id in doc_ids[::5]:
        assert grown[doc_id][0] == sw.catchup_oracle_digest(
            pair.port_service, doc_id)


def test_service_tree_corpus_cold_and_warm():
    """The card's S4 shape at a small size: the tree corpus cold, then a
    pure tier-1 warm pass (no bytes, no fold)."""
    port_service = LocalOrderingService()
    doc_ids = sw.build_tree_catchup_corpus(port_service, 8, 24)
    pair = ServicePair(reference_service(port_service))
    cold = pair.catch_up(doc_ids, upload=False)
    stage = dict(pair.port.pipeline_stage)
    assert pair.catch_up(doc_ids, upload=False) == cold
    assert pair.port.cache.stats()["hits"] == len(doc_ids)
    assert pair.port.pipeline_stage == stage
    for doc_id in doc_ids:
        assert cold[doc_id][0] == sw.catchup_oracle_digest(
            pair.port_service, doc_id)


def test_service_attribution_corpus():
    """The card's S6 shape at a small size: attribution-enabled string
    documents whose window clamps their inserts fold on the device, equal
    to the container fold with their key blobs."""
    port_service = LocalOrderingService()
    doc_ids = sw.build_catchup_corpus(port_service, 6, 40, attribution=True)
    pair = ServicePair(reference_service(port_service))
    got = pair.catch_up(doc_ids, upload=False)
    assert pair.port.cpu_docs == 0 and pair.port.device_docs == len(doc_ids)
    keyed = 0
    for doc_id in doc_ids:
        assert got[doc_id][0] == sw.catchup_oracle_digest(port_service,
                                                          doc_id)
    pair.catch_up(doc_ids)
    for doc_id in doc_ids:
        tree, _seq = pair.port_service.storage.latest(doc_id)
        keyed += "attribution" in tree.get(".datastores").get("ds") \
            .get("text").children
    assert keyed == len(doc_ids)


# --- the port's own rules -------------------------------------------------------


@pytest.mark.parametrize("mesh", ["sharded", object(), 4])
def test_mesh_other_than_auto_or_none_raises(mesh):
    with pytest.raises(TypeError, match="mesh must be 'auto', None or"):
        CatchupService(LocalOrderingService(), mesh=mesh, device="cpu")
    for ok in ("auto", None, doc_mesh(["cpu", "cpu"])):
        CatchupService(LocalOrderingService(), mesh=ok, device="cpu")


def test_catchup_service_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CatchupService(LocalOrderingService())


def test_profile_dir_gate_writes_a_trace(tmp_path, monkeypatch):
    """``Catchup.ProfileDir`` wraps each bulk fold in a ``torch.profiler``
    trace written there; a pure tier-1 serve folds nothing and traces
    nothing."""
    monkeypatch.setenv("FLUID_TPU_CATCHUP_PROFILEDIR", str(tmp_path))
    service = LocalOrderingService()
    doc_ids = sw.build_catchup_corpus(service, 3, 12)
    svc = CatchupService(service, device="cpu")
    svc.catch_up(doc_ids, upload=False)
    traces = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert events
    svc.catch_up(doc_ids, upload=False)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
