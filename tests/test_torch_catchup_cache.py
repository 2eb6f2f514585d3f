"""Tier 1 of the catch-up cache on the port: ``CatchupResultCache`` (LRU
byte accounting, an oversize entry, epoch invalidation, single-flight
publish / abandon, join timeouts and the stale reaper) and the port
service's crashed-leader and herd behaviour.  Each scenario is one of
tests/test_catchup_cache.py's, run as the same sequence on the JAX
package's class and on the port's, with equal results and ``stats()``."""

import threading
import time

import pytest
import torch

import bench
from fluidframework_tpu.protocol.summary import SummaryTree as RefTree
from fluidframework_tpu.service import LocalOrderingService as RefOrdering
from fluidframework_tpu.service import catchup_cache as ref_cc
from fluidframework_tpu.service.catchup import CatchupService as RefCatchup
from fluidframework_tpu_torch.protocol.summary import SummaryTree
from fluidframework_tpu_torch.service import LocalOrderingService
from fluidframework_tpu_torch.service import catchup_cache as cc
from fluidframework_tpu_torch.service.catchup import CatchupService
from fluidframework_tpu_torch.testing import service_workload as sw

torch.set_num_threads(1)

SIDES = {"ref": (ref_cc, RefTree), "port": (cc, SummaryTree)}


def _services():
    """The reference's and the port's catch-up service, each over a
    one-document corpus of the pinned stream built by its own package."""
    ref = RefOrdering()
    bench.build_catchup_corpus(ref, 1, 12)
    port = LocalOrderingService()
    sw.build_catchup_corpus(port, 1, 12)
    return {"ref": lambda **kw: RefCatchup(ref, mesh=None, **kw),
            "port": lambda **kw: CatchupService(port, device="cpu", **kw)}


def _blob_tree(tree_cls, payload_bytes):
    tree = tree_cls()
    tree.add_blob("body", b"x" * payload_bytes)
    return tree


def _both(scenario):
    """Run ``scenario(module, tree_cls)`` on both sides; its returns and
    the caches' ``stats()`` must be equal."""
    outs = {side: scenario(*SIDES[side]) for side in SIDES}
    assert outs["port"] == outs["ref"]
    return outs["port"]


def test_lru_byte_bound_and_eviction_order():
    def run(mod, tree):
        one = mod.tree_nbytes(_blob_tree(tree, 1000))
        cache = mod.CatchupResultCache(max_bytes=3 * one)
        for i in range(3):
            cache.insert(("e", f"d{i}"), _blob_tree(tree, 1000))
        assert len(cache) == 3 and cache.current_bytes == 3 * one
        assert cache.lookup(("e", "d0")) is not None
        cache.insert(("e", "d3"), _blob_tree(tree, 1000))
        hits = [cache.lookup(("e", f"d{i}")) is not None for i in range(4)]
        return one, hits, cache.stats()

    _one, hits, stats = _both(run)
    assert hits == [True, False, True, True], "LRU must evict d1 first"
    assert stats["evictions"] == 1 and stats["inserts"] == 4


def test_oversize_entry_never_admitted():
    def run(mod, tree):
        cache = mod.CatchupResultCache(max_bytes=400)
        cache.insert(("e", "small"), _blob_tree(tree, 10))
        fold = cache.insert(("e", "huge"), _blob_tree(tree, 10_000))
        return (fold.handle, cache.lookup(("e", "huge")) is None,
                cache.lookup(("e", "small")) is not None, cache.stats())

    _handle, huge_gone, small_kept, _stats = _both(run)
    assert huge_gone and small_kept


def test_reinsert_same_key_replaces_bytes():
    def run(mod, tree):
        cache = mod.CatchupResultCache(max_bytes=1 << 20)
        cache.insert(("e", "d"), _blob_tree(tree, 1000))
        before = cache.current_bytes
        cache.insert(("e", "d"), _blob_tree(tree, 2000))
        return len(cache), cache.current_bytes - before, cache.stats()

    assert _both(run)[:2] == (1, 1000)


def test_epoch_invalidation_drops_only_stale_generations():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        for key in (("old", "d0"), ("old", "d1"), ("new", "d0")):
            cache.insert(key, _blob_tree(tree, 10))
        dropped = cache.invalidate_epoch("new")
        again = cache.invalidate_epoch("new")  # unchanged epoch: O(1)
        return (dropped, again, cache.lookup(("old", "d0")) is None,
                cache.lookup(("new", "d0")) is not None, cache.stats())

    dropped, again, old_gone, new_kept, stats = _both(run)
    assert (dropped, again, old_gone, new_kept) == (2, 0, True, True)
    assert stats["invalidations"] == 2


def test_single_flight_leader_publishes_to_waiters():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        status, _ = cache.begin(key)
        got = []
        waiter = threading.Thread(target=lambda: got.append(cache.join(key)))
        waiter.start()
        while cache.stats()["waits"] == 0:
            time.sleep(0.001)
        body = _blob_tree(tree, 10)
        published = cache.finish(key, body)
        waiter.join(timeout=10)
        assert not waiter.is_alive()
        assert [f.tree for f in got] == [body]
        status2, fold = cache.begin(key)
        assert fold.tree is body
        return (status, published.handle == body.digest(), status2,
                fold.handle == published.handle, cache.stats())

    status, digested, status2, same, stats = _both(run)
    assert (status, digested, status2, same) == ("lead", True, "hit", True)
    assert stats["waits"] == 1


def test_single_flight_abandon_unblocks_waiters():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        assert cache.begin(key)[0] == "lead"
        got = []
        waiter = threading.Thread(target=lambda: got.append(cache.join(key)))
        waiter.start()
        while cache.stats()["waits"] == 0:
            time.sleep(0.001)
        cache.abandon(key)
        cache.abandon(key)  # safe on a key no longer in flight
        waiter.join(timeout=10)
        assert not waiter.is_alive()
        return got, cache.lookup(key), cache.stats()

    got, found, _stats = _both(run)
    assert got == [None] and found is None


def test_join_timeout_returns_none_when_leader_never_finishes():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        assert cache.begin(key)[0] == "lead"  # ...and the leader "crashes"
        t0 = time.monotonic()
        result = cache.join(key, timeout=0.1)
        assert time.monotonic() - t0 < 10
        reaped = key not in cache._flights
        return result, reaped, cache.stats()

    result, reaped, stats = _both(run)
    assert result is None and reaped and stats["waits"] == 1


def test_join_short_wait_leaves_the_flight():
    """A caller's deliberately short wait (``reap_on_timeout=False``)
    stops waiting without tearing the live leader's flight down."""
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        assert cache.begin(key)[0] == "lead"
        result = cache.join(key, timeout=0.05, reap_on_timeout=False)
        kept = key in cache._flights
        cache.finish(key, _blob_tree(tree, 10))
        return result, kept, cache.join(key) is not None, cache.stats()

    result, kept, served, _stats = _both(run)
    assert result is None and kept and served


def test_join_timeout_pop_is_identity_guarded():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        assert cache.begin(key)[0] == "lead"
        got = []
        waiter = threading.Thread(
            target=lambda: got.append(cache.join(key, timeout=0.8)))
        waiter.start()
        time.sleep(0.1)
        with cache._lock:
            cache._flights.pop(key)  # the stale flight vanishes ...
        assert cache.begin(key)[0] == "lead"  # ... and a new leader begins
        fresh = cache._flights[key]
        waiter.join(timeout=10)
        assert not waiter.is_alive()
        return got, cache._flights.get(key) is fresh, cache.stats()

    got, survived, _stats = _both(run)
    assert got == [None] and survived


def test_stale_timeout_reaper_does_not_wake_live_waiters():
    def run(mod, tree):
        cache = mod.CatchupResultCache()
        key = ("e", "doc")
        assert cache.begin(key)[0] == "lead"
        flight = cache._flights[key]
        got_timeout, got_result = [], []
        stale = threading.Thread(
            target=lambda: got_timeout.append(cache.join(key, timeout=0.3)))
        live = threading.Thread(
            target=lambda: got_result.append(cache.join(key, timeout=30)))
        stale.start()
        live.start()
        time.sleep(0.1)
        with cache._lock:
            cache._flights.pop(key)  # finish() preempted mid-publish
        stale.join(timeout=10)
        woken_early = flight.done.is_set() or bool(got_result)
        flight.result = "fold-result"
        flight.done.set()
        live.join(timeout=10)
        assert not stale.is_alive() and not live.is_alive()
        return got_timeout, woken_early, got_result, cache.stats()

    got_timeout, woken_early, got_result, _stats = _both(run)
    assert got_timeout == [None] and not woken_early
    assert got_result == ["fold-result"]


def test_default_join_timeout_matches_the_reference():
    assert cc.DEFAULT_JOIN_TIMEOUT == ref_cc.DEFAULT_JOIN_TIMEOUT


@pytest.mark.parametrize("n_threads", [8])
def test_concurrent_publishers_keep_byte_accounting(n_threads):
    """Many threads leading, publishing and looking up distinct keys over
    a small budget: the byte count always equals the sum of resident
    entries, on both classes."""
    import sys

    def run(mod, tree):
        cache = mod.CatchupResultCache(
            max_bytes=20 * mod.tree_nbytes(_blob_tree(tree, 100)))

        def work(t):
            for i in range(40):
                key = ("e", f"t{t}-d{i % 25}")
                status, _ = cache.begin(key)
                if status == "lead":
                    cache.finish(key, _blob_tree(tree, 100))
                cache.lookup(("e", f"t{(t + 1) % n_threads}-d{i % 25}"))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        with cache._lock:
            resident = sum(n for _fold, n in cache._entries.values())
            assert resident == cache._bytes <= cache.max_bytes
            assert not cache._flights
        stats = cache.stats()
        return stats["inserts"] - stats["evictions"] == stats["entries"]

    assert _both(run)


def test_catch_up_survives_crashed_leader():
    """A key left in flight forever (its leader died before the
    finally-abandon) times the follower out; the follower folds the
    document itself, byte-identically, and the next call single-flights
    normally again."""
    outs = {}
    for side, make in _services().items():
        svc = make()
        svc.join_timeout = 0.2
        store = svc.service.storage
        _summary, ref_seq, handle = store.latest_with_handle("cdoc0")
        tail = svc.service.oplog.get("cdoc0", from_seq=ref_seq)
        key = svc._cache_key("cdoc0", handle, ref_seq, tail)
        assert svc.cache.begin(key)[0] == "lead"  # the crashed leader
        t0 = time.monotonic()
        results = svc.catch_up(["cdoc0"], upload=False)
        assert time.monotonic() - t0 < 30, "follower must not hang"
        assert results == make(cache=None).catch_up(["cdoc0"], upload=False)
        assert svc.cache._flights == {}
        assert svc.catch_up(["cdoc0"], upload=False) == results
        outs[side] = (results, svc.cache.stats())
    assert outs["port"] == outs["ref"]


def test_join_timeout_config_gate(monkeypatch):
    monkeypatch.setenv("FLUID_TPU_CATCHUP_JOINTIMEOUT", "7.5")
    for make in _services().values():
        assert make().join_timeout == 7.5


def test_concurrent_catch_up_threads_cost_one_fold():
    """The thundering-herd contract: N concurrent catch-ups of the same
    (doc, seq) cost ONE fold; the rest wait on the in-flight key."""
    outs = {}
    for side, make in _services().items():
        svc = make()
        folding, release = threading.Event(), threading.Event()
        fold_calls = []
        real_fold = svc._device_fold

        def slow_fold(works, real_fold=real_fold, folding=folding,
                      release=release, fold_calls=fold_calls):
            fold_calls.append(len(works))
            folding.set()
            assert release.wait(timeout=30)
            return real_fold(works)

        svc._device_fold = slow_fold
        results = {}

        def run(name, svc=svc, results=results):
            results[name] = svc.catch_up(["cdoc0"], upload=False)

        leader = threading.Thread(target=run, args=("leader",))
        leader.start()
        assert folding.wait(timeout=30)  # the key is now in flight
        waiters = [threading.Thread(target=run, args=(f"w{i}",))
                   for i in range(4)]
        for t in waiters:
            t.start()
        while svc.cache.counters.get("waits") < len(waiters):
            time.sleep(0.001)
        release.set()
        for t in [leader] + waiters:
            t.join(timeout=60)
            assert not t.is_alive()
        assert fold_calls == [1], "the herd must cost exactly one fold"
        assert len({tuple(sorted(r.items())) for r in results.values()}) == 1
        outs[side] = (results["leader"], svc.cache.stats())
    assert outs["port"] == outs["ref"]
    assert outs["port"][1]["waits"] == 4
