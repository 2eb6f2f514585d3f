"""The port's sharded ordering tier against the JAX package's: the
in-proc scenarios of tests/test_sharding.py on both packages
(tests/torch_server.py) — rendezvous routing, the sharded service
surface, epoch-fenced failover by ``kill_shard`` with equal heads and
summaries (against a never-killed single service, and across the two
packages), single-flight recovery, and the server's fence listener.
The reference's load-harness oracle runs (``testing/load``) are not
ported; the failover scenario here scripts its own traffic.

Fence tokens derive from the storage epoch, which is random per store,
so records hold what they are relative to (``epoch == token``), never
the tokens themselves.
"""

import threading
import time

import pytest
import torch

from tests.torch_server import PORT, REF, run_both, seed_tree

torch.set_num_threads(1)


def _op(pkg, client, client_seq, ref_seq=0, contents=None):
    return pkg.RawOperation(client_id=client, client_seq=client_seq,
                            ref_seq=ref_seq, type=pkg.MessageType.OP,
                            contents=contents or {})


def _insert(pkg, client, client_seq, ref_seq, text):
    return _op(pkg, client, client_seq, ref_seq, {
        "type": "groupedBatch", "ops": [
            {"ds": "ds", "channel": "text", "clientSeq": client_seq,
             "contents": {"kind": "insert", "pos": 0, "text": text}}]})


# --- router -----------------------------------------------------------------


def _router(pkg):
    ids = [f"s{i}" for i in range(4)]
    a, b = pkg.ShardRouter(ids), pkg.ShardRouter(list(reversed(ids)))
    docs = [f"doc{i}" for i in range(400)]
    owners = [a.owner(d) for d in docs]
    assert owners == [b.owner(d) for d in docs]  # order-independent
    after = pkg.ShardRouter(ids + ["s4"])
    moved = [d for d in docs if a.owner(d) != after.owner(d)]
    assert all(after.owner(d) == "s4" for d in moved)
    killed = pkg.ShardRouter(ids)
    assert killed.mark_dead("s2")
    rerouted = [killed.owner(d) for d in docs]
    assert all(o != "s2" for o in rerouted)
    assert all(r == o for r, o in zip(rerouted, owners) if o != "s2")
    again = killed.mark_dead("s2")
    last = pkg.ShardRouter(["a", "b"])
    last.mark_dead("a")
    with pytest.raises(RuntimeError):
        last.mark_dead("b")
    with pytest.raises(ValueError):
        pkg.ShardRouter(["x", "x"])
    return {"owners": owners, "moved": moved, "rerouted": rerouted,
            "again": again, "alive": killed.alive(), "dead": killed.dead(),
            "version": killed.version}


def test_router_routes_moves_and_kills_alike():
    got = run_both(_router)
    counts = {s: got["owners"].count(s) for s in set(got["owners"])}
    assert len(counts) == 4 and min(counts.values()) > 400 // 4 // 3
    assert 80 <= len(got["moved"]) <= 130
    assert got["again"] is False and got["dead"] == ["s2"]


# --- the sharded service surface --------------------------------------------


def _routes_and_lists(pkg):
    svc = pkg.ShardedOrderingService(n_shards=4)
    docs = [f"d{i}" for i in range(10)]
    for d in docs:
        svc.create_document(d)
        ep = svc.endpoint(d)
        ep.connect("c")
        ep.submit(_op(pkg, "c", 1, ref_seq=ep.head_seq))
    assert svc.doc_ids() == sorted(docs)
    assert all(svc.has_document(d) for d in docs)
    assert not svc.has_document("nope")
    for d in docs:
        shard = svc.shard_service(svc.shard_of(d))
        with shard.state_lock:
            assert d in shard._orderers
    return {"owners": {d: svc.shard_of(d) for d in docs},
            "load": svc.shard_load(),
            "assignment": svc.shard_assignment(docs).tolist(),
            "heads": {d: svc.oplog.head(d) for d in docs}}


def test_sharded_service_routes_and_lists():
    got = run_both(_routes_and_lists)
    assert sum(n for n, _ in got["load"].values()) == 10


def _fenced_endpoint(pkg):
    svc = pkg.ShardedOrderingService(n_shards=4)
    svc.create_document("d")
    ep = svc.endpoint("d")
    ep.connect("c")
    ep.submit(_op(pkg, "c", 1, ref_seq=ep.head_seq))
    stale = svc.endpoint("d")
    head_before = svc.oplog.head("d")
    victim = svc.shard_of("d")
    token = svc.fence_token(victim)
    affected = svc.kill_shard(victim)
    assert svc.storage.epoch == token  # derived, replayable fence
    with pytest.raises(pkg.ShardFencedError):
        stale.submit(_op(pkg, "c", 2))
    with pytest.raises(pkg.ShardFencedError):
        stale.head_seq
    with pytest.raises(pkg.ShardFencedError):
        stale.connect("c2")
    stale.disconnect("c")          # teardown of a dead shard: no-op
    stale.update_ref_seq("c", 1)   # heartbeat to a dead shard: no-op
    stale.submit_signal("c", {"x": 1})  # ephemeral: dropped
    assert svc.oplog.head("d") == head_before
    fresh = svc.endpoint("d")
    msg = fresh.submit(_op(pkg, "c", 2, ref_seq=fresh.head_seq))
    return {"victim": victim, "affected": affected,
            "again": svc.kill_shard(victim), "fences": svc.fences,
            "seq": msg.seq, "owner": svc.shard_of("d")}


def test_fenced_endpoint_cannot_sequence_and_kill_is_idempotent():
    got = run_both(_fenced_endpoint)
    assert got["affected"] == ["d"] and got["again"] == []
    assert got["fences"] == 1 and got["seq"] == 3


def _summary_only(pkg):
    svc = pkg.ShardedOrderingService(n_shards=4)
    svc.create_document("quiet")
    svc.storage.upload("quiet", seed_tree(pkg), 0)
    svc.kill_shard(svc.shard_of("quiet"))
    assert svc.has_document("quiet")
    ep = svc.endpoint("quiet")  # re-owned from storage, empty orderer
    ep.connect("c")
    return {"seq": ep.submit(_op(pkg, "c", 1, ref_seq=ep.head_seq)).seq,
            "owner": svc.shard_of("quiet")}


def test_summary_only_document_survives_failover():
    assert run_both(_summary_only)["seq"] >= 1


def _checkpoint_restore(pkg):
    svc = pkg.ShardedOrderingService(n_shards=4)
    for i in range(5):
        doc = f"d{i}"
        svc.create_document(doc)
        ep = svc.endpoint(doc)
        ep.connect("c")
        for j in range(3):
            ep.submit(_op(pkg, "c", j + 1, ref_seq=ep.head_seq))
    ckpt = svc.checkpoint()
    restored = pkg.ShardedOrderingService.restore(
        svc.oplog, svc.storage, ckpt, shard_ids=svc.router.shard_ids())
    seqs = {}
    for i in range(5):
        doc = f"d{i}"
        assert restored.endpoint(doc).head_seq == svc.endpoint(doc).head_seq
        assert restored.shard_of(doc) == svc.shard_of(doc)
        seqs[doc] = restored.endpoint(doc).submit(_op(
            pkg, "c", 4, ref_seq=restored.endpoint(doc).head_seq)).seq
        assert seqs[doc] == svc.oplog.head(doc)
    return {"seqs": seqs, "owners": {d: restored.shard_of(d) for d in seqs}}


def test_sharded_checkpoint_restore_roundtrip():
    run_both(_checkpoint_restore)


def _epoch_persists(pkg, tmp_path):
    storage = pkg.FileSummaryStorage(str(tmp_path / pkg.name / "store"))
    svc = pkg.ShardedOrderingService(n_shards=2, storage=storage)
    svc.create_document("d")
    ep = svc.endpoint("d")
    ep.connect("c")
    ep.submit(_op(pkg, "c", 1, ref_seq=ep.head_seq))
    svc.kill_shard(svc.shard_of("d"))
    reopened = pkg.FileSummaryStorage(str(tmp_path / pkg.name / "store"))
    return {"persisted": reopened.epoch == storage.epoch,
            "owner": svc.shard_of("d")}


def test_epoch_bump_persists_in_file_storage(tmp_path):
    assert run_both(_epoch_persists, tmp_path)["persisted"]


# --- failover with traffic: equal heads and summaries -----------------------


def _traffic(pkg, svc, rejoin):
    """Six documents, one writer each, eight inserts; at step four
    ``rejoin(svc, docs)`` names the documents whose writers rejoin as a
    new client.  Returns those documents and each document's catch-up
    ``(digest, head)``, after checking its seqs are contiguous."""
    docs = [f"fd{i}" for i in range(6)]
    tree = seed_tree(pkg)
    client = {}
    for d in docs:
        svc.storage.upload(d, tree, 0)
        svc.create_document(d)
        svc.endpoint(d).connect("w")
        client[d] = ["w", 0]
    rejoined = []
    for step in range(8):
        if step == 4:
            rejoined = rejoin(svc, docs)
            for d in rejoined:
                svc.endpoint(d).connect("w2")
                client[d] = ["w2", 0]
        for d in docs:
            name, cseq = client[d]
            client[d][1] = cseq + 1
            svc.endpoint(d).submit(_insert(pkg, name, cseq + 1,
                                           svc.oplog.head(d),
                                           "ab"[step % 2]))
    for d in docs:
        seqs = [m.seq for m in svc.oplog.get(d)]
        assert seqs == list(range(1, len(seqs) + 1))
    return {"rejoined": sorted(rejoined),
            "results": pkg.CatchupService(svc).catch_up(docs, upload=False)}


def _failover(pkg):
    """The shard owning the first document dies mid-traffic; its
    documents' writers rejoin on the recovered owner."""
    return _traffic(pkg, pkg.ShardedOrderingService(n_shards=4),
                    lambda svc, docs: svc.kill_shard(svc.shard_of(docs[0])))


def test_failover_matches_never_killed_service():
    """Across packages: equal heads and digests after a kill.  Per
    package: equal to a never-killed single service whose writers
    rejoin the same documents at the same step (a rejoin stamps the same
    JOIN whether it crosses a fence or not)."""
    killed = run_both(_failover)
    assert killed["rejoined"]
    for pkg in (REF, PORT):
        oracle = _traffic(pkg, pkg.LocalOrderingService(),
                          lambda svc, docs: killed["rejoined"])
        assert oracle == killed


# --- single-flight recovery -------------------------------------------------


def _recovery_herd(pkg, monkeypatch):
    svc = pkg.LocalOrderingService()
    svc.create_document("doc")
    ep = svc.endpoint("doc")
    ep.connect("c")
    for i in range(10):
        ep.submit(_op(pkg, "c", i + 1, ref_seq=ep.head_seq))
    fresh = pkg.LocalOrderingService(oplog=svc.oplog, storage=svc.storage)
    calls = []
    real_recover = pkg.DocumentOrderer.recover

    def slow_recover(doc_id, oplog, storage):
        calls.append(doc_id)
        time.sleep(0.15)  # widen the herd window
        return real_recover(doc_id, oplog, storage)

    monkeypatch.setattr(pkg.DocumentOrderer, "recover",
                        staticmethod(slow_recover))
    endpoints, errors = [], []

    def connect():
        try:
            endpoints.append(fresh.endpoint("doc"))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=connect, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    monkeypatch.undo()
    assert errors == []
    with fresh.state_lock:
        assert fresh._recoveries == {}  # no flight survives
    return {"calls": calls, "endpoints": len(endpoints),
            "heads": sorted({e.head_seq for e in endpoints})}


def test_recovery_is_single_flight_under_a_connect_herd(monkeypatch):
    got = run_both(_recovery_herd, monkeypatch)
    assert got == {"calls": ["doc"], "endpoints": 8, "heads": [11]}


def _fence_listener(pkg, monkeypatch):
    svc = pkg.ShardedOrderingService(n_shards=2, shard_ids=["sa", "sb"])
    srv = pkg.OrderingServer(svc, port=0)
    docs_on = {"sa": [], "sb": []}
    for i in range(12):
        doc = f"d{i}"
        svc.create_document(doc)
        ep = svc.endpoint(doc)
        ep.connect("c")
        ep.submit(_op(pkg, "c", 1, ref_seq=ep.head_seq))
        docs_on[svc.shard_of(doc)].append(doc)
    victim = "sa" if len(docs_on["sa"]) >= 2 else "sb"
    hot, *idle = docs_on[victim]

    class Sink:
        fenced = None

        def write_frame(self, data):
            return True

        def write_signal(self, data, signal):
            return True

        def on_demoted(self, doc_id, head):
            pass

        def on_fence(self, doc_id, epoch, head):
            self.fenced = (doc_id, epoch == svc.storage.epoch, head)

    sink = Sink()
    srv.broadcaster.attach(hot, svc.endpoint(hot), sink)
    recovers = []
    real_recover = pkg.DocumentOrderer.recover
    monkeypatch.setattr(
        pkg.DocumentOrderer, "recover",
        staticmethod(lambda d, o, s: (recovers.append(d),
                                      real_recover(d, o, s))[1]))
    svc.kill_shard(victim)
    eager = list(recovers)
    idle_head = svc.endpoint(idle[0]).head_seq
    monkeypatch.undo()
    return {"eager": eager, "hot": hot, "fenced": sink.fenced,
            "lazy": sorted(recovers), "idle_head": idle_head}


def test_server_fence_recovers_only_subscribed_docs(monkeypatch):
    got = run_both(_fence_listener, monkeypatch)
    assert got["eager"] == [got["hot"]]
    assert got["fenced"][:2] == (got["hot"], True)


# --- the streaming fold over a sharded service ------------------------------


def _stream_over_shards(pkg):
    """The streaming fold's truncation cut reads the OWNING shard's MSN
    and checkpoint; the server's catchup answers over the shards."""
    svc = pkg.ShardedOrderingService(n_shards=3)
    docs = [f"sd{i}" for i in range(5)]
    tree = seed_tree(pkg)
    for d in docs:
        svc.storage.upload(d, tree, 0)
        svc.create_document(d)
    srv = pkg.OrderingServer(svc)
    sf = srv.enable_streaming(cadence_ops=4, retention_floor=2)
    for d in docs:
        ep = svc.endpoint(d)
        ep.connect("w")
        for i in range(9):
            ep.submit(_insert(pkg, "w", i + 1, svc.oplog.head(d), "z"))
    polled = sf.poll(force=True)
    out = srv._dispatch(type("S", (), {"tenant": None})(), "catchup",
                        {"docs": docs})
    return {"polled": polled, "answer": out, "stats": sf.stats(),
            "floors": {d: svc.oplog.floor(d) for d in docs}}


def test_streaming_fold_over_sharded_service():
    got = run_both(_stream_over_shards)
    assert got["answer"]["lane"] in ("stream", "warm")
    assert all(f > 0 for f in got["floors"].values())
