"""The port's out-of-process tier against the JAX package's: twins of
tests/test_fluidproc.py (all but the two scenario-spec swarm tests, which
need ``testing/scenarios.py``).

1. Engine and logic tests on THREAD-backend clusters (same RPC, same
   per-shard on-disk logs; "kill" abandons the server without another
   stamp): each scenario runs on both packages (``torch_proc.run_both``)
   and the records — heads, per-doc wire logs, moved documents, stats
   after quiesce, typed errors — must be equal, and equal to the
   fault-free single-service oracle of both packages.
2. REAL-process tests (``ProcShard``, shard processes spawned with
   ``--device cpu``): kill -9 mid-traffic, SIGSTOP hang detection,
   SIGTERM drain-and-seal with a restart that resumes contiguously, and
   the per-shard ``stats`` RPC, held against both packages' oracles.

Every wait is bounded: drives carry a deadline, killers a deadline, the
SIGTERM goes out once the batch's commit is under way (its first records
in the shard's log file, polled with a deadline), not after a sleep.
"""

import json
import os
import signal
import threading

import pytest
import torch

from tests.torch_proc import (PORT, both_oracles, drive_tier, op, run_both,
                              tier_logs, wait_until)

DOCS = [f"doc-{i}" for i in range(10)]


# -- faultline sites ----------------------------------------------------------


def _fault_sites(pkg):
    faults = pkg.faults
    assert faults.SITES["proc.kill"] == ("kill",)
    assert faults.SITES["proc.hang"] == ("hang",)
    assert "proc.kill" in faults.SCHEDULED_SITES
    assert "proc.hang" in faults.SCHEDULED_SITES
    faults.FaultPoint("proc.kill", "kill", at=7, doc="d").validate()
    with pytest.raises(ValueError):
        faults.FaultPoint("proc.kill", "hang").validate()
    return {k: tuple(v) for k, v in faults.SITES.items()
            if k.startswith("proc.")}


def test_proc_fault_sites_registered_and_scheduled():
    run_both(_fault_sites)


def _fault_due(pkg):
    faults = pkg.faults
    plan = faults.FaultPlan(points=(
        faults.FaultPoint("proc.kill", "kill", at=5, shard="s1"),
        faults.FaultPoint("proc.hang", "hang", at=3, doc="d0"),
    ))
    injector = faults.FaultInjector(plan)
    record = [injector.due("proc.kill", 4)]
    hung = injector.due("proc.hang", 3)
    killed = injector.due("proc.kill", 9)
    record += [[p.site for p in hung], [p.shard for p in killed],
               injector.unfired()]
    # an unexecutable kill rolls its mark back for the coverage oracle
    injector.mark_unfired(killed[0])
    record += [[p.site for p in injector.unfired()], injector.snapshot()]
    assert record[1] == ["proc.hang"] and record[2] == ["s1"]
    assert record[4] == ["proc.kill"]
    assert record[5] == {"proc.hang:hang": 1, "proc.kill:kill": 0}
    return record


def test_proc_fault_points_fire_via_due_with_coverage_accounting():
    run_both(_fault_due)


# -- thread-backend cluster logic ---------------------------------------------


def _cluster(pkg, tmp, n_shards=4, **kw):
    return pkg.FrontDoor(str(tmp / pkg.name / "proc"), n_shards=n_shards,
                         spawn="thread", **kw).start()


def test_frontdoor_routes_proxies_and_reports_stats(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path)
        try:
            drive_tier(pkg, door, DOCS[:4], 5)
            heads = door.heads(DOCS[:4])
            assert all(h == 6 for h in heads.values()), heads
            client = pkg.RpcClient("127.0.0.1", door.port)
            try:
                stats = client.request("stats", {})
            finally:
                client.close()
            assert sorted(stats["shards"]) == door.router.shard_ids()
            assert stats["epoch"] == door.epoch
            return {"heads": heads,
                    "shards": sorted(stats["shards"]),
                    "ops": sum(s["ops"] for s in stats["shards"].values()
                               if "ops" in s),
                    "docs": sum(s["docs"]
                                for s in stats["shards"].values()),
                    "owners": {d: door._route_probe(d)[0]
                               for d in DOCS[:4]}}
        finally:
            door.close()

    got = run_both(scenario)
    assert got["ops"] == 24 and got["docs"] == 4


def test_failover_converges_byte_identical_to_oracle(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path)
        try:
            refs = drive_tier(pkg, door, DOCS, 4)
            victim = door._route_probe(DOCS[0])[0]
            old_epoch = door.epoch
            affected = door.fail_shard(victim)
            assert DOCS[0] in affected
            drive_tier(pkg, door, DOCS, 4, start=4, refs=refs)
            assert door.epoch != old_epoch
            for d in DOCS:
                assert door._forward_doc("log_contiguous", {"doc": d}), d
            for d in DOCS:
                assert door._route_probe(d)[0] != victim
            return {"victim": victim, "affected": sorted(affected),
                    "logs": tier_logs(door, DOCS)}
        finally:
            door.close()

    assert run_both(scenario)["logs"] == both_oracles(DOCS, 8)


def test_lazy_adoption_on_first_touch(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path)
        try:
            drive_tier(pkg, door, DOCS, 3)
            victim = door._route_probe(DOCS[0])[0]
            victims_docs = [d for d in DOCS
                            if door._route_probe(d)[0] == victim]
            door.fail_shard(victim)
            with door._route_lock:
                orphaned = dict(door._orphans)
            # no subscriptions here: nothing adopted eagerly
            assert sorted(orphaned) == sorted(victims_docs)
            assert all(src == victim for src in orphaned.values())
            head = door.heads([victims_docs[0]])[victims_docs[0]]
            assert head == 4  # JOIN + 3 ops, nothing lost
            with door._route_lock:
                assert victims_docs[0] not in door._orphans
            return {"orphaned": orphaned, "head": head}
        finally:
            door.close()

    run_both(scenario)


def test_wrong_shard_redirect_roundtrip(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path)
        try:
            drive_tier(pkg, door, DOCS[:2], 2)
            doc = DOCS[0]
            sid = door._route_probe(doc)[0]
            handle = door._shard(sid)
            handle.request("retire_doc", {"doc": doc})
            direct = pkg.RpcClient(handle.addr[0], handle.addr[1])
            try:
                with pytest.raises(pkg.DocRelocatedError):
                    direct.request("head", {"doc": doc})
            finally:
                direct.close()
            with door._route_lock:
                door._orphans[doc] = sid
            return door.heads([doc])[doc]
        finally:
            door.close()

    assert run_both(scenario) == 3


def test_live_migration_moves_docs_byte_identically(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path)
        try:
            refs = drive_tier(pkg, door, DOCS, 4)
            before = {d: door._route_probe(d)[0] for d in DOCS}
            result = door.add_shard("shard90")
            after = {d: door._route_probe(d)[0] for d in DOCS}
            movers = [d for d in DOCS if after[d] == "shard90"]
            assert sorted(result["moved"]) == sorted(movers)
            for d in DOCS:
                if d not in movers:
                    assert after[d] == before[d], d
            drive_tier(pkg, door, DOCS, 4, start=4, refs=refs)
            for d in DOCS:
                assert door._forward_doc("log_contiguous", {"doc": d}), d
            if movers:
                src = before[movers[0]]
                handle = door._shard(src)
                direct = pkg.RpcClient(handle.addr[0], handle.addr[1])
                try:
                    with pytest.raises(pkg.DocRelocatedError):
                        direct.request("submit", {
                            "doc": movers[0],
                            "op": pkg.encode_raw_operation(
                                op(pkg, f"w-{movers[0]}", 99, 0))})
                finally:
                    direct.close()
            return {"moved": sorted(result["moved"]),
                    "logs": tier_logs(door, DOCS)}
        finally:
            door.close()

    got = run_both(scenario)
    assert got["moved"]
    assert got["logs"] == both_oracles(DOCS, 8)


def _movers_for(pkg, door, docs, new_sid):
    future = door.router.alive() + [new_sid]
    return [d for d in docs
            if max(future, key=lambda s: (pkg.rendezvous_score(d, s), s))
            == new_sid]


@pytest.mark.parametrize("step,who", [
    ("freeze", "src"), ("transfer", "src"), ("import", "src"),
    ("flip", "src"), ("resume", "src"),
    ("import", "dst"), ("flip", "dst"), ("resume", "dst"),
])
def test_migration_crash_points_converge(tmp_path, step, who):
    """Kill a shard at EVERY migration step, source and target, on both
    packages: the same documents move (or the expansion aborts the same
    way), and the logs converge to the oracle's."""
    def scenario(pkg):
        door = _cluster(pkg, tmp_path / f"{step}-{who}")
        try:
            refs = drive_tier(pkg, door, DOCS, 3)
            new_sid = "shard91"
            movers = _movers_for(pkg, door, DOCS, new_sid)
            assert movers
            target_doc = movers[0]
            src_sid = door._route_probe(target_doc)[0]
            fired = []

            def hook(at_step, doc):
                if at_step == step and doc == target_doc and not fired:
                    fired.append((at_step, doc))
                    victim = src_sid if who == "src" else new_sid
                    door._shards[victim].kill()

            door.set_crash_hook(hook)
            outcome = None
            if who == "dst" and step == "import":
                with pytest.raises(pkg.MigrationAborted):
                    door.add_shard(new_sid)
                assert new_sid not in door.router.shard_ids()
                outcome = "aborted"
            elif who == "dst":
                try:
                    door.add_shard(new_sid)
                    outcome = "joined"
                except pkg.MigrationAborted:
                    outcome = "aborted"
            else:
                result = door.add_shard(new_sid)
                assert target_doc in result["moved"]
                assert door._route_probe(target_doc)[0] == new_sid
                outcome = sorted(result["moved"])
            door.set_crash_hook(None)
            assert fired, "crash hook never fired"
            drive_tier(pkg, door, DOCS, 3, start=3, refs=refs)
            for d in DOCS:
                assert door._forward_doc("log_contiguous", {"doc": d}), d
            return {"outcome": outcome, "logs": tier_logs(door, DOCS)}
        finally:
            door.close()

    assert run_both(scenario)["logs"] == both_oracles(DOCS, 6)


def test_refresh_doc_after_own_upload_still_ingests_peer_records(tmp_path):
    """The refresh scan memo advances only inside ``refresh_doc``: an
    instance's own upload must not mark peers' appended records seen."""
    from fluidframework_tpu.drivers.file_driver import (
        FileSummaryStorage as RefStorage)
    from fluidframework_tpu.protocol.summary import SummaryTree as RefTree
    from fluidframework_tpu_torch.drivers.file_driver import (
        FileSummaryStorage)
    from fluidframework_tpu_torch.protocol.summary import SummaryTree

    def scenario(storage_cls, tree_cls, root):
        a, b = storage_cls(root), storage_cls(root)
        ha = a.upload("doc-x", tree_cls().add_blob("b", b"peer"), 5)
        b.upload("doc-y", tree_cls().add_blob("b", b"own"), 3)
        b.refresh_doc("doc-x")
        assert b.head("doc-x") is not None
        assert b.read_commit(b.head("doc-x")).tree == ha
        tree, ref_seq = b.latest("doc-x")
        assert ref_seq == 5 and tree.digest() == ha
        return ha, ref_seq

    assert scenario(FileSummaryStorage, SummaryTree,
                    str(tmp_path / "port")) == scenario(
        RefStorage, RefTree, str(tmp_path / "ref"))


def test_last_live_shard_is_unfailable_before_the_kill(tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path, n_shards=2)
        try:
            refs = drive_tier(pkg, door, DOCS[:4], 2)
            first, second = door.router.alive()
            door.fail_shard(first)
            with pytest.raises(RuntimeError):
                door.fail_shard(second)
            assert door.router.alive() == [second]
            assert door._shard(second).alive()
            drive_tier(pkg, door, DOCS[:4], 2, start=2, refs=refs)
            return tier_logs(door, DOCS[:4])
        finally:
            door.close()

    assert run_both(scenario) == both_oracles(DOCS[:4], 4)


def test_adopting_nothing_durable_clears_the_orphan_without_looping(
        tmp_path):
    def scenario(pkg):
        door = _cluster(pkg, tmp_path, n_shards=3)
        client = pkg.RpcClient("127.0.0.1", door.port)
        try:
            client.request("create_document", {"doc": "empty-doc"})
            victim = door._route_probe("empty-doc")[0]
            full_doc = next(d for d in DOCS
                            if door._route_probe(d)[0] == victim)
            drive_tier(pkg, door, [full_doc], 3)
            door.fail_shard(victim)
            heads = door.heads(["empty-doc", full_doc])
            assert heads == {"empty-doc": 0, full_doc: 4}
            with door._route_lock:
                assert "empty-doc" not in door._orphans
                assert full_doc not in door._orphans
            has = client.request("has_document", {"doc": "empty-doc"})
            assert not has
            client.request("create_document", {"doc": "empty-doc"})
            return heads
        finally:
            client.close()
            door.close()

    run_both(scenario)


def test_tick_executes_proc_kill_and_hang_points(tmp_path):
    def scenario(pkg):
        faults = pkg.faults
        injector = faults.FaultInjector(faults.FaultPlan(points=(
            faults.FaultPoint("proc.kill", "kill", doc=DOCS[0], at=5),
            faults.FaultPoint("proc.hang", "hang", doc=DOCS[1], at=2),
        )))
        door = _cluster(pkg, tmp_path, faults=injector, hang_detect_ticks=2)
        try:
            drive_tier(pkg, door, DOCS[:4], 2)
            hang_victim = door._route_probe(DOCS[1])[0]
            assert door.tick(1) == []
            door.tick(2)  # the hang fires; not detected yet
            assert hang_victim not in door.router.dead()
            kill_victim = door._route_probe(DOCS[0])[0]
            affected = door.tick(5)
            assert kill_victim in door.router.dead()
            assert hang_victim in door.router.dead()
            assert affected
            assert injector.unfired() == []
            return {"dead": sorted(door.router.dead()),
                    "affected": sorted(affected),
                    "snapshot": injector.snapshot()}
        finally:
            door.close()

    got = run_both(scenario)
    assert got["snapshot"] == {"proc.hang:hang": 1, "proc.kill:kill": 1}


# -- REAL processes (the port's shards fold on --device cpu here) ---------------


def test_sigkill_mid_traffic_converges_byte_identical(tmp_path):
    """kill -9 a real shard process mid-traffic: the tier converges
    byte-identical (per-doc wire logs, contiguous seqs) to the fault-free
    single-service oracle of both packages."""
    pkg = PORT
    door = pkg.FrontDoor(str(tmp_path / "proc"), n_shards=4, spawn="proc",
                         request_timeout=5.0).start()
    try:
        docs = [f"doc-{i}" for i in range(6)]
        refs = drive_tier(pkg, door, docs, 4)
        victim_sid = door._route_probe(docs[0])[0]
        victim = door._shard(victim_sid)
        progress = [0]
        errors = []

        def assassinate():
            try:
                assert wait_until(lambda: progress[0] >= 10, timeout=60)
                victim.proc.kill()
            except BaseException as exc:  # reported below
                errors.append(exc)

        killer = threading.Thread(target=assassinate, daemon=True)
        killer.start()
        drive_tier(pkg, door, docs, 16, start=4, refs=refs,
                   progress=progress)
        killer.join(timeout=60)
        assert not killer.is_alive() and not errors
        assert wait_until(lambda: victim.proc.poll() is not None)
        assert victim_sid in door.router.dead(), \
            "transport-error path never detected the kill"
        for d in docs:
            assert door._forward_doc("log_contiguous", {"doc": d}), d
        assert tier_logs(door, docs) == both_oracles(docs, 20)
        stats = door.stats()
        assert stats["fences"] == 1
        assert victim_sid not in stats["alive"]
    finally:
        door.close()


def test_sigstop_hang_is_detected_and_shot(tmp_path):
    pkg = PORT
    door = pkg.FrontDoor(str(tmp_path / "proc"), n_shards=3, spawn="proc",
                         request_timeout=4.0).start()
    try:
        docs = [f"doc-{i}" for i in range(4)]
        refs = drive_tier(pkg, door, docs, 3)
        victim_sid = door._route_probe(docs[0])[0]
        victim = door._shard(victim_sid)
        victim.hang()  # SIGSTOP: alive but silent
        assert victim.proc.poll() is None
        assert door.poll_shards() == [victim_sid]
        # shot before its documents were re-owned
        assert wait_until(lambda: victim.proc.poll() is not None)
        drive_tier(pkg, door, docs, 3, start=3, refs=refs)
        assert tier_logs(door, docs) == both_oracles(docs, 6)
    finally:
        door.close()


def test_sigterm_drains_seals_and_restart_resumes(tmp_path):
    """SIGTERM once a 2,000-op group commit is under way (its first
    records reached the shard's log file; bounded, not a sleep): the
    in-flight batch drains whole, the sealed log holds no duplicate and
    strictly contiguous seqs, and a restart over the same directory
    resumes the sequence where the seal left it."""
    pkg = PORT
    base = str(tmp_path / "proc")
    handle = pkg.ProcShard("s0", base)
    handle.connect()
    doc = "drain-doc"
    try:
        handle.request("create_document", {"doc": doc})
        handle.request("connect", {"doc": doc, "client": "w"})
        head = handle.request("head", {"doc": doc})
        ops = [pkg.encode_raw_operation(op(pkg, "w", i, head))
               for i in range(2000)]
        log_path = pkg.shard_log_path(base, "s0")
        joined = os.path.getsize(log_path)  # the JOIN, fsynced
        outcome = {}

        def big_batch():
            try:
                outcome["result"] = handle.request(
                    "submit_mixed", {"batches": {doc: ops}})
            except (ConnectionError, OSError, pkg.NackError) as exc:
                outcome["error"] = exc

        writer = threading.Thread(target=big_batch, daemon=True)
        writer.start()
        assert wait_until(lambda: os.path.getsize(log_path) > joined,
                          timeout=30, step=0.001), \
            "the batch's commit never started"
        handle.proc.send_signal(signal.SIGTERM)  # mid-group-commit
        handle.proc.wait(timeout=30)
        writer.join(timeout=30)
        assert not writer.is_alive()
    finally:
        handle.close()
        if handle.proc.poll() is None:
            handle.kill()
    assert any("sealed" in line for line in handle.log_tail), \
        handle.log_tail[-5:]
    seqs = []
    with open(log_path, "r", encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["doc"] == doc:
                seqs.append(rec["msg"]["sequenceNumber"])
    assert len(seqs) == len(set(seqs)), "duplicate lines in sealed log"
    assert seqs == list(range(1, len(seqs) + 1)), "seqs not contiguous"
    sealed_head = len(seqs)
    # the JOIN, then the whole batch: the drain never tears a commit
    assert sealed_head == 2001, sealed_head
    handle2 = pkg.ProcShard("s0", base)
    handle2.connect()
    try:
        assert handle2.request("heads", {"docs": [doc]})[doc] == sealed_head
        result = handle2.request("submit", {
            "doc": doc,
            "op": pkg.encode_raw_operation(op(pkg, "w", 5000, sealed_head))})
        assert result["sequenceNumber"] == sealed_head + 1
        assert handle2.request("log_contiguous", {"doc": doc})
    finally:
        handle2.close()
        handle2.terminate()


def test_draining_server_refuses_with_typed_nack(tmp_path):
    def scenario(pkg):
        host = pkg.ShardHost("s0", str(tmp_path / pkg.name / "proc"))
        server = pkg.ShardHostServer(host, port=0)
        thread = server.start_in_thread()
        rpc = pkg.RpcClient("127.0.0.1", server.port)
        try:
            rpc.request("create_document", {"doc": "d"})
            server.draining = True
            assert rpc.request("ping", {}) == "pong"
            assert "shard" in rpc.request("stats", {})
            with pytest.raises(pkg.NackError) as err:
                rpc.request("submit", {
                    "doc": "d",
                    "op": pkg.encode_raw_operation(op(pkg, "w", 0, 0))})
            assert err.value.retry_after > 0
            return err.value.code
        finally:
            rpc.close()
            host.seal()
            server.loop.call_soon_threadsafe(server._server.close)
            thread.join(timeout=10)

    assert run_both(scenario) == "shuttingDown"


def test_per_shard_stats_rpc_over_the_wire(tmp_path):
    pkg = PORT
    door = pkg.FrontDoor(str(tmp_path / "proc"), n_shards=2,
                         spawn="proc").start()
    try:
        drive_tier(pkg, door, ["a-doc", "b-doc"], 3)
        client = pkg.RpcClient("127.0.0.1", door.port)
        try:
            stats = client.request("stats", {})
        finally:
            client.close()
        shard_stats = stats["shards"]
        assert set(shard_stats) == set(door.router.shard_ids())
        pids = {s["pid"] for s in shard_stats.values()}
        assert len(pids) == 2 and os.getpid() not in pids, \
            "stats must come from the shard PROCESSES"
        heads = {}
        for s in shard_stats.values():
            heads.update(s["heads"])
        assert heads == {"a-doc": 4, "b-doc": 4}
    finally:
        door.close()


def test_shard_processes_run_the_port_on_the_named_device(tmp_path):
    """A ``ProcShard`` runs ``python -m
    fluidframework_tpu_torch.service.shardhost --device <device>``; the
    front door checks its device once, when built."""
    pkg = PORT
    door = pkg.FrontDoor(str(tmp_path / "proc"), n_shards=1,
                         spawn="proc").start()
    try:
        proc = door._shard(door.router.alive()[0]).proc
        with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
            argv = f.read().split(b"\0")
        assert b"fluidframework_tpu_torch.service.shardhost" in argv
        assert argv[argv.index(b"--device") + 1] == b"cpu"
    finally:
        door.close()
    if not torch.cuda.is_available():
        from fluidframework_tpu_torch.service.frontdoor import FrontDoor

        with pytest.raises(RuntimeError, match="no CUDA device"):
            FrontDoor(str(tmp_path / "cuda"), n_shards=1, spawn="proc")
        assert not (tmp_path / "cuda").exists()


def test_heartbeat_spares_a_shard_busy_with_a_long_catchup(tmp_path):
    """A shard serves one connection's requests in order, so a heartbeat
    ping on the data connection would wait behind a long ``catchup`` and
    fence a shard that is only busy.  The port pings over a connection of
    its own: a fold held 2.5 s (past the 2 s ping timeout) by the
    ``catchup.slow`` fault completes, and no shard is failed over."""
    pkg = PORT
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"seed": 0, "points": [
        {"site": "catchup.slow", "kind": "delay", "at": 1, "count": 2,
         "arg": 2.5}]}))
    door = pkg.FrontDoor(str(tmp_path / "proc"), n_shards=2, spawn="proc",
                         heartbeat_interval=0.2, request_timeout=30.0,
                         shard_fault_plan_path=str(plan)).start()
    rpc = pkg.RpcClient("127.0.0.1", door.port, timeout=60.0)
    try:
        from fluidframework_tpu_torch.testing import service_workload as sw

        ids = sw.write_catchup_corpus(rpc, 4, 16)
        out = rpc.request("catchup", {"docs": ids}, timeout=60.0)
        assert out["deviceDocs"] == 4 and out["cpuDocs"] == 0
        assert door.counters.get("fd.heartbeat_failures") == 0
        assert door.router.dead() == []
        assert all(door._shard(s).alive() for s in door.router.alive())
    finally:
        rpc.close()
        door.close()
