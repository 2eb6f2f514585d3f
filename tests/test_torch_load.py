"""The port's load harness (``fluidframework_tpu_torch.testing.load``)
against the JAX package's: the puppet-client load runs of
tests/test_tools_and_load.py, test_nack.py and test_loader.py, the
sharded load runs of tests/test_sharding.py and test_broadcaster.py, the
chaos runs and their oracle twins of tests/test_faultline.py, the
``VirtualClock`` and ``percentile`` helpers, and the wire soak at 256
documents through the port's standalone server (``python -m
fluidframework_tpu_torch.service.server --device cpu``).

Each run takes the same spec on both packages (each package's own
``FaultPlan`` where a spec carries one) and the two results must be
equal field for field, tolerance 0; the reference test's own
assertions are kept on the port's result.  Every wait is bounded.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

import fluidframework_tpu.testing.faults as ref_faults
import fluidframework_tpu.testing.load as ref_load
import fluidframework_tpu_torch.testing.faults as port_faults
import fluidframework_tpu_torch.testing.load as port_load

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(run, spec_name, **kw):
    """``run`` (a harness function name) over the same spec in both
    packages; asserts the results equal and returns the port's."""
    want = getattr(ref_load, run)(getattr(ref_load, spec_name)(**kw))
    got = getattr(port_load, run)(getattr(port_load, spec_name)(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


# -- helpers -------------------------------------------------------------------


def test_virtual_clock_and_percentile_match():
    clocks = [mod.VirtualClock(tick=0.25) for mod in (ref_load, port_load)]
    for clock in clocks:
        clock()
        clock.sleep(1.5)
        clock.sleep(-3.0)  # never runs backwards
    assert [c() for c in clocks] == [2.0, 2.0]
    sample = sorted([5.0, 1.0, 9.0, 3.0, 7.0, 2.0])
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port_load.percentile(sample, q) \
            == ref_load.percentile(sample, q)
    assert port_load.percentile([], 0.5) == ref_load.percentile([], 0.5)


# -- puppet-client load --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_run_converges(seed):
    result = _both("run_load", "LoadSpec", seed=seed, clients=3, steps=120)
    assert result.edits > 0
    assert result.sequenced_ops > 0
    assert result.final_clients >= 1
    assert len(result.summary_digest) == 64


def test_load_run_with_heavy_faults_converges():
    result = _both("run_load", "LoadSpec", seed=7, clients=4, steps=200,
                   edit_weight=0.5, sync_weight=0.2, disconnect_weight=0.15,
                   stash_weight=0.1, late_join_weight=0.05)
    assert result.disconnects > 0
    assert result.rehydrates + result.late_joins > 0


def test_load_harness_converges_under_nack_fault_injection():
    result = _both("run_load", "LoadSpec", seed=11, clients=3, steps=120,
                   nack_every=7)
    assert result.nacks_issued > 0


@pytest.mark.parametrize("seed", [4, 11, 13, 39])
def test_load_heavy_faults_with_nacks_and_stashes_converges(seed):
    result = _both("run_load", "LoadSpec", seed=seed, clients=4, steps=250,
                   nack_every=7, disconnect_weight=0.12, stash_weight=0.08,
                   late_join_weight=0.04, edit_weight=0.55, sync_weight=0.21)
    assert len(result.summary_digest) == 64
    assert result.rehydrates > 0


# -- sharded load --------------------------------------------------------------


def test_sharded_vs_single_shard_oracle_no_kill():
    spec = dict(seed=7, docs=6, clients_per_doc=2, steps=100)
    sharded = _both("run_sharded_load", "ShardedLoadSpec", shards=4, **spec)
    single = _both("run_sharded_load", "ShardedLoadSpec", shards=1, **spec)
    assert sharded.per_doc_head == single.per_doc_head
    assert sharded.per_doc_digest == single.per_doc_digest
    assert sharded.killed_shard is None and not sharded.epoch_bumped
    assert len([s for s, n in sharded.shard_docs.items() if n > 0]) >= 2


def test_failover_byte_identical_to_never_killed_oracle():
    spec = dict(seed=3, docs=8, clients_per_doc=2, steps=120)
    killed = _both("run_sharded_load", "ShardedLoadSpec", shards=4,
                   kill_at=60, **spec)
    assert killed.killed_shard is not None
    assert killed.fenced_docs, "victim shard owned no documents"
    assert killed.epoch_bumped
    assert killed.reconnects >= len(killed.fenced_docs)
    oracle = _both("run_sharded_load", "ShardedLoadSpec", shards=1,
                   scripted_reconnect_at=60,
                   scripted_docs=tuple(killed.fenced_docs), **spec)
    assert killed.per_doc_head == oracle.per_doc_head
    assert killed.per_doc_digest == oracle.per_doc_digest


def test_failover_lazy_fence_reaction_converges():
    result = _both("run_sharded_load", "ShardedLoadSpec", seed=11, shards=4,
                   docs=6, clients_per_doc=2, steps=160, kill_at=40,
                   fence_reaction="lazy")
    assert result.killed_shard is not None
    assert result.epoch_bumped
    assert result.reconnects >= 1


def test_probe_latencies_are_deterministic():
    spec = dict(seed=5, shards=4, docs=4, clients_per_doc=2, steps=60,
                probe_sinks=2)
    a = _both("run_sharded_load", "ShardedLoadSpec", **spec)
    b = port_load.run_sharded_load(port_load.ShardedLoadSpec(**spec))
    assert a.broadcast_latencies == b.broadcast_latencies
    assert a.broadcast_encodes == b.broadcast_encodes > 0
    assert a.per_doc_digest == b.per_doc_digest


# -- chaos load ----------------------------------------------------------------


def test_chaos_spec_rejects_wire_only_and_dirless_file_plans(tmp_path):
    messages = []
    for load, faults in ((ref_load, ref_faults), (port_load, port_faults)):
        wire_plan = faults.FaultPlan(points=(
            faults.FaultPoint("session.write", "stall", at=1),))
        with pytest.raises(ValueError, match="TCP stack") as wire:
            load.run_chaos_load(load.ChaosLoadSpec(
                steps=8, plan=wire_plan, dir=str(tmp_path / "w")))
        flush_plan = faults.FaultPlan(points=(
            faults.FaultPoint("oplog.flush", "skip_fsync", at=1),))
        with pytest.raises(ValueError, match="durable tier") as flush:
            load.run_chaos_load(load.ChaosLoadSpec(steps=8, plan=flush_plan,
                                                   dir=None))
        messages.append((str(wire.value), str(flush.value)))
    assert messages[1] == messages[0]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_load_byte_identical_to_fault_free_oracle(seed, tmp_path):
    out = {}
    for tag, load in (("ref", ref_load), ("port", port_load)):
        spec = load.ChaosLoadSpec(seed=seed, shards=4, docs=6,
                                  clients_per_doc=2, steps=160,
                                  dir=str(tmp_path / tag / "chaos"))
        out[tag] = load.run_chaos_with_oracle(spec)
    chaos, oracle = out["port"]
    assert dataclasses.asdict(chaos) == dataclasses.asdict(out["ref"][0])
    assert dataclasses.asdict(oracle) == dataclasses.asdict(out["ref"][1])
    assert chaos.per_doc_digest == oracle.per_doc_digest
    assert chaos.per_doc_head == oracle.per_doc_head
    assert chaos.unfired == [], "plan points that never exercised"
    kinds = {k.split(":", 1)[0] for k in chaos.fault_counts}
    assert {"oplog.append", "storage.read", "shard.kill",
            "client.stall"} <= kinds
    assert len(chaos.fault_counts) >= 5
    assert chaos.kills and chaos.kills[0][2], "the kill fenced no docs"
    assert chaos.recovery_ticks, "no recovery latency was measured"


def test_chaos_replay_is_bit_identical(tmp_path):
    runs = []
    for i in range(2):
        spec = port_load.ChaosLoadSpec(seed=11, steps=160,
                                       dir=str(tmp_path / f"run{i}"))
        runs.append(port_load.run_chaos_load(spec))
    a, b = runs
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    ref = ref_load.run_chaos_load(ref_load.ChaosLoadSpec(
        seed=11, steps=160, dir=str(tmp_path / "ref")))
    assert dataclasses.asdict(a) == dataclasses.asdict(ref)


# -- the wire soak -------------------------------------------------------------


SOAK_DOCS = 256


def _server_port(srv, deadline_s=120.0):
    """The standalone server's port from its "listening" line, read on a
    thread so that the wait is bounded."""
    found = []

    def read():
        for line in srv.stdout:
            if "listening" in line:
                found.append(int(line.rsplit(":", 1)[-1].strip()))
                break

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout=deadline_s)
    assert found, "server did not report a port"
    # keep draining the merged output so that logging never blocks it
    threading.Thread(target=lambda: [None for _ in srv.stdout],
                     daemon=True).start()
    return found[0]


def _ref_seed_digests(lo, hi):
    """The JAX package's own soak seeder over documents [lo, hi) against
    an in-thread reference server: the digests the port's seeders must
    reproduce."""
    from fluidframework_tpu.service import LocalOrderingService
    from fluidframework_tpu.service.server import OrderingServer

    server = OrderingServer(LocalOrderingService(), port=0)
    thread = server.start_in_thread()
    try:
        return ref_load.wire_soak_worker("127.0.0.1", server.port, lo, hi,
                                         6, 42)
    finally:
        server.loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=10)


def test_wire_soak_through_catchup_rpc(tmp_path):
    """256 mixed-channel documents seeded by 4 worker subprocesses
    (``python -m fluidframework_tpu_torch.testing.load --wire-worker``)
    against the port's standalone server on the CPU, folded centrally by
    one ``catchup`` RPC: every document takes the device route, sampled
    fresh loads replay nothing and equal the seeders' digests, and those
    digests equal the JAX package's seeder's for the same documents."""
    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkDocumentServiceFactory)
    from fluidframework_tpu_torch.loader import Loader

    srv = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.server",
         "--dir", str(tmp_path / "store"), "--port", "0",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    try:
        port = _server_port(srv)
        t0 = time.time()
        expected = port_load.seed_wire_soak("127.0.0.1", port, SOAK_DOCS,
                                            timeout=300.0)
        seed_time = time.time() - t0
        assert len(expected) == SOAK_DOCS
        f = NetworkDocumentServiceFactory(host="127.0.0.1", port=port,
                                          timeout=300.0)
        try:
            t0 = time.time()
            res = f._rpc.request("catchup", {}, timeout=300.0)
            fold_time = time.time() - t0
            assert len(res["docs"]) == SOAK_DOCS
            assert res["deviceDocs"] >= 0.95 * SOAK_DOCS, (
                res["deviceDocs"], res["cpuDocs"])
            sample = sorted({min(i, SOAK_DOCS - 1)
                             for i in (0, 1, 2, 3, 4, SOAK_DOCS // 2,
                                       SOAK_DOCS - 1)})
            loader = Loader(f)
            for i in sample:
                doc = f"soak{i:05d}"
                c = loader.resolve(doc)
                assert c.catchup_ops == 0, (doc, c.catchup_ops)
                assert c.runtime.summarize().digest() == expected[doc], doc
                c.close()
            print(f"wire soak: {SOAK_DOCS} docs, seed {seed_time:.1f}s, "
                  f"catchup fold {fold_time:.1f}s, device "
                  f"{res['deviceDocs']} / cpu {res['cpuDocs']}")
        finally:
            f.close()
    finally:
        srv.terminate()
        srv.wait(timeout=15)
    want = _ref_seed_digests(0, 10)
    assert {d: expected[d] for d in want} == want
