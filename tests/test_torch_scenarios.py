"""The port's scenario engine (``fluidframework_tpu_torch.testing.scenarios``)
against the JAX package's: every non-slow swarm test of
tests/test_scenarios.py, the two scenario-spec validations of
tests/test_streamfold.py, the storm smoke and the front-door stats roll-up
of tests/test_catchup_storm.py, the process-tier swarm smoke of
tests/test_fluidproc.py and the two replica-death drills of
tests/test_frontdoor_async.py.  Each runs the same spec (same seed, same
sizes, each package's own ``FaultPlan``) on both packages, the port's
with ``device="cpu"`` and its process tier on thread shards, keeps the
reference test's own assertions on the port's result, and holds the two
results equal with tolerance 0: the whole replay-identity surface
(``SwarmResult.identity()``: heads, sampled digests, every counter and
fault observation), the storm report and the fold-probe counters.

Excluded from a comparison, and why:

- ``storm["tiers"]`` / ``storm["phase_tiers"]``: the ``bytes`` of the
  ``device_cache`` and ``pack_cache`` entries.  The reference's storm
  server builds its catch-up service with ``mesh="auto"``, which under
  tests/conftest.py's eight virtual CPU devices holds each fold's buffers
  padded to the mesh; the port's ``"auto"`` is one device on the CPU.
  With one JAX device the reference's bytes are the port's.  Every other
  tier counter is compared.
- ``ingress``: wall seconds (its op and byte counts are compared).
- ``shard_stats``: pids, storage epochs (fresh uuids) and live-tap frame
  counts, which are asynchronous by design (the reference's own replay
  checks exclude it too); the port's shard stats also carry ``launches``.
"""

import copy
import dataclasses
import os
import time

import pytest
import torch

import fluidframework_tpu.testing.faults as ref_faults
import fluidframework_tpu.testing.scenarios as ref_scn
import fluidframework_tpu_torch.testing.faults as port_faults
import fluidframework_tpu_torch.testing.scenarios as port_scn

torch.set_num_threads(1)

#: (scenario module, fault module, run_swarm keywords) of each package
PKGS = {"ref": (ref_scn, ref_faults, {}),
        "port": (port_scn, port_faults, {"device": "cpu"})}
#: the reference's wall budget per 10³-client smoke
SMOKE_BUDGET_SEC = 60.0


def _spec(tag, name, tweak=None, **size):
    scn, faults, _kw = PKGS[tag]
    spec = scn.build_scenario(name, **size)
    return tweak(spec, faults) if tweak is not None else spec


def _run(tag, spec):
    scn, _faults, kw = PKGS[tag]
    return scn.run_swarm(spec, **kw)


def _twin(tag, spec, result):
    scn, _faults, kw = PKGS[tag]
    return scn.run_swarm(scn.oracle_spec(spec, result), **kw)


def _both(name, tweak=None, **size):
    """The same spec run on each package: ``(ref, port, port_spec)``."""
    ref = _run("ref", _spec("ref", name, tweak, **size))
    spec = _spec("port", name, tweak, **size)
    return ref, _run("port", spec), spec


def _storm_view(storm):
    """The storm report without the mesh-padded buffer bytes (see the
    module docstring)."""
    out = copy.deepcopy(storm)
    for snap in [out.get("tiers")] + list(
            (out.get("phase_tiers") or {}).values()):
        for tier in ("device_cache", "pack_cache"):
            if snap and snap.get(tier):
                snap[tier].pop("bytes", None)
    return out


def _ingress_counts(result):
    return {k: v for k, v in result.ingress.items()
            if not k.endswith(("_sec", "_per_op"))}


def _assert_equal(ref, port):
    assert port.identity() == ref.identity()
    assert _storm_view(port.storm) == _storm_view(ref.storm)
    assert port.fold_tier == ref.fold_tier
    assert _ingress_counts(port) == _ingress_counts(ref)


# -- the swarm: smokes, replay identity, oracle --------------------------------


@pytest.mark.parametrize("name", sorted(port_scn.SCENARIOS))
def test_scenario_smoke_1k_clients_under_budget(name):
    assert sorted(port_scn.SCENARIOS) == sorted(ref_scn.SCENARIOS)
    ref = _run("ref", _spec("ref", name, seed=2, clients=1000, docs=8,
                            shards=4))
    t0 = time.monotonic()
    result = _run("port", _spec("port", name, seed=2, clients=1000, docs=8,
                                shards=4))
    assert time.monotonic() - t0 < SMOKE_BUDGET_SEC
    assert result.joins == 1000
    assert result.ops_stamped > 0
    assert result.delivery_samples == result.sequenced_ops
    assert result.sampled_digests
    _assert_equal(ref, result)


@pytest.mark.parametrize("name", sorted(port_scn.SCENARIOS))
def test_scenario_replay_is_bit_identical(name):
    size = dict(seed=6, clients=600, docs=6, shards=4)
    spec = _spec("port", name, **size)
    a, b = _run("port", spec), _run("port", spec)
    assert a.identity() == b.identity()
    _assert_equal(_run("ref", _spec("ref", name, **size)), a)


def test_failover_drill_converges_to_oracle_twin():
    ref, result, spec = _both("failover-drill", seed=5, clients=800, docs=8,
                              shards=4)
    oracle = _twin("port", spec, result)
    assert result.kills, "the scheduled shard kill must execute"
    assert result.fault_counts.get("shard.kill:kill") == 1
    assert oracle.kills == () and oracle.fault_counts == {}
    assert result.sampled_digests == oracle.sampled_digests
    assert result.per_doc_head == oracle.per_doc_head
    _assert_equal(ref, result)
    _assert_equal(_twin("ref", _spec("ref", "failover-drill", seed=5,
                                     clients=800, docs=8, shards=4), ref),
                  oracle)


def _append_faults(spec, faults):
    plan = faults.FaultPlan(seed=9, points=spec.plan.points + (
        faults.FaultPoint("oplog.append", "fail", doc="sw-0002", at=5,
                          count=2),
        faults.FaultPoint("oplog.append", "fail", at=200, count=1),
    ))
    return dataclasses.replace(spec, plan=plan)


def test_injected_append_faults_defer_and_still_match_oracle():
    size = dict(seed=9, clients=600, docs=6, shards=4)
    ref, result, spec = _both("failover-drill", _append_faults, **size)
    oracle = _twin("port", spec, result)
    assert result.defers or result.join_defers, \
        "the injected faults must actually defer a batch"
    assert result.fault_counts.get("oplog.append:fail", 0) >= 2
    assert oracle.defers == result.defers
    assert oracle.join_defers == result.join_defers
    assert result.sampled_digests == oracle.sampled_digests
    assert result.per_doc_head == oracle.per_doc_head
    _assert_equal(ref, result)
    ref_spec = _spec("ref", "failover-drill", _append_faults, **size)
    _assert_equal(_twin("ref", ref_spec, ref), oracle)


@pytest.mark.parametrize("name", ["catchup-herd", "laggard-window"])
def test_herd_and_laggards_produce_catchup_samples(name):
    def rate(spec, _faults):
        return dataclasses.replace(spec, catchup_rate=16)

    ref, result, _spec_ = _both(name, rate, seed=7, clients=600, docs=6,
                                shards=4)
    assert result.catchup_samples > 0, name
    assert result.max_pending_depth > 0, name
    phase_keys = [k for k in result.phase_counters
                  if k.endswith(("herd", "laggards"))]
    assert phase_keys, result.phase_counters.keys()
    _assert_equal(ref, result)


def test_durable_swarm_group_commits(tmp_path, monkeypatch):
    """File-backed runs: group commit keeps the fsync count at O(ticks)
    on the port, and both packages pay the same count."""
    flushes = {"n": 0}
    real_fsync = os.fsync

    def counting_fsync(fd):
        flushes["n"] += 1
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)
    out = {}
    for tag in ("ref", "port"):
        flushes["n"] = 0
        spec = dataclasses.replace(
            _spec(tag, "steady-typing", seed=3, clients=400, docs=4,
                  shards=4), dir=str(tmp_path / tag))
        out[tag] = (_run(tag, spec), flushes["n"])
    (ref, ref_flushes), (result, port_flushes) = out["ref"], out["port"]
    assert result.sequenced_ops > 800
    assert port_flushes < result.sequenced_ops / 2, (
        port_flushes, result.sequenced_ops)
    assert port_flushes == ref_flushes
    _assert_equal(ref, result)


def test_columnar_smoke_10k_clients_under_budget():
    size = dict(seed=11, clients=10_000, docs=16, shards=4)
    ref = _run("ref", _spec("ref", "steady-typing", **size))
    t0 = time.monotonic()
    result = _run("port", _spec("port", "steady-typing", **size))
    assert time.monotonic() - t0 < SMOKE_BUDGET_SEC
    assert result.joins == 10_000
    assert result.ops_stamped > 10_000
    assert result.ingress["columnar_ops"] > 0
    assert result.ingress["encode_bytes"] > 0
    assert "ingress" not in result.identity()
    _assert_equal(ref, result)


def test_fold_probe_reports_resident_tier_counters():
    """The fold probe's ``CatchupService`` takes ``mesh=None`` in both
    packages, so its counters (h2d / d2h bytes included) are equal."""
    def probe(spec, _faults):
        return dataclasses.replace(spec, fold_probe=True)

    size = dict(seed=5, clients=96, docs=8, shards=2)
    ref, result, _spec_ = _both("catchup-herd", probe, **size)
    ft = result.fold_tier
    assert ft["docs"] == len(result.sampled_digests) >= 1
    assert ft["device_cache"]["inserts"] >= 1
    assert ft["device_cache"]["served"] >= 1, ft["device_cache"]
    assert ft["delta_cache"]["served"] >= 1, ft["delta_cache"]
    assert ft["pack_cache"]["exact_hits"] >= 1
    assert ft["h2d_bytes"] > 0 and ft["d2h_bytes"] > 0
    assert "fold_tier" not in result.identity()
    off = _run("port", _spec("port", "catchup-herd", **size))
    assert off.fold_tier == {}
    assert off.identity() == result.identity(), (
        "the fold probe perturbed replay identity")
    _assert_equal(ref, result)


# -- scenario-spec fail-loud validation (tests/test_streamfold.py) -------------


def test_spec_rejects_gate_beyond_real_caller_bound():
    messages = []
    for scn in (ref_scn, port_scn):
        spec = scn.build_scenario("catchup-storm", seed=0, clients=64,
                                  docs=4, shards=1)
        with pytest.raises(ValueError,
                           match="silently bounds the election") as err:
            dataclasses.replace(spec, storm_min_cohort=8,
                                storm_clients_per_doc=4)
        messages.append(str(err.value))
        ok = dataclasses.replace(spec, storm_min_cohort=4)
        assert ok.storm_min_cohort == 4
    assert messages[0] == messages[1]


def test_spec_rejects_stream_without_storm_server():
    messages = []
    for scn in (ref_scn, port_scn):
        spec = scn.build_scenario("steady-typing", seed=0, clients=64,
                                  docs=4, shards=1)
        with pytest.raises(ValueError, match="storm=True") as err:
            dataclasses.replace(spec, stream=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# -- the catch-up storm (tests/test_catchup_storm.py) --------------------------


def test_storm_smoke_converges_balances_and_replays():
    ref, result, spec = _both("catchup-storm", seed=3, clients=800, docs=8,
                              shards=4)
    storm = result.storm
    assert storm["served"] == storm["requests"] > 0
    assert storm["shed"] > 0 or storm["degraded"] > 0, \
        "the storm must actually overload the fold lane"
    assert storm["warm"] > 0, "the warm priority lane must serve"
    admission = storm["admission"]
    assert admission["catchup.requests"] == (
        admission["catchup.admitted"] + admission["catchup.shed"]
        + admission["catchup.degraded"])
    assert result.fault_counts.get("catchup.slow:delay", 0) >= 1
    assert result.fault_counts.get("catchup.fail:fail", 0) >= 1
    assert storm["latency_p99_ticks"] <= 64.0
    oracle = _twin("port", spec, result)
    assert oracle.storm["shed"] == 0 and oracle.storm["degraded"] == 0
    assert result.sampled_digests == oracle.sampled_digests
    assert result.per_doc_head == oracle.per_doc_head
    assert _run("port", spec).identity() == result.identity()
    _assert_equal(ref, result)


def test_frontdoor_stats_roll_up_admission_and_relay(tmp_path):
    """The supervisor ``stats()`` view of a two-shard door: the same
    admission keys, relay view and counter names in both packages."""
    import fluidframework_tpu.service.frontdoor as ref_fd
    import fluidframework_tpu_torch.service.frontdoor as port_fd

    views = []
    for tag, fd_mod, kw in (("ref", ref_fd, {}),
                            ("port", port_fd, {"device": "cpu"})):
        fd = fd_mod.FrontDoor(str(tmp_path / tag), n_shards=2,
                              spawn="thread", **kw).start()
        try:
            stats = fd.stats()
            for key in ("catchup.requests", "catchup.admitted",
                        "catchup.shed", "catchup.degraded", "catchup.warm"):
                assert key in stats["admission"], key
            assert stats["relay"]["sessions"] == 0
            assert stats["relay"]["budget_per_session"] == 4 << 20
            assert "fd.relay_demotions" in stats["counters"]
            views.append((stats["admission"], stats["relay"],
                          sorted(stats["counters"])))
        finally:
            fd.close()
    assert views[1] == views[0]


# -- the process tier (thread shards) ------------------------------------------


def _proc_smoke(tmp_path, tag):
    def tweak(spec, _faults):
        return dataclasses.replace(spec, out_of_proc=True,
                                   proc_spawn="thread", sample_every=8,
                                   dir=str(tmp_path / tag / "swarm"))

    return tweak


def test_proc_swarm_smoke_oracle_verified(tmp_path):
    """tests/test_fluidproc.py's process-tier swarm smoke on thread
    shards: per-shard durable logs, batched ingress over the wire both
    hops, byte-identical to the in-proc single-shard oracle."""
    size = dict(seed=12, clients=1000, docs=16, shards=4)
    ref = _run("ref", _spec("ref", "steady-typing",
                            _proc_smoke(tmp_path, "ref"), **size))
    spec = _spec("port", "steady-typing", _proc_smoke(tmp_path, "port"),
                 **size)
    result = _run("port", spec)
    assert result.sequenced_ops > 1000
    twin = _twin("port", spec, result)
    assert result.sampled_digests == twin.sampled_digests
    assert result.per_doc_head == twin.per_doc_head
    cluster = result.shard_stats["cluster"]
    assert sorted(cluster["shards"]) == [f"shard{i:02d}" for i in range(4)]
    assert sum(s.get("ops", 0) for s in cluster["shards"].values()) \
        == result.sequenced_ops
    assert any(n > 0
               for n in result.shard_stats["tap_unique_frames"].values())
    assert {sid: s.get("ops") for sid, s in cluster["shards"].items()} \
        == {sid: s.get("ops")
            for sid, s in ref.shard_stats["cluster"]["shards"].items()}
    _assert_equal(ref, result)


def _replica_drill(name, tmp_path, tag, with_shard_kill=False):
    def tweak(spec, faults):
        total = sum(p.ticks for p in spec.phases)
        extra = tuple(p for p in spec.plan.points
                      if p.site == "shard.kill") if with_shard_kill else ()
        if with_shard_kill:
            assert extra, "scenario lost its shard kill"
        plan = faults.FaultPlan(seed=7, points=extra + (
            faults.FaultPoint("replica.kill", "kill", at=total // 2),))
        return dataclasses.replace(
            spec, out_of_proc=True, proc_spawn="thread", replicas=2,
            plan=plan, sample_every=4, dir=str(tmp_path / tag / "swarm"))

    return _spec(tag, name, tweak, seed=7, clients=400, docs=8, shards=2)


def test_replica_death_storm_drill_oracle_and_replay(tmp_path):
    ref = _run("ref", _replica_drill("catchup-storm", tmp_path, "ref"))
    spec = _replica_drill("catchup-storm", tmp_path, "port")
    result = _run("port", spec)
    assert result.replica_kills, "replica kill never executed"
    assert result.shard_stats["door_failovers"] >= 1
    assert result.shard_stats["doors"] == 2
    storm = result.storm
    assert storm["wire_clock"] is True
    assert storm["served"] == storm["requests"] > 0
    assert "swarm.storm_shed" in result.counters
    twin = _twin("port", spec, result)
    assert result.sampled_digests == twin.sampled_digests
    assert result.per_doc_head == twin.per_doc_head
    replay = _run("port", dataclasses.replace(
        spec, dir=str(tmp_path / "port" / "swarm2")))
    assert replay.identity() == result.identity()
    _assert_equal(ref, result)


def test_replica_death_failover_drill_with_shard_kill(tmp_path):
    ref = _run("ref", _replica_drill("failover-drill", tmp_path, "ref",
                                     with_shard_kill=True))
    spec = _replica_drill("failover-drill", tmp_path, "port",
                          with_shard_kill=True)
    result = _run("port", spec)
    assert result.kills, "the shard kill never executed"
    assert result.replica_kills, "the replica kill never executed"
    twin = _twin("port", spec, result)
    assert result.sampled_digests == twin.sampled_digests
    assert result.per_doc_head == twin.per_doc_head
    replay = _run("port", dataclasses.replace(
        spec, dir=str(tmp_path / "port" / "swarm2")))
    assert replay.identity() == result.identity()
    _assert_equal(ref, result)
