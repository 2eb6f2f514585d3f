"""The port's streaming fold against the JAX package's: every scenario of
tests/test_streamfold.py runs on both packages from one corpus
(tests/torch_server.py), with the reference's own assertions, and the
two records must be equal: the poll results ``{doc: (handle, ref_seq)}``,
every ``stats()`` dict, the head index's entries, the op-log floors and
``bytes_reclaimed``, and the server's stream-lane answers.

Two groups of the reference's scenarios are elsewhere:

- the ``DevicePackCache`` pin tests (pin survives the LRU sweep, the pin
  budget spills to the host and restores, unpin) — the port's tier-2.5
  cache runs them against the reference
  (tests/test_torch_device_cache.py);
- the scenario-spec validations — they check the scenario engine, and
  run on both packages in tests/test_torch_scenarios.py.
"""

import pytest
import torch

from tests.torch_server import (PORT, Session, oplog_record, run_both,
                                service_with_docs, type_ops)

torch.set_num_threads(1)


def _sf_record(sf, service, doc_ids):
    return {"stats": sf.stats(), "counters": dict(sf.counters),
            "index": dict(sf.head_index._entries),
            "index_stats": sf.head_index.stats(),
            "log": oplog_record(service, doc_ids)}


# -- StreamHeadIndex ---------------------------------------------------------


def _head_index_monotone(pkg):
    idx = pkg.StreamHeadIndex()
    out = [idx.publish("d", "h1", 10, "e1"), idx.get("d", "e1")]
    # Stale ref_seq never regresses the published head.
    out += [idx.publish("d", "h0", 5, "e1"), idx.get("d", "e1"),
            idx.counters.get("regressions")]
    # A different epoch sweeps the map: old entries are unservable.
    out += [idx.get("d", "e2"), idx.publish("d", "h2", 12, "e2"),
            idx.get("d", "e2"), len(idx), idx.published_ref_seq("d"),
            idx.invalidate_epoch("e2"), idx.invalidate_epoch("e3"),
            idx.get("d", "e3"), idx.stats()]
    return out


def _head_index_lag(pkg):
    idx = pkg.StreamHeadIndex()
    idx.publish("d", "h1", 10, "e")
    return [idx.observe_lag("d", 14), idx.observe_lag("d", 11),
            idx.stats()["lag_max"], idx.observe_lag("x", 7), idx.stats()]


def test_head_index_publish_is_monotone_and_epoch_pinned():
    got = run_both(_head_index_monotone)
    assert got[:5] == [True, ("h1", 10), False, ("h1", 10), 1]
    assert got[5:9] == [None, True, ("h2", 12), 1]


def test_head_index_lag_high_water():
    assert run_both(_head_index_lag)[:4] == [4, 1, 4, 7]


# -- the streaming poll loop -------------------------------------------------


def _poll_cadence(pkg):
    service, (d0, d1) = service_with_docs(pkg)
    catchup = pkg.CatchupService(service)
    sf = pkg.StreamFoldService(service, catchup, cadence_ops=4,
                               retention_floor=64, truncate=False).attach()
    type_ops(pkg, service, d0, 5)
    type_ops(pkg, service, d1, 2)  # below cadence: stays pending
    rec = {"due": sf.due()}
    results = sf.poll()
    assert set(results) == {d0}
    handle, ref_seq = results[d0]
    assert ref_seq == service.oplog.head(d0)
    # Published through the index AND durable in the store.
    assert sf.head_index.get(d0, service.storage.epoch) == (handle, ref_seq)
    assert service.storage.read(handle) is not None
    assert sf.counters["publishes"] == 1
    assert sf.counters["ops_folded"] >= 5
    rec["first"] = results
    # force folds the sub-cadence doc too.
    rec["forced"] = sf.poll(force=True)
    assert set(rec["forced"]) == {d1}
    # Nothing pending → an empty round.
    rec["empty"] = sf.poll(force=True)
    assert rec["empty"] == {}
    assert sf.stats()["pending_docs"] == 0
    rec.update(_sf_record(sf, service, [d0, d1]))
    rec["catchup_counters"] = (catchup.device_docs, catchup.cpu_docs)
    return rec


def test_poll_folds_at_cadence_and_publishes():
    got = run_both(_poll_cadence)
    assert got["due"] == ["sf-00"]
    assert got["catchup_counters"] == (2, 0)


def _commit_hook_records(pkg):
    service, (d0, _d1) = service_with_docs(pkg)
    catchup = pkg.CatchupService(service)
    sf = pkg.StreamFoldService(service, catchup, cadence_ops=2,
                               truncate=False).attach()
    type_ops(pkg, service, d0, 3)
    # The hook only RECORDED: no fold happened during stamping.
    assert sf.counters["folds"] == 0
    assert catchup.device_docs == catchup.cpu_docs == 0
    rec = {"stats": sf.stats()}
    sf.detach()
    type_ops(pkg, service, d0, 2)
    # Detached: commits after detach are invisible.
    rec["due"] = sf.due(force=True)
    rec["pending"] = dict(sf._pending)
    return rec


def test_commit_hook_records_without_folding():
    got = run_both(_commit_hook_records)
    assert got["stats"]["pending_docs"] == 1
    assert got["due"] == ["sf-00"]
    assert got["pending"]["sf-00"] == 4  # JOIN + 3; post-detach unseen


def test_commit_hook_never_touches_the_fold():
    """The port's hook runs inside the stamping path: it must not fold,
    so a catch-up service that raises on any call is never reached."""
    service, (d0, _d1) = service_with_docs(PORT)

    class NoFold:
        def __getattr__(self, name):
            raise AssertionError(f"commit hook reached catchup.{name}")

    sf = PORT.StreamFoldService(service, NoFold(), cadence_ops=1,
                                truncate=False).attach()
    type_ops(PORT, service, d0, 3)
    assert sf.due() == [d0] and sf.counters["folds"] == 0


def _stall_and_crash(pkg):
    plan = pkg.FaultPlan(seed=0, points=(
        pkg.FaultPoint("stream.stall", "stall", at=1),
        pkg.FaultPoint("stream.crash", "fail", at=1),
    ))
    faults = pkg.FaultInjector(plan)
    service, (d0, d1) = service_with_docs(pkg)
    catchup = pkg.CatchupService(service)
    sf = pkg.StreamFoldService(service, catchup, cadence_ops=2,
                               truncate=False, faults=faults).attach()
    type_ops(pkg, service, d0, 3)
    type_ops(pkg, service, d1, 3)
    rounds = []
    # Round 1 stalls whole: nothing folds, both docs stay pending.
    rounds.append((sf.poll(), sf.stats()))
    assert rounds[-1][1]["stalls"] == 1
    assert rounds[-1][1]["pending_docs"] == 2
    # Round 2 crashes mid-selection on the FIRST doc: both docs survive.
    rounds.append((sf.poll(), sf.stats()))
    assert rounds[-1][1]["crashes"] == 1
    assert rounds[-1][1]["pending_docs"] == 2
    # Round 3 is clean: both fold.
    rounds.append((sf.poll(), sf.stats()))
    assert set(rounds[-1][0]) == {d0, d1}
    assert not faults.unfired()
    return {"rounds": rounds, **_sf_record(sf, service, [d0, d1])}


def test_stall_skips_round_and_crash_aborts_mid_selection():
    got = run_both(_stall_and_crash)
    assert [r[0] for r in got["rounds"][:2]] == [{}, {}]


def _stream_vs_cold(pkg):
    stream_svc, (sd,) = service_with_docs(pkg, n_docs=1)
    cold_svc, (cd,) = service_with_docs(pkg, n_docs=1)
    catchup = pkg.CatchupService(stream_svc)
    sf = pkg.StreamFoldService(stream_svc, catchup, cadence_ops=4,
                               truncate=False).attach()
    polls = []
    for _ in range(4):
        type_ops(pkg, stream_svc, sd, 4)
        polls.append(sf.poll())
    type_ops(pkg, cold_svc, cd, 16)
    cold = pkg.CatchupService(cold_svc).catch_up([cd], upload=False)
    handle, ref_seq = sf.head_index.get(sd, stream_svc.storage.epoch)
    assert ref_seq == 17 and cold[cd][1] == 17  # JOIN + 16 ops each
    # upload=False hands back the fold's content digest.
    streamed = stream_svc.storage.read(handle).digest()
    assert streamed == cold[cd][0]
    return {"polls": polls, "cold": cold, "streamed": streamed,
            "resident": catchup.device_cache.stats(),
            **_sf_record(sf, stream_svc, [sd])}


def test_streaming_matches_cold_fold_byte_identically():
    got = run_both(_stream_vs_cold)
    assert len(got["polls"]) == 4 and all(got["polls"])


# -- summary-anchored truncation via the poll loop ---------------------------


def _truncate_with_floor(pkg, tmp_path):
    # A file-backed log: the cut rewrites it and counts reclaimed bytes.
    oplog = pkg.OpLog(path=str(tmp_path / f"{pkg.name}.ndjson"),
                      autoflush=True)
    service, (d0,) = service_with_docs(pkg, n_docs=1, oplog=oplog)
    catchup = pkg.CatchupService(service)
    sf = pkg.StreamFoldService(service, catchup, cadence_ops=4,
                               retention_floor=4).attach()
    type_ops(pkg, service, d0, 16)  # head 17: JOIN + 16 ops
    results = sf.poll()
    assert results[d0][1] == 17
    # cut = min(summary ref 17, MSN, head 17 − retention 4 = 13)
    floor = service.oplog.floor(d0)
    assert 0 < floor <= 13
    assert sf.counters["truncations"] == 1
    assert sf.counters["truncated_msgs"] == floor
    # Boundary gap-repair read stays legal; below raises.
    tail = [m.seq for m in service.oplog.get(d0, from_seq=floor)]
    assert tail == list(range(floor + 1, 18))
    with pytest.raises(pkg.TruncatedRangeError):
        service.oplog.get(d0, from_seq=floor - 1)
    # The truncated doc still catches up (summary + tail).
    again = pkg.CatchupService(service).catch_up([d0], upload=False)
    assert again[d0][1] == 17
    return {"results": results, "tail": tail, "again": again,
            **_sf_record(sf, service, [d0])}


def test_poll_truncates_behind_summary_with_retention_floor(tmp_path):
    got = run_both(_truncate_with_floor, tmp_path)
    assert got["log"]["bytes_reclaimed"] > 0


def _truncate_below_msn(pkg):
    # A connected client pinned at an old ref_seq holds MSN down: the
    # cut must stay at/below MSN so the client's gap repair still finds
    # its records.
    service, (d0,) = service_with_docs(pkg, n_docs=1)
    ep = service.endpoint(d0)
    ep.connect("slow")
    type_ops(pkg, service, d0, 16, client="typer")
    ep.update_ref_seq("slow", 3)
    catchup = pkg.CatchupService(service)
    sf = pkg.StreamFoldService(service, catchup, cadence_ops=4,
                               retention_floor=0).attach()
    sf.note_doc(d0)
    results = sf.poll(force=True)
    msn = ep._orderer.sequencer.min_seq
    assert service.oplog.floor(d0) <= msn
    # The slow client's repair from its own ref view still reads.
    repair = [m.seq for m in service.oplog.get(d0, from_seq=msn)]
    return {"results": results, "msn": msn, "repair": repair,
            **_sf_record(sf, service, [d0])}


def test_truncation_never_cuts_above_msn():
    got = run_both(_truncate_below_msn)
    assert got["log"]["floors"]["sf-00"] <= got["msn"]


# -- the server's streaming-head lane ----------------------------------------


def _stream_lane(pkg):
    service, (d0,) = service_with_docs(pkg, n_docs=1)
    server = pkg.OrderingServer(service)
    sf = server.enable_streaming(cadence_ops=4, retention_floor=64)
    type_ops(pkg, service, d0, 8)  # head 9: JOIN + 8 ops
    folded = server._dispatch(Session(), "stream_poll", {})
    assert folded["folded"][d0][1] == 9
    # Two more ops — within the stream lag: served from the streaming
    # head with NO fold, lane marked, admission counter bumped.
    type_ops(pkg, service, d0, 2)
    before = server.admission.get("catchup.stream")
    out = server._dispatch(Session(), "catchup", {"docs": [d0]})
    assert out["lane"] == "stream"
    assert out["stream"] == [d0]
    assert out["docs"][d0][1] == 9  # the published ref_seq
    assert server.admission.get("catchup.stream") == before + 1
    handle, ref_seq = out["docs"][d0]
    assert service.storage.read(handle) is not None
    tail = [m.seq for m in service.oplog.get(d0, from_seq=ref_seq)]
    assert tail == [10, 11]
    assert sf.stats()["head_publishes"] >= 1
    return {"folded": folded, "answer": out, "tail": tail,
            "admission": server.admission.snapshot(),
            **_sf_record(sf, service, [d0])}


def test_server_stream_lane_serves_published_head():
    run_both(_stream_lane)


def _stream_lane_fall_through(pkg):
    service, (d0,) = service_with_docs(pkg, n_docs=1)
    server = pkg.OrderingServer(service)
    sf = server.enable_streaming(cadence_ops=4, retention_floor=64)
    type_ops(pkg, service, d0, 8)  # head 9: JOIN + 8 ops
    folded = server._dispatch(Session(), "stream_poll", {})
    # The summary ages: 6 > cadence unfolded ops — the stream lane must
    # NOT serve a stale head; the request falls through to the fold.
    type_ops(pkg, service, d0, 6)
    out = server._dispatch(Session(), "catchup", {"docs": [d0]})
    assert out["lane"] != "stream"
    assert out["docs"][d0][1] == 15
    return {"folded": folded, "answer": out,
            "admission": server.admission.snapshot(),
            **_sf_record(sf, service, [d0])}


def test_server_stream_lane_degrades_when_lag_exceeds_cadence():
    got = run_both(_stream_lane_fall_through)
    assert got["answer"]["lane"] == "fold"
    assert got["admission"]["catchup.admitted"] == 1


def _submit_polls_inline(pkg):
    """With streaming on, each ``submit`` RPC runs a cadence-gated poll
    inline: live traffic folds without any explicit stream_poll."""
    service, (d0,) = service_with_docs(pkg, n_docs=1)
    server = pkg.OrderingServer(service)
    sf = server.enable_streaming(cadence_ops=4, retention_floor=2)
    ep = service.endpoint(d0)
    ep.connect("c1")
    from_wire = []
    ref = service.oplog.head(d0)
    for i in range(10):
        op = pkg.RawOperation(
            client_id="c1", client_seq=i + 1, ref_seq=ref,
            type=pkg.MessageType.OP,
            contents={"type": "groupedBatch", "ops": [
                {"ds": "ds", "channel": "text", "clientSeq": i + 1,
                 "contents": {"kind": "insert", "pos": 0,
                              "text": "b"}}]}).to_dict()
        msg = server._dispatch(Session(), "submit", {"doc": d0, "op": op})
        from_wire.append(msg["sequenceNumber"])
        ref = msg["sequenceNumber"]
    return {"seqs": from_wire, "stats": server._stats(),
            **_sf_record(sf, service, [d0])}


def test_submit_under_streaming_folds_at_cadence():
    got = run_both(_submit_polls_inline)
    assert got["counters"]["folds"] >= 2
    assert got["log"]["floors"]["sf-00"] > 0
