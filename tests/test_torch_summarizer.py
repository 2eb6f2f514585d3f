"""The port's summarizer (``fluidframework_tpu_torch.runtime.summarizer``)
against the JAX package's: twins of the ``SummaryManager`` cases of
tests/test_service.py (scribe ack and stale nack), test_runtime.py
(election, heuristics and takeover; catch-up from the latest summary),
test_nack.py (backoff after nacks), test_history.py (the ack's commit
digest) and test_incremental_summary.py (incremental uploads).

Each scenario runs on both packages with its reference test's own
assertions and returns a record of what it observed (the manager's
counters and handles, the scribe's acks and nacks, the sequenced log's
message types, summary digests); the two records must be equal.
"""

import types

import pytest

import fluidframework_tpu.protocol.messages as ref_messages
import fluidframework_tpu.protocol.sequencer as ref_sequencer
import fluidframework_tpu.protocol.summary as ref_summary
import fluidframework_tpu.runtime as ref_runtime
import fluidframework_tpu.service as ref_service
import fluidframework_tpu_torch.protocol.messages as port_messages
import fluidframework_tpu_torch.protocol.sequencer as port_sequencer
import fluidframework_tpu_torch.protocol.summary as port_summary
import fluidframework_tpu_torch.runtime as port_runtime
import fluidframework_tpu_torch.service as port_service


def _pkg(messages, sequencer, summary, runtime, service):
    return types.SimpleNamespace(
        MessageType=messages.MessageType, RawOperation=messages.RawOperation,
        Sequencer=sequencer.Sequencer, SummaryStorage=summary.SummaryStorage,
        ContainerRuntime=runtime.ContainerRuntime,
        SummaryManager=runtime.SummaryManager,
        SummarizerOptions=runtime.SummarizerOptions,
        LocalOrderingService=service.LocalOrderingService)


REF = _pkg(ref_messages, ref_sequencer, ref_summary, ref_runtime,
           ref_service)
PORT = _pkg(port_messages, port_sequencer, port_summary, port_runtime,
            port_service)


def run_both(scenario):
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def _manager_record(mgr):
    return {k: getattr(mgr, k) for k in (
        "last_summary_seq", "last_ack_handle", "last_acked_handle",
        "last_acked_seq", "nacks_received", "consecutive_nacks",
        "ops_since_summary", "summaries_written", "last_upload_bytes",
        "last_full_bytes")}


def _log_types(log):
    return [m.type.value for m in log]


def test_exports_match_the_reference():
    assert {"SummarizerOptions", "SummaryManager"} <= set(port_runtime.__all__)
    assert port_runtime.SummarizerOptions().__dict__ \
        == ref_runtime.SummarizerOptions().__dict__


# -- tests/test_service.py: the scribe -----------------------------------------


def _connected_runtime_with_string(pkg, service, doc_id, client_id):
    ep = service.create_document(doc_id) if not service.has_document(doc_id) \
        else service.endpoint(doc_id)
    runtime = pkg.ContainerRuntime()
    ds = runtime.create_datastore("ds")
    text = ds.create_channel("sequence-tpu", "text")
    runtime.connect(ep, client_id)
    runtime.drain()
    return runtime, ds, text, ep


def test_scribe_acks_valid_summary():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        runtime, _ds, text, ep = _connected_runtime_with_string(
            pkg, service, "doc", "a")
        mgr = pkg.SummaryManager(runtime, service.storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=1000))
        text.insert_text(0, "hello")
        runtime.drain()
        handle = mgr.summarize_now()
        runtime.drain()
        orderer = service._orderers["doc"]
        assert orderer.scribe.acks == 1
        assert orderer.scribe.nacks == 0
        assert mgr.last_acked_handle == orderer.scribe.last_acked_handle
        types_ = [m.type for m in ep.log]
        assert pkg.MessageType.SUMMARY_ACK in types_
        return handle, _manager_record(mgr), _log_types(ep.log)

    run_both(scenario)


def test_scribe_nacks_stale_summary():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        runtime, _ds, text, ep = _connected_runtime_with_string(
            pkg, service, "doc", "a")
        mgr = pkg.SummaryManager(runtime, service.storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=1000))
        text.insert_text(0, "hello")
        runtime.drain()
        first = mgr.summarize_now()
        runtime.drain()
        text.insert_text(5, " world")
        runtime.drain()
        second = mgr.summarize_now()
        runtime.drain()
        assert second != first
        orderer = service._orderers["doc"]
        before_nacks = orderer.scribe.nacks
        ep.submit(pkg.RawOperation(
            client_id="a", client_seq=999, ref_seq=runtime.ref_seq,
            type=pkg.MessageType.SUMMARIZE,
            contents={"handle": first, "seq": 1}))
        assert orderer.scribe.nacks == before_nacks + 1
        return (first, second, _manager_record(mgr), _log_types(ep.log),
                [m.contents for m in ep.log
                 if m.type is pkg.MessageType.SUMMARY_NACK])

    run_both(scenario)


# -- tests/test_runtime.py: election, heuristics, catch-up ---------------------


def _make_runtime(pkg, sequencer, client_id):
    rt = pkg.ContainerRuntime()
    rt.connect(sequencer, client_id)
    return rt


def test_summarizer_election_and_heuristics():
    def scenario(pkg):
        seq = pkg.Sequencer()
        storage = pkg.SummaryStorage()
        a = _make_runtime(pkg, seq, "alice")
        b = _make_runtime(pkg, seq, "bob")
        mgr_a = pkg.SummaryManager(a, storage, "doc",
                                   pkg.SummarizerOptions(ops_per_summary=5))
        mgr_b = pkg.SummaryManager(b, storage, "doc",
                                   pkg.SummarizerOptions(ops_per_summary=5))
        a.drain()
        b.drain()
        assert mgr_a.election.elected == "alice"
        ds_a = a.create_datastore("d")
        ds_b = b.create_datastore("d")
        m_a = ds_a.create_channel("map-tpu", "m")
        ds_b.create_channel("map-tpu", "m")
        for i in range(12):
            m_a.set(f"k{i}", i)
            a.drain()
            b.drain()
        assert mgr_a.summaries_written >= 2
        assert mgr_b.summaries_written == 0
        assert mgr_b.last_ack_handle == mgr_a.last_ack_handle
        tree, ref_seq = storage.latest("doc")
        assert tree is not None and ref_seq == mgr_a.last_summary_seq
        before = (_manager_record(mgr_a), _manager_record(mgr_b),
                  tree.digest(), ref_seq)
        seq.disconnect("alice")
        a.drain()
        b.drain()
        assert mgr_b.election.elected == "bob"
        for i in range(6):
            b.get_datastore("d").get_channel("m").set(f"x{i}", i)
            a.drain()
            b.drain()
        assert mgr_b.summaries_written >= 1
        return before, _manager_record(mgr_b), _log_types(seq.log)

    run_both(scenario)


def test_catchup_from_latest_summary_via_storage():
    def scenario(pkg):
        seq = pkg.Sequencer()
        storage = pkg.SummaryStorage()
        a = _make_runtime(pkg, seq, "alice")
        mgr = pkg.SummaryManager(a, storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=4))
        a.drain()
        s = a.create_datastore("d").create_channel("sequence-tpu", "s")
        for i in range(10):
            s.insert_text(0, f"{i} ")
            a.drain()
        tree, base_seq = storage.latest("doc")
        assert tree is not None and base_seq > 0
        fresh = pkg.ContainerRuntime()
        loaded_seq = fresh.load(tree)
        assert loaded_seq == base_seq
        for msg in seq.log:
            if msg.seq > loaded_seq:
                fresh.process(msg)
        assert fresh.summarize().digest() == a.summarize().digest()
        assert fresh.get_datastore("d").get_channel("s").text == s.text
        return tree.digest(), base_seq, _manager_record(mgr), \
            fresh.summarize().digest()

    run_both(scenario)


# -- tests/test_nack.py: backoff -----------------------------------------------


def test_summarizer_backs_off_after_nacks():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        ep = service.create_document("doc")
        rt = pkg.ContainerRuntime()
        text = rt.create_datastore("ds").create_channel("sequence-tpu", "t")
        rt.connect(ep, "summarizer")
        rt.drain()
        mgr = pkg.SummaryManager(rt, pkg.SummaryStorage(), "doc",
                                 pkg.SummarizerOptions(ops_per_summary=50,
                                                       nack_retry_ops=4))
        attempts = []
        orig = mgr.summarize_now

        def counting():
            attempts.append(rt.ref_seq)
            return orig()

        mgr.summarize_now = counting
        for _ in range(90):
            text.insert_text(0, "x")
            rt.drain()
        scribe_nacks = service._orderers["doc"].scribe.nacks
        assert scribe_nacks >= 2, "scribe must have nacked summaries"
        assert mgr.consecutive_nacks >= 2
        assert len(attempts) >= 3
        gaps = [b - a for a, b in zip(attempts, attempts[1:])]
        assert all(g >= 4 for g in gaps), gaps
        assert any(g >= 8 for g in gaps[1:]), gaps
        return attempts, scribe_nacks, _manager_record(mgr)

    run_both(scenario)


# -- tests/test_history.py: the ack's commit -----------------------------------


def test_scribe_ack_carries_commit_digest():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        ep = service.create_document("doc")
        runtime = pkg.ContainerRuntime()
        text = runtime.create_datastore("ds").create_channel(
            "sequence-tpu", "text")
        runtime.connect(ep, "a")
        runtime.drain()
        mgr = pkg.SummaryManager(runtime, service.storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=1000))
        text.insert_text(0, "hello")
        runtime.drain()
        mgr.summarize_now()
        runtime.drain()
        acks = [m for m in ep.log if m.type is pkg.MessageType.SUMMARY_ACK]
        assert len(acks) == 1
        commit_digest = acks[0].contents["commit"]
        commit = service.storage.read_commit(commit_digest)
        assert commit.tree == acks[0].contents["handle"]
        assert service.storage.head("doc") == commit_digest
        return acks[0].contents["handle"], commit.tree, \
            _manager_record(mgr)

    run_both(scenario)


# -- tests/test_incremental_summary.py -----------------------------------------


def test_summary_manager_uploads_incrementally():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        ep = service.create_document("doc")
        rt = pkg.ContainerRuntime()
        ds = rt.create_datastore("ds")
        ds.create_channel("sequence-tpu", "text")
        ds.create_channel("map-tpu", "kv")
        rt.connect(ep, "a")
        rt.drain()
        ep.connect("idle")
        mgr = pkg.SummaryManager(rt, service.storage, "doc",
                                 pkg.SummarizerOptions(ops_per_summary=1000))
        rt.get_datastore("ds").get_channel("text").insert_text(
            0, "payload " * 500)
        rt.drain()
        mgr.summarize_now()
        rt.drain()
        rt.get_datastore("ds").get_channel("kv").set("delta", "small")
        rt.drain()
        handle = mgr.summarize_now()
        assert mgr.last_upload_bytes < mgr.last_full_bytes / 3, (
            f"{mgr.last_upload_bytes}B uploaded vs "
            f"{mgr.last_full_bytes}B full")
        loaded = pkg.ContainerRuntime()
        loaded.load(service.storage.read(handle))
        assert loaded.summarize().digest() == handle
        assert loaded.get_datastore("ds").get_channel("kv").get("delta") \
            == "small"
        return handle, _manager_record(mgr)

    run_both(scenario)


@pytest.mark.parametrize("ops_per_summary", [3, 7])
def test_summaries_of_a_typing_session_are_equal(ops_per_summary):
    """A longer session (two writers, the summarizer's cadence firing
    several times): every upload's handle, bytes and ack equal."""
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        runtime, _ds, text, ep = _connected_runtime_with_string(
            pkg, service, "doc", "a")
        other, _ds2, text2, _ep2 = _connected_runtime_with_string(
            pkg, service, "doc", "b")
        opts = pkg.SummarizerOptions(ops_per_summary=ops_per_summary)
        mgr = pkg.SummaryManager(runtime, service.storage, "doc", opts)
        mgr2 = pkg.SummaryManager(other, service.storage, "doc", opts)
        records = []
        for i in range(24):
            (text if i % 3 else text2).insert_text(0, f"<{i}>")
            runtime.drain()
            other.drain()
            records.append((_manager_record(mgr), _manager_record(mgr2)))
        orderer = service._orderers["doc"]
        return records, orderer.scribe.acks, orderer.scribe.nacks, \
            _log_types(ep.log)

    got = run_both(scenario)
    assert got[1] >= 2
