"""The port's TCP ordering server against the JAX package's.

Two in-thread servers, the reference's and the port's
(``device="cpu"``), take the same scripted ``Loader`` sessions over TCP
(tests/torch_server.py) and must give the same answers: the fold lane
(documents, ``skipped``, ``deviceDocs`` / ``cpuDocs`` and the
per-channel split, every tier's stats, the uploaded summary, a fresh
``Loader`` that replays nothing), the warm lane, tenancy, the stream
lane, the drain nack and the timing-free fields of the ``stats`` RPC.
The admission scenarios of tests/test_catchup_storm.py that need no
front door (shedding, degraded serving, the ``catchup.slow`` /
``catchup.fail`` faults under a virtual clock) run in-proc on both.
Last, the port's ``main()`` in a subprocess: ``--device cpu --dir``
across a restart, ``--shards 2``, and no ``--device`` without CUDA.

Every wait is bounded: socket timeouts in the driver, deadline loops,
``join(timeout=)``, and ``close()`` in ``finally``.
"""

import os
import random
import select
import subprocess
import sys
import threading
import time

import pytest
import torch

from tests.torch_server import (PORT, Session, build_mixed, free_port,
                                quiesce, run_both, start, stop, timing_free,
                                type_mixed, type_text)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ("mixed-a", "mixed-b")


def _fresh(pkg, port, doc_id):
    """A read-only Loader's view of ``doc_id``: (catchup_ops, digest)."""
    factory = pkg.NetworkDocumentServiceFactory(port=port)
    try:
        c = pkg.Loader(factory).resolve(doc_id)
        out = (c.catchup_ops, c.runtime.summarize().digest())
        c.close()
        return out
    finally:
        factory.close()


# -- the fold and warm lanes over TCP ----------------------------------------


def _fold_and_warm(pkg):
    srv = start(pkg.OrderingServer(port=0))
    factory = pkg.NetworkDocumentServiceFactory(port=srv.port)
    try:
        loader = pkg.Loader(factory)
        writers = {}
        for i, doc_id in enumerate(DOCS):
            writers[doc_id] = loader.create(doc_id, "alice", build_mixed)
            type_mixed(writers[doc_id], i, 14, factory, doc_id)
        heads = {d: quiesce(factory, d, c) for d, c in writers.items()}
        want = {d: c.runtime.summarize().digest()
                for d, c in writers.items()}
        fold = factory._rpc.request("catchup",
                                    {"docs": list(DOCS) + ["typo"]})
        assert fold["lane"] == "fold" and fold["skipped"] == ["typo"]
        assert fold["deviceDocs"] == len(DOCS) and fold["cpuDocs"] == 0
        assert fold["hostChannels"] == len(DOCS)  # the counters
        for doc_id, (handle, seq) in fold["docs"].items():
            assert seq == heads[doc_id]
            # the uploaded summary IS the fresh catch-up state
            assert srv.service.storage.latest(doc_id)[0].digest() == handle
        fresh = {d: _fresh(pkg, srv.port, d) for d in DOCS}
        assert fresh == {d: (0, want[d]) for d in DOCS}
        warm = factory._rpc.request("catchup", {"docs": list(DOCS)})
        assert warm["lane"] == "warm" and warm["docs"] == fold["docs"]
        stats = timing_free(factory._rpc.request("stats", {}))
        for c in writers.values():
            c.close()
        return {"heads": heads, "want": want, "fold": fold, "warm": warm,
                "stats": stats}
    finally:
        factory.close()
        stop(srv)


def test_fold_lane_then_warm_lane_over_tcp():
    got = run_both(_fold_and_warm)
    assert got["stats"]["admission"]["catchup.admitted"] == 1
    assert got["stats"]["admission"]["catchup.warm"] == 1


def _tenancy(pkg):
    srv = start(pkg.OrderingServer(
        port=0, tenants={"acme": "s3cret", "beta": "pw"}))
    fa = pkg.NetworkDocumentServiceFactory(port=srv.port, tenant="acme",
                                           secret="s3cret")
    fb = pkg.NetworkDocumentServiceFactory(port=srv.port, tenant="beta",
                                           secret="pw")
    try:
        client = pkg.Loader(fa).create("doc", "alice", build_mixed)
        type_mixed(client, 5, 8, fa, "doc")
        quiesce(fa, "doc", client)
        out = fa._rpc.request("catchup", {})  # no list: whole namespace
        assert list(out["docs"]) == ["doc"]
        handle, _seq = out["docs"]["doc"]
        # the producing tenant can read the new summary...
        assert fa._rpc.request("read_summary", {"handle": handle})
        # ...a foreign tenant cannot, and folds only its own namespace
        with pytest.raises(Exception, match="unknown handle"):
            fb._rpc.request("read_summary", {"handle": handle})
        other = fb._rpc.request("catchup", {})
        client.close()
        return {"acme": out, "beta": other}
    finally:
        fa.close()
        fb.close()
        stop(srv)


def test_catchup_respects_tenancy():
    got = run_both(_tenancy)
    assert got["beta"]["docs"] == {}


def _stream_lane_tcp(pkg):
    srv = start(pkg.OrderingServer(port=0))
    sf = srv.enable_streaming(cadence_ops=4, retention_floor=4)
    factory = pkg.NetworkDocumentServiceFactory(port=srv.port)
    try:
        writer = pkg.Loader(factory).create(
            "doc", "alice",
            lambda rt: rt.create_datastore("ds").create_channel(
                "sequence-tpu", "text"))
        # each submit RPC polls inline: a fold at every 4th op
        type_text(writer, 9, factory, "doc")
        head = quiesce(factory, "doc", writer)
        forced = factory._rpc.request("stream_poll", {"force": True})
        type_text(writer, 2, factory, "doc")
        head2 = quiesce(factory, "doc", writer)
        lane = factory._rpc.request("catchup", {"docs": ["doc"]})
        assert lane["lane"] == "stream" and lane["stream"] == ["doc"]
        assert lane["docs"]["doc"][1] == head
        # Six more: the inline polls fold at the cadence again, up to
        # the head, so the result tier serves it (the fall-through to a
        # fold needs a lag past the cadence, which the inline polls never
        # leave; tests/test_torch_streamfold.py drives it in-proc).
        type_text(writer, 6, factory, "doc")
        head3 = quiesce(factory, "doc", writer)
        fall = factory._rpc.request("catchup", {"docs": ["doc"]})
        assert fall["lane"] == "warm" and fall["docs"]["doc"][1] == head3
        writer.close()
        return {"heads": (head, head2, head3), "forced": forced,
                "lane": lane, "fall": fall, "stream": sf.stats(),
                "floor": srv.service.oplog.floor("doc"),
                "stats": timing_free(factory._rpc.request("stats", {}))}
    finally:
        factory.close()
        stop(srv)


def test_stream_lane_over_tcp():
    got = run_both(_stream_lane_tcp)
    assert got["stream"]["folds"] >= 3 and got["floor"] > 0


def _drain_nack(pkg):
    srv = start(pkg.OrderingServer(port=0, mc=pkg.mc(
        **{"Server.DrainRetryAfter": 2.5})))
    factory = pkg.NetworkDocumentServiceFactory(port=srv.port)
    try:
        factory._rpc.request("create_document", {"doc": "d"})
        srv.draining = True
        assert factory._rpc.request("ping", {}) == "pong"
        stats = timing_free(factory._rpc.request("stats", {}))
        with pytest.raises(pkg.NackError) as exc_info:
            factory._rpc.request("has_document", {"doc": "d"})
        nack = exc_info.value
        return {"stats": stats,
                "nack": (nack.code, nack.retry_after, nack.reason)}
    finally:
        factory.close()
        stop(srv)


def test_drain_nack_and_stats_over_tcp():
    got = run_both(_drain_nack)
    assert got["nack"][:2] == ("shuttingDown", 2.5)
    assert got["stats"]["docs"] == 1


# -- admission: the storm scenarios that need no front door ------------------


def _service_with_doc(pkg, sets=3, summarize_at_head=False):
    """One map-channel document with ``sets`` ops of durable tail;
    optionally a fresh summary AT the head (the fully-warm shape)."""
    service = pkg.LocalOrderingService()
    loader = pkg.Loader(pkg.LocalDocumentServiceFactory(service))
    client = loader.create(
        "doc", "alice",
        lambda rt: rt.create_datastore("ds").create_channel("map-tpu", "kv"))
    kv = client.runtime.get_datastore("ds").get_channel("kv")
    for k in range(sets):
        kv.set(f"k{k}", k)
    client.drain()
    client.close()
    if summarize_at_head:
        ro = loader.resolve("doc")
        service.storage.upload("doc", ro.runtime.summarize(),
                               ro.runtime.ref_seq)
        ro.close()
    return service, loader


def _append_op(pkg, service, client="w", key="late", value=9):
    """One more durable map-set (JOIN + OP) past the stored summary."""
    ep = service.endpoint("doc")
    ep.connect(client)
    head = service.oplog.head("doc")
    ep.submit(pkg.RawOperation(
        client_id=client, client_seq=1, ref_seq=head,
        type=pkg.MessageType.OP,
        contents={"type": "groupedBatch", "v": 1,
                  "ops": [{"clientSeq": 1, "refSeq": head, "ds": "ds",
                           "channel": "kv",
                           "contents": {"kind": "set", "key": key,
                                        "value": value}}]}))
    ep.disconnect(client)


def _admission_controller(pkg):
    clock = pkg.VirtualClock()
    ctl = pkg.AdmissionController(2, clock=clock, retry_floor=0.1,
                                  retry_cap=3.0, cost_init=0.5)
    verdicts = [ctl.admit(), ctl.admit()]
    verdicts += [ctl.admit() for _ in range(8)]
    ctl.release(verdicts[0][1])
    verdicts.append(ctl.admit())
    snaps = [ctl.snapshot()]
    one = pkg.AdmissionController(1, clock=clock, cost_init=0.1)
    _v, token = one.admit()
    one.release(token, hold=2.0)
    verdicts.append(one.admit())
    clock.sleep(2.5)
    verdicts.append(one.admit())
    _v, token = verdicts[-1]
    clock.sleep(4.0)
    one.release(token)
    snaps.append(one.snapshot())
    return {"verdicts": verdicts, "snaps": snaps}


def test_admission_controller_pacing_and_leases():
    got = run_both(_admission_controller)
    holds = [v[1] for v in got["verdicts"][2:10]]
    assert holds == sorted(holds) and 0.1 <= holds[0] < holds[-1] <= 3.0
    assert got["verdicts"][10][0] == "admit"
    assert got["verdicts"][11][0] in ("shed", "degrade")
    assert got["verdicts"][12][0] == "admit"
    assert got["snaps"][1]["cost_ema"] > 1.0


def _warm_bypass(pkg):
    service, _loader = _service_with_doc(pkg, summarize_at_head=True)
    server = pkg.OrderingServer(service, catchup_max_inflight=1,
                                clock=pkg.VirtualClock())
    verdict, _token = server.admission_control.admit()  # saturate
    out = server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    return {"verdict": verdict, "out": out,
            "admission": server.admission.snapshot()}


def test_warm_requests_bypass_fold_admission():
    got = run_both(_warm_bypass)
    assert got["out"]["lane"] == "warm"
    assert got["admission"]["catchup.warm"] == 1
    assert got["admission"]["catchup.requests"] == 0


def _single_flight_herd(pkg, monkeypatch):
    """N concurrent catch-ups of one document cost ONE admission slot:
    followers ride the single-flight join in the warm lane."""
    service, _loader = _service_with_doc(pkg, sets=4)
    server = pkg.OrderingServer(service, catchup_max_inflight=4)
    entered, release = threading.Event(), threading.Event()
    cls = pkg.CatchupServiceClass
    real_cpu = cls._cpu_fold

    def slow_cpu(self, work):
        entered.set()
        assert release.wait(timeout=30)
        return real_cpu(self, work)

    monkeypatch.setattr(cls, "_cpu_fold", slow_cpu)
    monkeypatch.setattr(cls, "_device_plan", lambda self, work: None)
    results, errors = [], []

    def call():
        try:
            results.append(server._dispatch(Session(), "catchup",
                                            {"docs": ["doc"]}))
        except BaseException as exc:  # surfaced via the errors list
            errors.append(exc)

    leader = threading.Thread(target=call, daemon=True)
    leader.start()
    assert entered.wait(timeout=30)
    followers = [threading.Thread(target=call, daemon=True)
                 for _ in range(3)]
    for f in followers:
        f.start()
    deadline = time.time() + 10  # followers reach the single-flight join
    while time.time() < deadline and \
            server._catchup.cache.stats().get("waits", 0) < 3:
        time.sleep(0.01)
    release.set()
    for t in [leader] + followers:
        t.join(timeout=30)
        assert not t.is_alive()
    monkeypatch.undo()
    assert not errors
    return {"handles": sorted({tuple(r["docs"]["doc"]) for r in results}),
            "lanes": sorted(r["lane"] for r in results),
            "admission": server.admission.snapshot()}


def test_single_flight_herd_costs_one_admission_slot(monkeypatch):
    got = run_both(_single_flight_herd, monkeypatch)
    assert len(got["handles"]) == 1
    assert got["lanes"] == ["fold", "warm", "warm", "warm"]
    assert got["admission"]["catchup.admitted"] == 1


def _shed_then_retry(pkg):
    clock = pkg.VirtualClock()
    service, _loader = _service_with_doc(pkg, sets=3)
    server = pkg.OrderingServer(service, catchup_max_inflight=1,
                                clock=clock)
    _v, token = server.admission_control.admit()
    server.admission_control.release(token, hold=1.5)  # occupied 1.5 s
    counters = pkg.LockedCounterSet()
    out = pkg.RetryPolicy(max_attempts=6, budget=60.0).run(
        lambda: server._dispatch(Session(), "catchup", {"docs": ["doc"]}),
        operation="storm catchup", sleep=clock.sleep,
        rng=random.Random(0), counters=counters)
    return {"out": out, "admission": server.admission.snapshot(),
            "retry": counters.snapshot(), "clock": clock.now}


def test_shed_retry_after_honored_by_retry_policy_under_virtual_clock():
    got = run_both(_shed_then_retry)
    assert got["out"]["lane"] == "fold"
    assert got["admission"]["catchup.shed"] >= 1
    assert got["retry"]["retry.nack_holds"] >= 1


def _degraded(pkg, gate_on):
    service, loader = _service_with_doc(pkg, sets=2, summarize_at_head=True)
    _append_op(pkg, service)  # grow the tail PAST the stored summary
    settings = {"Catchup.DegradeAfter": 0}
    if not gate_on:
        settings["Catchup.DegradedServe"] = "off"
    server = pkg.OrderingServer(service, catchup_max_inflight=1,
                                clock=pkg.VirtualClock(),
                                mc=pkg.mc(**settings))
    server.admission_control.admit()  # saturate; never freed
    if not gate_on:
        with pytest.raises(pkg.NackError) as exc_info:
            server._dispatch(Session(), "catchup", {"docs": ["doc"]})
        return {"nack": (exc_info.value.code, exc_info.value.retry_after),
                "admission": server.admission.snapshot()}
    out = server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    handle, ref_seq = out["docs"]["doc"]
    assert ref_seq < service.oplog.head("doc")  # genuinely stale
    # convergence: stored summary + durable tail == full fresh state
    rt = pkg.ContainerRuntime(pkg.default_registry())
    rt.load(service.storage.read(handle))
    for msg in service.oplog.get("doc", from_seq=ref_seq):
        rt.process(msg)
    check = loader.resolve("doc")
    assert rt.summarize().digest() == check.runtime.summarize().digest()
    check.close()
    return {"out": out, "admission": server.admission.snapshot()}


@pytest.mark.parametrize("gate_on", [True, False], ids=["serve", "gate_off"])
def test_degraded_serving_under_sustained_overload(gate_on):
    got = run_both(_degraded, gate_on)
    if gate_on:
        assert got["out"]["lane"] == "degraded"
        assert got["out"]["degraded"] == ["doc"]
        assert got["admission"]["catchup.degraded_docs"] == 1
    else:
        assert got["nack"][0] == "overloaded"
        assert got["admission"]["catchup.shed"] == 1


def _catchup_fail(pkg):
    service, _loader = _service_with_doc(pkg, sets=3)
    injector = pkg.FaultInjector(pkg.FaultPlan(seed=1, points=(
        pkg.FaultPoint("catchup.fail", "fail", at=1),)))
    server = pkg.OrderingServer(service, catchup_max_inflight=1,
                                clock=pkg.VirtualClock(), faults=injector)
    with pytest.raises(OSError):
        server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    # the lease was released by the finally and no flight is stranded
    assert server.admission_control.snapshot()["inflight"] == 0
    assert server._catchup.cache._flights == {}
    out = server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    assert injector.unfired() == []
    return {"out": out, "faults": injector.snapshot(),
            "admission": server.admission.snapshot(),
            "control": server.admission_control.snapshot()}


def test_catchup_fail_releases_slot_and_caller_retries():
    got = run_both(_catchup_fail)
    assert got["out"]["lane"] == "fold"
    assert got["faults"] == {"catchup.fail:fail": 1}


def _catchup_slow(pkg):
    clock = pkg.VirtualClock()
    service, _loader = _service_with_doc(pkg, sets=3)
    injector = pkg.FaultInjector(pkg.FaultPlan(seed=1, points=(
        pkg.FaultPoint("catchup.slow", "delay", at=1, arg=3.0),)))
    server = pkg.OrderingServer(service, catchup_max_inflight=1,
                                clock=clock, faults=injector)
    out = server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    control = server.admission_control.snapshot()
    _append_op(pkg, service)
    server.admission_control.admit()
    with pytest.raises(pkg.NackError) as exc_info:
        server._dispatch(Session(), "catchup", {"docs": ["doc"]})
    return {"out": out, "faults": injector.snapshot(), "control": control,
            "retry_after": exc_info.value.retry_after}


def test_catchup_slow_raises_measured_cost_and_pacing():
    got = run_both(_catchup_slow)
    assert got["control"]["cost_ema"] > 1.0
    assert got["retry_after"] > 1.0


# -- the port's main() in a subprocess ---------------------------------------


def _spawn(port, *args, env=None):
    """The port's standalone server; waits (bounded) for its listening
    line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.server",
         "--port", str(port), *args], cwd=REPO,
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 60
    seen = []
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        seen.append(line)
        if "listening" in line:
            return proc
        if line == "" and proc.poll() is not None:
            break
    proc.kill()
    proc.wait(timeout=10)
    raise AssertionError(f"server never reported listening: {seen}")


def _end(proc):
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _type_and_catch_up(port, doc_id, n):
    factory = PORT.NetworkDocumentServiceFactory(port=port)
    try:
        c = PORT.Loader(factory).create(
            doc_id, "alice",
            lambda rt: rt.create_datastore("ds").create_channel(
                "sequence-tpu", "t"))
        type_text(c, n, factory, doc_id, channel="t")
        head = quiesce(factory, doc_id, c)
        text = c.runtime.get_datastore("ds").get_channel("t").text
        out = factory._rpc.request("catchup", {"docs": [doc_id]})
        assert out["docs"][doc_id][1] == head
        c.close()  # stamps the writer's LEAVE past the folded head
        return factory._rpc.request("head", {"doc": doc_id}), text, out
    finally:
        factory.close()


def test_main_cpu_device_with_dir_survives_restart(tmp_path):
    port = free_port()
    proc = _spawn(port, "--device", "cpu", "--dir", str(tmp_path))
    try:
        head, text, out = _type_and_catch_up(port, "persisted", 12)
        assert out["deviceDocs"] == 1 and out["cpuDocs"] == 0
        handle, seq = out["docs"]["persisted"]
    finally:
        _end(proc)
    proc = _spawn(port, "--device", "cpu", "--dir", str(tmp_path))
    factory = PORT.NetworkDocumentServiceFactory(port=port)
    try:
        assert factory._rpc.request("head", {"doc": "persisted"}) == head
        latest = factory._rpc.request("latest_summary",
                                      {"doc": "persisted"})
        assert (latest["handle"], latest["ref_seq"]) == (handle, seq)
        fresh = PORT.Loader(factory).resolve("persisted")
        assert fresh.catchup_ops == head - seq  # the LEAVE
        assert fresh.runtime.get_datastore("ds").get_channel("t").text \
            == text
        fresh.close()
    finally:
        factory.close()
        _end(proc)


def test_main_with_shards_answers_create_submit_catchup():
    port = free_port()
    proc = _spawn(port, "--device", "cpu", "--shards", "2")
    try:
        head, text, out = _type_and_catch_up(port, "sharded", 6)
        assert text == "a" * 6
        assert out["lane"] == "fold" and out["deviceDocs"] == 1
        assert out["docs"]["sharded"][1] == head - 1  # before the LEAVE
    finally:
        _end(proc)


def test_main_without_device_refuses_to_start_without_cuda(tmp_path):
    """The default device is the card: with no CUDA device visible the
    server exits at start, naming it, and creates nothing."""
    proc = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.server",
         "--port", str(free_port()), "--dir", str(tmp_path / "d")],
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "listening" not in proc.stdout
    assert not (tmp_path / "d").exists()


def test_server_without_device_raises_at_construction(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.server.OrderingServer(PORT.LocalOrderingService())
