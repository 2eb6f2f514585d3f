"""The wire error-code registry's round trip on the port, against the JAX
package's: twins of tests/test_error_taxonomy.py.

Every registered code is provoked on both packages — frame and nack codes
over a real TCP ``OrderingServer`` (the port's with ``device="cpu"``),
outcome codes through the shard host's codec and the process client's
decoder — and must surface as the declared exception, unretried in
place; the record of each provocation (exception class name, code,
pacing, handler calls, retries) must be equal on the two packages.
"""

import builtins
import json
import socket
import threading

import pytest

from tests.torch_proc import PORT, REF, run_both


def _real_exception(pkg, name):
    """The live class a registry row names, wherever it is defined."""
    for mod in (pkg.net, pkg.messages, pkg.retry):
        cls = getattr(mod, name, None)
        if cls is not None:
            return cls
    return getattr(builtins, name)


class _CaptureLogger:
    def __init__(self):
        self.events = []

    def send(self, event):
        self.events.append(dict(event))


def _provoke(pkg, handler_body, *, drain=False):
    """One real TCP request the server answers with a code: ``(exception,
    handler calls, client)``; the client carries a live RetryPolicy, so a
    code that WOULD be resent in place shows up as calls > 1."""
    srv = pkg.OrderingServer(port=0)
    calls = {"n": 0}

    def handler(session, params):
        calls["n"] += 1
        return handler_body(session, params)

    srv.extra_methods["provoke"] = handler
    thread = srv.start_in_thread()
    if drain:
        srv.draining = True
    logger = _CaptureLogger()
    rpc = pkg.net._RpcClient(
        "127.0.0.1", srv.port, timeout=10.0,
        mc=pkg.telemetry.MonitoringContext(logger=logger),
        retry=pkg.retry.RetryPolicy(max_attempts=4, base_delay=0.0,
                                    budget=1.0))
    try:
        with pytest.raises(Exception) as excinfo:
            rpc.request("provoke", {})
    finally:
        rpc.close()
        srv.loop.call_soon_threadsafe(srv._server.close)
        thread.join(timeout=10)
    return excinfo.value, calls["n"], rpc


def _raiser(make_exc):
    return lambda session, params: (_ for _ in ()).throw(make_exc())


def _kill_transport(session, params):
    # Die without answering: the client's reader drains every waiter with
    # the "connectionLost" frame the driver itself produces.
    session.writer.transport.abort()
    return True


def _frame(code, make_exc):
    def run(pkg):
        exc, calls, rpc = _provoke(pkg, _raiser(lambda: make_exc(pkg)))
        want = _real_exception(pkg, pkg.errors.spec(code)["exception"])
        assert type(exc) is want, (code, exc)
        assert calls == 1, f"{code} was resent in place ({calls} calls)"
        assert rpc.retry_counters.get("retry.retries") == 0
        return type(exc).__name__, getattr(exc, "code", None), calls
    return run


def _nack(code, *, drain=False):
    def run(pkg):
        body = (None if drain else _raiser(lambda: pkg.messages.NackError(
            f"refused:{code}", retry_after=0.125, code=code)))
        exc, calls, rpc = _provoke(pkg, body or (lambda s, p: True),
                                   drain=drain)
        want = _real_exception(pkg, pkg.errors.spec(code)["exception"])
        assert type(exc) is want, (code, exc)
        assert exc.code == code
        assert exc.retry_after > 0.0
        if not drain:
            assert calls == 1, f"{code} was resent in place"
        assert rpc.retry_counters.get("retry.retries") == 0
        return type(exc).__name__, exc.code, calls
    return run


def _outcome(code, make_error):
    def run(pkg):
        wire = pkg.outcome_wire(pkg.SubmitOutcome(
            stamped=[], consumed=1, error=make_error(pkg)))
        assert wire["code"] == code
        out = pkg.decode_outcome(wire)
        assert isinstance(out.error, ConnectionError)
        assert f"[{code}]" in str(out.error)
        return wire, type(out.error).__name__, str(out.error)
    return run


def _shard_dead(pkg):
    # Produced by the front door (a dead shard's whole submit answers
    # with this shape), decoded by the same adapter path.
    wire = {"stamped": 0, "consumed": 0,
            "error": "shard shard00 died mid-submit", "code": "shardDead"}
    out = pkg.decode_outcome(wire)
    assert isinstance(out.error, ConnectionError)
    assert "[shardDead]" in str(out.error)
    return type(out.error).__name__, str(out.error)


def _connection_lost(pkg):
    exc, calls, rpc = _provoke(pkg, _kill_transport)
    assert type(exc) is pkg.net.ConnectionLostError
    assert calls == 1, "a dead socket must never be resent in place"
    assert rpc.retry_counters.get("retry.retries") == 0
    return type(exc).__name__, calls


PROVOKERS = {
    # frame channel
    "epochMismatch": _frame(
        "epochMismatch", lambda pkg: pkg.server.EpochMismatch("gen-a",
                                                              "gen-b")),
    "shardFenced": _frame(
        "shardFenced",
        lambda pkg: pkg.messages.ShardFencedError("doc-1", "shard fenced")),
    "wrongShard": _frame(
        "wrongShard",
        lambda pkg: pkg.messages.DocRelocatedError("doc-1",
                                                   "moved to shard01")),
    "internal": _frame("internal", lambda pkg: RuntimeError("handler fault")),
    "connectionLost": _connection_lost,
    # nack channel
    "throttled": _nack("throttled"),
    "staleView": _nack("staleView"),
    "overloaded": _nack("overloaded"),
    # shuttingDown takes the REAL drain refusal, not a synthetic raise
    "shuttingDown": _nack("shuttingDown", drain=True),
    # outcome channel
    "fenced": _outcome(
        "fenced", lambda pkg: pkg.messages.ShardFencedError("doc-1",
                                                            "fenced")),
    "unknownDoc": _outcome("unknownDoc", lambda pkg: KeyError("no-such-doc")),
    "fault": _outcome("fault", lambda pkg: RuntimeError("append fault")),
    "shardDead": _shard_dead,
}


def test_provokers_cover_exactly_the_registry():
    assert set(PORT.errors.codes()) == set(REF.errors.codes())
    assert set(PROVOKERS) == set(PORT.errors.codes()), (
        "every registered wire code needs a provoker (and every provoker "
        "a registered code): %r"
        % sorted(set(PROVOKERS) ^ set(PORT.errors.codes())))


@pytest.mark.parametrize("code", sorted(REF.errors.codes()))
def test_registered_code_round_trips_as_declared(code):
    """Provoking the code against a real server or codec surfaces the
    declared exception type on both packages, never resent in place."""
    assert PORT.errors.spec(code) == REF.errors.spec(code)
    run_both(PROVOKERS[code])


def test_exception_table_matches_real_hierarchy():
    def scenario(pkg):
        errors = pkg.errors
        for name, row in errors.EXCEPTIONS.items():
            cls = _real_exception(pkg, name)
            assert isinstance(cls, type) and issubclass(cls, BaseException)
            for ancestor in errors.ancestors(name):
                assert issubclass(cls, _real_exception(pkg, ancestor)), (
                    name, ancestor)
        assert "RpcTransportError" in errors.ancestors("ConnectionLostError")
        assert errors.exception_spec(
            "ConnectionLostError")["retry"] == "reconnect"
        return {name: errors.ancestors(name) for name in errors.EXCEPTIONS}

    run_both(scenario)


def test_outcome_decode_tags_unregistered_codes():
    def scenario(pkg):
        out = pkg.decode_outcome({"stamped": 0, "consumed": 0,
                                  "error": "who knows",
                                  "code": "mysteryOutcome"})
        assert "[unregistered:mysteryOutcome]" in str(out.error)
        return str(out.error)

    run_both(scenario)


# -- unknown-code hardening -----------------------------------------------------


class _ScriptedPeer:
    """A TCP peer speaking the frame protocol but answering every request
    with ONE crafted frame, then closing; every wait is bounded."""

    def __init__(self, pkg, make_response):
        self._pkg = pkg
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self._srv.settimeout(20.0)
        self.port = self._srv.getsockname()[1]
        self._make = make_response
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _recv_exact(self, conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _run(self):
        LEN = self._pkg.wire.LEN
        try:
            conn, _ = self._srv.accept()
        except OSError:
            self._srv.close()
            return
        conn.settimeout(20.0)
        try:
            while True:
                hdr = self._recv_exact(conn, LEN.size)
                if hdr is None:
                    return
                payload = self._recv_exact(conn, LEN.unpack(hdr)[0])
                req = json.loads(payload)
                conn.sendall(self._pkg.wire.frame_bytes(self._make(req)))
        except OSError:
            pass
        finally:
            conn.close()
            self._srv.close()


def _scripted_request(pkg, make_response):
    peer = _ScriptedPeer(pkg, make_response)
    logger = _CaptureLogger()
    rpc = pkg.net._RpcClient(
        "127.0.0.1", peer.port, timeout=10.0,
        mc=pkg.telemetry.MonitoringContext(logger=logger),
        retry=pkg.retry.RetryPolicy(max_attempts=4, base_delay=0.0,
                                    budget=1.0))
    try:
        with pytest.raises(Exception) as excinfo:
            rpc.request("anything", {})
    finally:
        rpc.close()
        peer.thread.join(timeout=20)
    return excinfo.value, rpc, logger.events


def _unknown(channel, response, code):
    def scenario(pkg):
        exc, rpc, events = _scripted_request(pkg, response)
        assert type(exc) is pkg.net.UnknownWireCodeError
        assert not isinstance(exc, pkg.messages.NackError)
        assert exc.channel == channel and exc.code == code
        assert rpc.retry_counters.get("rpc.unknown_code") == 1
        assert rpc.retry_counters.get("retry.retries") == 0
        assert any(e.get("eventName", "").endswith("unknownWireCode")
                   and e.get("channel") == channel for e in events)
        return exc.channel, exc.code, str(exc)
    return scenario


def test_nack_without_code_is_loud_typed_and_unretried():
    run_both(_unknown("nack", lambda req: {
        "v": 1, "re": req["id"], "ok": False, "error": "busy",
        "nack": {"retryAfter": 0.5, "reason": "busy"}}, None))


def test_nack_with_unregistered_code_is_loud_typed_and_unretried():
    run_both(_unknown("nack", lambda req: {
        "v": 1, "re": req["id"], "ok": False, "error": "busy",
        "nack": {"retryAfter": 0.5, "reason": "busy",
                 "code": "mysteryPacing"}}, "mysteryPacing"))


def test_frame_with_unregistered_code_is_loud_typed_and_unretried():
    run_both(_unknown("frame", lambda req: {
        "v": 1, "re": req["id"], "ok": False, "error": "??",
        "code": "fluxCapacitor"}, "fluxCapacitor"))


def test_codeless_error_frame_still_raises_plain_rpc_error():
    """A bare ``{"ok": false, "error": ...}`` frame (no code at all) is
    legacy-compatible: plain RpcError, not the unknown-code path."""
    def scenario(pkg):
        exc, rpc, _ = _scripted_request(pkg, lambda req: {
            "v": 1, "re": req["id"], "ok": False, "error": "plain refusal"})
        assert type(exc) is pkg.net.RpcError
        assert rpc.retry_counters.get("rpc.unknown_code") == 0
        return str(exc)

    run_both(scenario)
