"""The port's async front door against the JAX package's: twins of
tests/test_frontdoor_async.py (all but the two replica-death swarm
drills, which need ``testing/scenarios.py``).

1. Pump mechanics: incremental ``[len][json]`` reassembly over arbitrary
   chunk boundaries, a live event-loop echo with pipelined frames, and
   the relay-budget contract of one ``PumpConnection``.
2. The direct-to-shard path on thread-backend shards: clients resolve
   placement through the door's ``locate`` and tap the owning shard host
   itself (the door's relay counter stays at zero), and ride a shard
   failover by re-resolving through the door.

Each scenario runs on both packages (``torch_proc.run_both``) and the
records must be equal; every wait is bounded.
"""

import json
import socket
import struct

import pytest

from tests.torch_proc import run_both, wait_until


# -- 1. pump mechanics --------------------------------------------------------


def test_frame_parser_reassembles_across_arbitrary_chunks():
    def scenario(pkg):
        frames = [b"a", b"bb" * 10, json.dumps({"k": 1}).encode()]
        wire = b"".join(struct.pack(">I", len(f)) + f for f in frames)
        parser = pkg.framepump.FrameParser()
        out = []
        for i in range(0, len(wire), 3):  # dribble in 3-byte chunks
            out.extend(parser.feed(wire[i:i + 3]))
        assert out == frames
        parser = pkg.framepump.FrameParser()
        many = parser.feed(wire + struct.pack(">I", 5) + b"xy")
        assert many == frames
        tail = parser.feed(b"z" * 3)
        assert tail == [b"xyzzz"]
        return out, many, tail

    run_both(scenario)


def test_frame_parser_rejects_oversized_frame():
    def scenario(pkg):
        parser = pkg.framepump.FrameParser()
        with pytest.raises(ValueError) as err:
            parser.feed(struct.pack(">I", pkg.wire.MAX_FRAME + 1))
        return str(err.value)

    run_both(scenario)


def test_frame_pump_echo_round_trip_pipelined():
    """One event-loop thread owns accept + read + write: pipelined
    requests on one socket all come back (matched by ``re``), and the
    pump counts the accept."""
    def scenario(pkg):
        def echo(conn, frame):
            conn.send_obj({"re": frame["id"], "echo": frame["params"]})

        pump = pkg.framepump.FramePump("127.0.0.1", 0, echo).start()
        try:
            with socket.create_connection(("127.0.0.1", pump.port),
                                          timeout=10) as sock:
                for rid in range(8):  # pipelined: all writes first
                    sock.sendall(pkg.wire.frame_bytes(
                        {"v": pkg.wire.WIRE_VERSION, "id": rid,
                         "params": {"n": rid}}))
                parser, got = pkg.framepump.FrameParser(), []
                while len(got) < 8:
                    got.extend(json.loads(p) for p in parser.feed(
                        sock.recv(64 << 10)))
            assert sorted(f["re"] for f in got) == list(range(8))
            assert all(f["echo"] == {"n": f["re"]} for f in got)
            assert pump.accepted == 1
            return sorted(got, key=lambda f: f["re"])
        finally:
            pump.close()

    run_both(scenario)


def test_pump_connection_relay_budget_contract():
    """A frame larger than the whole budget is still accepted into an
    EMPTY queue, the next frame over budget is refused (the caller
    demotes), and priority control frames are budget-exempt."""
    def scenario(pkg):
        pump = pkg.framepump.FramePump("127.0.0.1", 0, lambda c, f: None)
        a, b = socket.socketpair()
        try:
            conn = pkg.framepump.PumpConnection(a, pump, relay_budget=8)
            record = [conn.relay(b"x" * 64), conn.relay(b"y")]
            conn.relay_priority(b"demoted!")
            record.append(conn.relay_pending())
            assert record == [True, False, 64]
            return record
        finally:
            a.close()
            b.close()
            pump.close()

    run_both(scenario)


# -- 2. direct-to-shard -----------------------------------------------------------


def _op(pkg, client, i):
    return pkg.RawOperation(client_id=client, client_seq=i + 1, ref_seq=0,
                            type=pkg.MessageType.OP, contents={"i": i})


def test_direct_to_shard_pins_door_out_of_byte_path(tmp_path):
    """A ``direct=True`` driver resolves placement through the door's
    ``locate`` and taps the owning shard host itself: every event
    arrives while both doors' relay counter stays at zero; killing the
    replica the control plane rides fails the client over to the other
    door, the data path untouched."""
    def scenario(pkg):
        base = str(tmp_path / pkg.name / "proc")
        door = pkg.FrontDoor(base, n_shards=2, spawn="thread",
                             request_timeout=5.0).start()
        rep = pkg.FrontDoor(base, spawn="attach",
                            attach_addrs=door.shard_addrs(),
                            request_timeout=5.0).start()
        factory = None
        try:
            factory = pkg.NetworkDocumentServiceFactory(
                port=rep.port, replicas=[("127.0.0.1", door.port)],
                direct=True)
            service = factory.create_document(
                "d-1", pkg.ContainerRuntime().summarize())
            endpoint = service.connection()
            got = []
            endpoint.subscribe(lambda m: got.append(m.seq))
            endpoint.connect("c1")
            for i in range(5):
                endpoint.submit(_op(pkg, "c1", i))
            assert wait_until(lambda: len(got) >= 6)  # 5 ops + the JOIN
            assert door.counters.get("fd.events") == 0
            assert rep.counters.get("fd.events") == 0
            assert factory._direct_rpcs["d-1"].shard is not None
            rep.kill()
            assert service.storage.latest()[0] is not None
            assert factory._rpc.request("ping", {}) == "pong"
            assert factory._rpc.failovers == 1
            return sorted(set(got))
        finally:
            if factory is not None:
                factory.close()
            if not rep.killed:
                rep.close()
            door.close()

    assert run_both(scenario) == list(range(1, 7))


def test_direct_client_rides_shard_failover_via_re_resolution(tmp_path):
    """The owning shard dies mid-session: the direct client's next call
    hits the fence, re-resolves through the door and lands on the
    adopting shard; the tap follows and the log stays contiguous."""
    def scenario(pkg):
        door = pkg.FrontDoor(str(tmp_path / pkg.name / "proc"), n_shards=2,
                             spawn="thread", request_timeout=5.0).start()
        factory = None
        try:
            factory = pkg.NetworkDocumentServiceFactory(port=door.port,
                                                        direct=True)
            service = factory.create_document(
                "d-1", pkg.ContainerRuntime().summarize())
            endpoint = service.connection()
            got = []
            endpoint.subscribe(lambda m: got.append(m.seq))
            endpoint.connect("c1")
            for i in range(3):
                endpoint.submit(_op(pkg, "c1", i))
            assert wait_until(lambda: len(got) >= 4)
            owner = factory._direct_rpcs["d-1"].shard
            assert owner is not None
            door.fail_shard(owner)
            for i in range(3, 6):
                endpoint.submit(_op(pkg, "c1", i))
            assert wait_until(lambda: len(got) >= 7), f"only {len(got)}"
            assert factory._direct_rpcs["d-1"].shard != owner
            assert factory._direct_rpcs["d-1"].failovers >= 1
            assert door.contiguous(["d-1"]) == {"d-1": True}
            assert door.counters.get("fd.events") == 0
            return {"owner": owner, "seqs": sorted(set(got)),
                    "head": door.heads(["d-1"])}
        finally:
            if factory is not None:
                factory.close()
            door.close()

    got = run_both(scenario)
    assert got["seqs"] == list(range(1, 8))
