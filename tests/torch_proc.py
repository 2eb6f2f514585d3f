"""Shared harness for the port's out-of-process tier tests
(tests/test_torch_fluidproc.py, test_torch_error_taxonomy.py,
test_torch_frontdoor_async.py).

``REF`` and ``PORT`` name the same classes and functions in the two
packages, so one scenario function runs against either; ``run_both``
runs it on both and asserts the two records equal.  The port's front
door, shard hosts and servers run with ``device="cpu"`` (shard
processes with ``--device cpu``).  Every wait here is bounded.
"""

import time
import types

import fluidframework_tpu.drivers.network_driver as ref_net
import fluidframework_tpu.protocol.errors as ref_errors
import fluidframework_tpu.protocol.messages as ref_messages
import fluidframework_tpu.protocol.wire as ref_wire
import fluidframework_tpu.runtime.container as ref_container
import fluidframework_tpu.service.framepump as ref_framepump
import fluidframework_tpu.service.frontdoor as ref_frontdoor
import fluidframework_tpu.service.oplog as ref_oplog
import fluidframework_tpu.service.orderer as ref_orderer
import fluidframework_tpu.service.procclient as ref_procclient
import fluidframework_tpu.service.retry as ref_retry
import fluidframework_tpu.service.server as ref_server
import fluidframework_tpu.service.shardhost as ref_shardhost
import fluidframework_tpu.service.sharding as ref_sharding
import fluidframework_tpu.testing.faults as ref_faults
import fluidframework_tpu.utils.telemetry as ref_telemetry
import fluidframework_tpu_torch.drivers.network_driver as port_net
import fluidframework_tpu_torch.protocol.errors as port_errors
import fluidframework_tpu_torch.protocol.messages as port_messages
import fluidframework_tpu_torch.protocol.wire as port_wire
import fluidframework_tpu_torch.runtime.container as port_container
import fluidframework_tpu_torch.service.framepump as port_framepump
import fluidframework_tpu_torch.service.frontdoor as port_frontdoor
import fluidframework_tpu_torch.service.oplog as port_oplog
import fluidframework_tpu_torch.service.orderer as port_orderer
import fluidframework_tpu_torch.service.procclient as port_procclient
import fluidframework_tpu_torch.service.retry as port_retry
import fluidframework_tpu_torch.service.server as port_server
import fluidframework_tpu_torch.service.shardhost as port_shardhost
import fluidframework_tpu_torch.service.sharding as port_sharding
import fluidframework_tpu_torch.testing.faults as port_faults
import fluidframework_tpu_torch.utils.telemetry as port_telemetry


def _pkg(name, net, errors, messages, wire, container, framepump,
         frontdoor, oplog, orderer, procclient, retry, server, shardhost,
         sharding, faults, telemetry):
    dev = {"device": "cpu"} if name == "port" else {}

    def front_door(base_dir, **kw):
        return frontdoor.FrontDoor(base_dir, **kw, **dev)

    def proc_shard(shard_id, base_dir, **kw):
        return frontdoor.ProcShard(shard_id, base_dir, **kw, **dev)

    def shard_server(host, **kw):
        return shardhost.ShardHostServer(host, **kw, **dev)

    def ordering_server(service=None, **kw):
        return server.OrderingServer(service, **kw, **dev)

    return types.SimpleNamespace(
        name=name, net=net, errors=errors, messages=messages, wire=wire,
        server=server, retry=retry, telemetry=telemetry, faults=faults,
        framepump=framepump,
        FrontDoor=front_door, ProcShard=proc_shard,
        MigrationAborted=frontdoor.MigrationAborted,
        ShardHost=shardhost.ShardHost, ShardHostServer=shard_server,
        OrderingServer=ordering_server, outcome_wire=shardhost._outcome_wire,
        decode_outcome=procclient._decode_outcome,
        ContainerRuntime=container.ContainerRuntime,
        LocalOrderingService=orderer.LocalOrderingService,
        SubmitOutcome=orderer.SubmitOutcome,
        shard_log_path=oplog.shard_log_path,
        rendezvous_score=sharding.rendezvous_score,
        RawOperation=messages.RawOperation, MessageType=messages.MessageType,
        NackError=messages.NackError,
        DocRelocatedError=messages.DocRelocatedError,
        RpcClient=net._RpcClient,
        NetworkDocumentServiceFactory=net.NetworkDocumentServiceFactory,
        encode_raw_operation=wire.encode_raw_operation,
        encode_sequenced_message=wire.encode_sequenced_message)


REF = _pkg("ref", ref_net, ref_errors, ref_messages, ref_wire, ref_container,
           ref_framepump, ref_frontdoor, ref_oplog, ref_orderer,
           ref_procclient, ref_retry, ref_server, ref_shardhost,
           ref_sharding, ref_faults, ref_telemetry)
PORT = _pkg("port", port_net, port_errors, port_messages, port_wire,
            port_container, port_framepump, port_frontdoor, port_oplog,
            port_orderer, port_procclient, port_retry, port_server,
            port_shardhost, port_sharding, port_faults, port_telemetry)


def run_both(scenario, *args):
    """The scenario's record on each package; asserts them equal and
    returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def op(pkg, client, i, ref):
    return pkg.RawOperation(client_id=client, client_seq=i + 1, ref_seq=ref,
                            type=pkg.MessageType.OP, contents={"i": i})


def drive_tier(pkg, door, docs, n_ops, start=0, refs=None, progress=None,
               deadline_s=120.0):
    """Submit ``n_ops`` ops per doc through the front door (one logical
    writer per doc), riding failovers with a bounded retry loop (ten
    attempts an op, and one deadline for the whole drive).
    ``progress`` (a one-element list) exposes the completed op index to
    a concurrent killer."""
    refs = refs if refs is not None else {}
    deadline = time.monotonic() + deadline_s
    factory = pkg.NetworkDocumentServiceFactory(port=door.port)
    rpc = factory._rpc
    try:
        if start == 0:
            for d in docs:
                rpc.request("create_document", {"doc": d})
                rpc.request("connect", {"doc": d, "client": f"w-{d}"})
                refs[d] = rpc.request("head", {"doc": d})
        for i in range(start, start + n_ops):
            for d in docs:
                for _attempt in range(10):
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{d}: drive past its deadline")
                    try:
                        result = rpc.request("submit", {
                            "doc": d,
                            "op": pkg.encode_raw_operation(
                                op(pkg, f"w-{d}", i, refs[d]))})
                        if result is None:
                            # A deduped resend: the first attempt landed
                            # before the kill; read the head back.
                            refs[d] = rpc.request("head", {"doc": d})
                        else:
                            refs[d] = result["sequenceNumber"]
                        break
                    except (ConnectionError, OSError, pkg.NackError):
                        time.sleep(0.05)
                else:
                    raise AssertionError(f"{d}: op {i} never landed")
            if progress is not None:
                progress[0] = i
    finally:
        factory.close()
    return refs


def oracle_logs(pkg, docs, n_ops):
    """The fault-free single-service oracle: the same per-doc op streams
    through ONE in-proc orderer; returns ``{doc: wire dicts}``."""
    service = pkg.LocalOrderingService()
    out = {}
    for d in docs:
        endpoint = service.create_document(d)
        endpoint.connect(f"w-{d}")
        ref = endpoint.head_seq
        for i in range(n_ops):
            ref = endpoint.submit(op(pkg, f"w-{d}", i, ref)).seq
        out[d] = [pkg.encode_sequenced_message(m) for m in endpoint.deltas()]
    return out


def tier_logs(door, docs):
    return {d: door._forward_doc("deltas", {"doc": d}) for d in docs}


def both_oracles(docs, n_ops):
    """Both packages' oracle logs, asserted equal."""
    want = oracle_logs(REF, docs, n_ops)
    assert oracle_logs(PORT, docs, n_ops) == want
    return want


def wait_until(predicate, timeout=10.0, step=0.02):
    """Poll ``predicate`` until it holds or ``timeout`` seconds pass."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(step)
    return predicate()
