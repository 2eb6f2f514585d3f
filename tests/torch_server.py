"""Shared harness for the port's server, streaming-fold and sharding tests
(tests/test_torch_streamfold.py, test_torch_server.py,
test_torch_sharding.py).

``REF`` and ``PORT`` name the same classes in the two packages, so one
scenario function runs against either: ``scenario(pkg)`` builds its
corpus with ``pkg``'s modules, drives it, and returns a record of what
it observed (poll results, ``stats()`` dicts, op-log floors, RPC
answers).  ``run_both(scenario)`` runs it on both packages and asserts
the two records equal.  The reference's catch-up service runs with
``mesh=None`` (under the tests' virtual 8-device CPU mesh its default
would fold on a doc mesh, while the port folds on its one device); the
port's runs with ``device="cpu"``.

Every wait here is bounded: servers run on daemon threads and are
closed through their loop, clients quiesce by polling the delta
storage's head against their ``ref_seq`` with a deadline.
"""

import random
import socket
import time
import types

import fluidframework_tpu.drivers as ref_drivers
import fluidframework_tpu.drivers.network_driver as ref_net
import fluidframework_tpu.loader as ref_loader
import fluidframework_tpu.protocol.messages as ref_messages
import fluidframework_tpu.runtime.container as ref_container
import fluidframework_tpu.runtime.registry as ref_registry
import fluidframework_tpu.service.catchup as ref_catchup
import fluidframework_tpu.service.catchup_cache as ref_cache
import fluidframework_tpu.service.oplog as ref_oplog
import fluidframework_tpu.service.orderer as ref_orderer
import fluidframework_tpu.service.retry as ref_retry
import fluidframework_tpu.service.server as ref_server
import fluidframework_tpu.service.sharding as ref_sharding
import fluidframework_tpu.service.streamfold as ref_streamfold
import fluidframework_tpu.testing.faults as ref_faults
import fluidframework_tpu.testing.load as ref_load
import fluidframework_tpu.utils.telemetry as ref_telemetry
import fluidframework_tpu_torch.drivers as port_drivers
import fluidframework_tpu_torch.drivers.network_driver as port_net
import fluidframework_tpu_torch.loader as port_loader
import fluidframework_tpu_torch.protocol.messages as port_messages
import fluidframework_tpu_torch.runtime.container as port_container
import fluidframework_tpu_torch.runtime.registry as port_registry
import fluidframework_tpu_torch.service.catchup as port_catchup
import fluidframework_tpu_torch.service.catchup_cache as port_cache
import fluidframework_tpu_torch.service.oplog as port_oplog
import fluidframework_tpu_torch.service.orderer as port_orderer
import fluidframework_tpu_torch.service.retry as port_retry
import fluidframework_tpu_torch.service.server as port_server
import fluidframework_tpu_torch.service.sharding as port_sharding
import fluidframework_tpu_torch.service.streamfold as port_streamfold
import fluidframework_tpu_torch.testing.faults as port_faults
import fluidframework_tpu_torch.testing.load as port_load
import fluidframework_tpu_torch.utils.telemetry as port_telemetry


def _pkg(name, messages, container, registry, catchup, cache, oplog,
         orderer, retry, server, sharding, streamfold, faults, telemetry,
         drivers, net, loader, load, catchup_kw):
    def make_catchup(service, **kw):
        return catchup.CatchupService(service, **catchup_kw, **kw)

    def make_server(service=None, **kw):
        srv = server.OrderingServer(service, **kw, **(
            {"device": "cpu"} if name == "port" else {}))
        # The reference's lazy CatchupService would take mesh="auto"
        # (a doc mesh under the tests' virtual devices): pin it to the
        # single-device fold both packages share.
        srv._catchup = make_catchup(srv.service, mc=srv.mc)
        return srv

    def make_mc(**settings):
        return telemetry.MonitoringContext(
            config=telemetry.ConfigProvider(settings))

    return types.SimpleNamespace(
        name=name, MessageType=messages.MessageType,
        RawOperation=messages.RawOperation, NackError=messages.NackError,
        ShardFencedError=messages.ShardFencedError,
        ContainerRuntime=container.ContainerRuntime,
        default_registry=registry.default_registry,
        CatchupServiceClass=catchup.CatchupService,
        RetryPolicy=retry.RetryPolicy,
        LockedCounterSet=telemetry.LockedCounterSet, mc=make_mc,
        AdmissionController=server.AdmissionController,
        LocalDocumentServiceFactory=drivers.LocalDocumentServiceFactory,
        FileSummaryStorage=drivers.FileSummaryStorage,
        CatchupService=make_catchup, StreamHeadIndex=cache.StreamHeadIndex,
        TruncatedRangeError=oplog.TruncatedRangeError, OpLog=oplog.OpLog,
        LocalOrderingService=orderer.LocalOrderingService,
        DocumentOrderer=orderer.DocumentOrderer,
        OrderingServer=make_server, server=server,
        ShardRouter=sharding.ShardRouter,
        ShardedOrderingService=sharding.ShardedOrderingService,
        StreamFoldService=streamfold.StreamFoldService,
        FaultInjector=faults.FaultInjector, FaultPlan=faults.FaultPlan,
        FaultPoint=faults.FaultPoint, VirtualClock=load.VirtualClock,
        NetworkDocumentServiceFactory=net.NetworkDocumentServiceFactory,
        Loader=loader.Loader)


REF = _pkg("ref", ref_messages, ref_container, ref_registry, ref_catchup,
           ref_cache, ref_oplog, ref_orderer, ref_retry, ref_server,
           ref_sharding, ref_streamfold, ref_faults, ref_telemetry,
           ref_drivers, ref_net, ref_loader, ref_load, {"mesh": None})
PORT = _pkg("port", port_messages, port_container, port_registry,
            port_catchup, port_cache, port_oplog, port_orderer, port_retry,
            port_server, port_sharding, port_streamfold, port_faults,
            port_telemetry, port_drivers, port_net, port_loader, port_load,
            {"device": "cpu"})


def run_both(scenario, *args):
    """The scenario's record on each package; asserts them equal and
    returns the port's."""
    want = scenario(REF, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# -- corpora -----------------------------------------------------------------


def seed_tree(pkg):
    rt = pkg.ContainerRuntime()
    rt.create_datastore("ds").create_channel("sequence-tpu", "text")
    return rt.summarize()


def service_with_docs(pkg, n_docs=2, oplog=None, service=None):
    """Documents ``sf-00`` … each seeded with one sequence channel."""
    if service is None:
        service = pkg.LocalOrderingService(oplog=oplog)
    tree = seed_tree(pkg)
    ids = []
    for i in range(n_docs):
        doc_id = f"sf-{i:02d}"
        service.storage.upload(doc_id, tree, 0)
        service.create_document(doc_id)
        ids.append(doc_id)
    return service, ids


def type_ops(pkg, service, doc_id, n, client="c1"):
    """Submit n single-char inserts through the real endpoint."""
    ep = service.endpoint(doc_id)
    if client not in ep._orderer.sequencer._slots:
        ep.connect(client)  # the JOIN takes one sequence number
    ref = service.oplog.head(doc_id)
    start = 0
    for msg in service.oplog.get(doc_id):
        if msg.client_id == client:
            start = max(start, msg.client_seq)
    for i in range(n):
        msg = ep.submit(pkg.RawOperation(
            client_id=client, client_seq=start + i + 1, ref_seq=ref,
            type=pkg.MessageType.OP,
            contents={"type": "groupedBatch", "ops": [
                {"ds": "ds", "channel": "text",
                 "clientSeq": start + i + 1,
                 "contents": {"kind": "insert", "pos": 0, "text": "a"}}]},
        ))
        ref = msg.seq
    return ref


def oplog_record(service, doc_ids):
    """Each document's head and floor, and the log's reclaimed bytes."""
    oplog = service.oplog
    return {"heads": {d: oplog.head(d) for d in doc_ids},
            "floors": {d: oplog.floor(d) for d in doc_ids},
            "bytes_reclaimed": int(getattr(oplog, "bytes_reclaimed", 0))}


# -- TCP servers and clients -------------------------------------------------


class Session:
    """The in-proc stand-in for a TCP session (``_dispatch`` callers)."""
    client_id = "storm"
    authenticated = True
    tenant = None


def start(server):
    """Start an in-thread server; returns it (port bound)."""
    server._thread = server.start_in_thread()
    assert server.port, "server never bound its port"
    return server


def stop(server):
    """Close an in-thread server's listener and wait for its thread."""
    loop, listener = server.loop, server._server
    if loop is not None and listener is not None and not loop.is_closed():
        loop.call_soon_threadsafe(listener.close)
    thread = getattr(server, "_thread", None)
    if thread is not None:
        thread.join(timeout=10)


def free_port():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def quiesce(factory, doc_id, *containers, timeout=20.0):
    """Drain each container until its ref_seq reaches the server's head
    for ``doc_id`` (bounded); returns that head."""
    storage = factory.resolve(doc_id).delta_storage
    deadline = time.time() + timeout
    while True:
        head = storage.head()
        for c in containers:
            c.drain()
        if all(c.runtime.ref_seq == head for c in containers) and \
                storage.head() == head:
            return head
        if time.time() > deadline:
            raise AssertionError(
                f"{doc_id}: clients at "
                f"{[c.runtime.ref_seq for c in containers]}, head {head}")
        time.sleep(0.01)


# -- live clients ------------------------------------------------------------

#: the mixed datastore of the reference's service tests: every kernel
#: family plus a host channel (the counter folds on the host).
MIXED_CHANNELS = (("sequence-tpu", "text"), ("map-tpu", "kv"),
                  ("matrix-tpu", "grid"), ("tree-tpu", "tree"),
                  ("counter-tpu", "clicks"))


def build_mixed(rt):
    ds = rt.create_datastore("ds")
    for type_name, channel_id in MIXED_CHANNELS:
        ds.create_channel(type_name, channel_id)


def type_mixed(container, seed, rounds, factory, doc_id):
    """One writer's scripted edits over the mixed channels, one sequenced
    message each: the container drains after every edit and waits for
    its own op to come back before the next (so each op's ref_seq is
    the head, not a race with the broadcast), and the same script
    stamps the same log on either package."""
    rng = random.Random(seed)
    ds = container.runtime.get_datastore("ds")
    for i in range(rounds):
        roll = rng.random()
        if roll < 0.3:
            t = ds.get_channel("text")
            n = len(t.text)
            if n < 4 or rng.random() < 0.7:
                t.insert_text(rng.randint(0, n), "xy"[i % 2] * 2)
            else:
                s = rng.randint(0, n - 2)
                t.remove_range(s, min(n, s + 2))
        elif roll < 0.5:
            ds.get_channel("kv").set(f"k{rng.randint(0, 5)}",
                                     rng.randint(0, 99))
        elif roll < 0.7:
            m = ds.get_channel("grid")
            if m.row_count == 0 or rng.random() < 0.4:
                m.insert_rows(rng.randint(0, m.row_count), 1)
            elif m.col_count == 0 or rng.random() < 0.6:
                m.insert_cols(rng.randint(0, m.col_count), 1)
            else:
                m.set_cell(rng.randint(0, m.row_count - 1),
                           rng.randint(0, m.col_count - 1),
                           rng.randint(0, 99))
        elif roll < 0.9:
            tr = ds.get_channel("tree")
            kids = tr.children("", "a")  # "" is the tree's root id
            if not kids or rng.random() < 0.7:
                tr.insert("", "a", rng.randint(0, len(kids)),
                          [tr.build("n", value=rng.randint(0, 9))])
            else:
                tr.set_value(rng.choice(kids), rng.randint(0, 99))
        else:
            ds.get_channel("clicks").increment(1)
        container.drain()
        quiesce(factory, doc_id, container)


def type_text(container, n, factory, doc_id, channel="text"):
    """n single-char appends to a sequence channel, one message each,
    each sequenced before the next (as :func:`type_mixed`)."""
    text = container.runtime.get_datastore("ds").get_channel(channel)
    for _ in range(n):
        text.insert_text(len(text.text), "a")
        container.drain()
        quiesce(factory, doc_id, container)


def timing_free(stats):
    """A ``stats`` RPC answer without what differs run to run: the
    storage epoch (random per store) and the measured fold-cost EMA."""
    out = dict(stats)
    out.pop("epoch", None)
    out["admissionControl"] = {k: v for k, v in
                               out["admissionControl"].items()
                               if k != "cost_ema"}
    return out
