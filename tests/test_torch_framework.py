"""The port's framework layer (``fluidframework_tpu_torch.framework``)
against the JAX package's: twins of the 14 tests of
tests/test_framework.py (FluidClient / FluidContainer, DataObject, DDS
events, presence over signals, undo-redo).

Each scenario runs on both packages with its reference test's own
assertions and returns a record: every container's summary digest,
the texts and values the clients see, and the event sequences the
handlers recorded; the two records must be equal.
"""

import types

import pytest

import fluidframework_tpu.drivers as ref_drivers
import fluidframework_tpu.framework as ref_framework
import fluidframework_tpu.service as ref_service
import fluidframework_tpu_torch.drivers as port_drivers
import fluidframework_tpu_torch.framework as port_framework
import fluidframework_tpu_torch.service as port_service


def _pkg(drivers, framework, service):
    class TodoList(framework.DataObject):
        CHANNELS = {"items": "map-tpu", "title": "cell-tpu"}

        def initialize_first_time(self):
            self.title.set("untitled")

    schema = framework.ContainerSchema(initial_objects={
        "notes": "sequence-tpu",
        "votes": "map-tpu",
        "tally": "counter-tpu",
    })
    return types.SimpleNamespace(
        fw=framework, schema=schema, TodoList=TodoList,
        LocalOrderingService=service.LocalOrderingService,
        LocalDocumentServiceFactory=drivers.LocalDocumentServiceFactory)


REF = _pkg(ref_drivers, ref_framework, ref_service)
PORT = _pkg(port_drivers, port_framework, port_service)


def run_both(scenario):
    want = scenario(REF)
    got = scenario(PORT)
    assert got == want
    return got


def make_clients(pkg, n=2, doc_id="doc"):
    service = pkg.LocalOrderingService()
    client = pkg.fw.FluidClient(pkg.LocalDocumentServiceFactory(service))
    first = client.create_container(doc_id, pkg.schema)
    rest = [client.get_container(doc_id, pkg.schema) for _ in range(n - 1)]
    return service, [first] + rest


def sync(containers):
    for c in containers:
        c.sync()


def digests(*containers):
    return [c._container.runtime.summarize().digest() for c in containers]


def test_exports_match_the_reference():
    assert port_framework.__all__ == ref_framework.__all__


# --- FluidClient / FluidContainer ---------------------------------------------


def test_create_and_get_container_with_initial_objects():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        assert set(a.initial_objects) == {"notes", "votes", "tally"}
        a.initial_objects["notes"].insert_text(0, "hello")
        b.initial_objects["votes"].set("q1", "yes")
        b.initial_objects["tally"].increment(3)
        sync([a, b])
        assert b.initial_objects["notes"].text == "hello"
        assert a.initial_objects["votes"].get("q1") == "yes"
        assert a.initial_objects["tally"].value == 3
        assert a.connected and b.connected
        return digests(a, b), a.client_id, b.client_id

    run_both(scenario)


def test_dynamic_channel_creation():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        extra = a.create_channel("map-tpu", "extra")
        extra.set("k", 1)
        sync([a, b])
        b_extra = b._container.runtime.get_datastore(
            "initial-objects").get_channel("extra")
        assert b_extra.get("k") == 1
        return digests(a, b)

    run_both(scenario)


# --- DataObject ---------------------------------------------------------------


def test_data_object_create_and_load():
    def scenario(pkg):
        service = pkg.LocalOrderingService()
        client = pkg.fw.FluidClient(pkg.LocalDocumentServiceFactory(service))
        a = client.create_container("doc", pkg.schema)
        factory = pkg.fw.DataObjectFactory(pkg.TodoList)
        todo = factory.create(a._container.runtime, "todo")
        assert todo.title.get() == "untitled"
        todo.items.set("buy-milk", {"done": False})
        a.sync()
        b = client.get_container("doc", pkg.schema)
        todo_b = factory.load(b._container.runtime, "todo")
        assert todo_b.items.get("buy-milk") == {"done": False}
        assert todo_b.title.get() == "untitled"
        return digests(a, b)

    run_both(scenario)


def test_offline_dynamic_creation_survives_reconnect():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        a._container.disconnect()
        rt = a._container.runtime
        ds = rt.create_datastore("offline-ds")
        ch = ds.create_channel("map-tpu", "data")
        ch.set("k", 42)
        blob_handle = rt.blob_manager.create_blob(b"offline-blob")
        ch.set("file", blob_handle)
        a._container.reconnect()
        sync([a, b])
        b_rt = b._container.runtime
        assert "offline-ds" in b_rt.datastores
        b_ch = b_rt.get_datastore("offline-ds").get_channel("data")
        assert b_ch.get("k") == 42
        assert b_rt.blob_manager.get_blob(b_ch.get("file")) \
            == b"offline-blob"
        assert rt.summarize().digest() == b_rt.summarize().digest()
        return digests(a, b)

    run_both(scenario)


def test_conflicting_channel_attach_fails_loudly():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        a._container.runtime.get_datastore("initial-objects") \
            .create_channel("map-tpu", "clash")
        b._container.runtime.get_datastore("initial-objects") \
            .create_channel("counter-tpu", "clash")
        errors = []
        for c in (a, b):
            with pytest.raises(RuntimeError,
                               match="conflicting channelAttach") as err:
                c.sync()
            errors.append(str(err.value))
        return errors

    run_both(scenario)


# --- DDS events ---------------------------------------------------------------


def test_map_value_changed_events_local_and_remote():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        seen = []
        b.initial_objects["votes"].events.on(
            "valueChanged", lambda ev, local: seen.append((ev["key"], local)))
        a.initial_objects["votes"].set("x", 1)
        sync([a, b])
        b.initial_objects["votes"].set("y", 2)
        assert ("x", False) in seen
        assert ("y", True) in seen
        return seen, digests(a, b)

    run_both(scenario)


def test_op_reentrancy_guard():
    def scenario(pkg):
        _service, (a, _b) = make_clients(pkg)
        votes = a.initial_objects["votes"]
        votes.events.on("valueChanged",
                        lambda ev, local: votes.set("echo", 1))
        with pytest.raises(RuntimeError, match="re-entrancy") as err:
            votes.set("trigger", 0)
        return str(err.value)

    run_both(scenario)


def test_sequence_delta_events():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        deltas = []
        a.initial_objects["notes"].events.on(
            "sequenceDelta",
            lambda ev, local: deltas.append((ev["kind"], local)))
        a.initial_objects["notes"].insert_text(0, "abc")
        b.initial_objects["notes"].insert_text(0, "xyz")
        sync([a, b])
        assert ("insert", True) in deltas
        assert ("insert", False) in deltas
        return deltas, a.initial_objects["notes"].text, digests(a, b)

    run_both(scenario)


# --- presence -----------------------------------------------------------------


def test_presence_broadcast_and_late_joiner():
    def scenario(pkg):
        service, (a, b) = make_clients(pkg)
        pa = pkg.fw.Presence(a)
        pb = pkg.fw.Presence(b)
        pa.workspace("cursors").set_local("pos", 17)
        assert pb.workspace("cursors").get(a.client_id, "pos") == 17
        ops_before = service.oplog.head("doc")
        pa.workspace("cursors").set_local("pos", 18)
        assert service.oplog.head("doc") == ops_before
        client = pkg.fw.FluidClient(pkg.LocalDocumentServiceFactory(service))
        c = client.get_container("doc", pkg.schema)
        pc = pkg.fw.Presence(c)
        assert pc.workspace("cursors").get(a.client_id, "pos") == 18
        return ops_before, pb.workspace("cursors").get(a.client_id, "pos")

    run_both(scenario)


def test_presence_targeted_signal():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        got = []
        b.on_signal(lambda s: got.append(s))
        a.submit_signal({"ping": 1}, target_client_id=b.client_id)
        a.submit_signal({"ping": 2}, target_client_id="someone-else")
        pings = [s["content"]["ping"] for s in got
                 if s.get("targetClientId") in (b.client_id, None)
                 and "ping" in (s.get("content") or {})]
        assert 1 in pings and 2 not in pings
        return pings, got

    run_both(scenario)


# --- undo-redo ----------------------------------------------------------------


def test_undo_redo_map_and_counter():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        mgr = pkg.fw.UndoRedoStackManager()
        votes, tally = a.initial_objects["votes"], a.initial_objects["tally"]
        mgr.attach(votes)
        mgr.attach(tally)
        votes.set("k", "v1")
        votes.set("k", "v2")
        tally.increment(5)
        sync([a, b])
        steps = []
        assert mgr.undo()
        sync([a, b])
        assert tally.value == 0
        assert b.initial_objects["tally"].value == 0
        steps.append(digests(a, b))
        assert mgr.undo()
        sync([a, b])
        assert votes.get("k") == "v1"
        steps.append(digests(a, b))
        assert mgr.redo()
        sync([a, b])
        assert votes.get("k") == "v2"
        assert b.initial_objects["votes"].get("k") == "v2"
        steps.append(digests(a, b))
        return steps

    run_both(scenario)


def test_undo_string_insert_and_remove():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        mgr = pkg.fw.UndoRedoStackManager()
        notes = a.initial_objects["notes"]
        mgr.attach(notes)
        notes.insert_text(0, "hello world")
        notes.remove_range(5, 11)
        sync([a, b])
        assert notes.text == "hello"
        steps = [digests(a, b)]
        assert mgr.undo()
        sync([a, b])
        assert notes.text == "hello world"
        assert b.initial_objects["notes"].text == "hello world"
        steps.append(digests(a, b))
        assert mgr.undo()
        sync([a, b])
        assert notes.text == ""
        steps.append(digests(a, b))
        assert mgr.redo()
        sync([a, b])
        assert notes.text == "hello world"
        steps.append(digests(a, b))
        return steps

    run_both(scenario)


def test_undo_grouped_operation():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        mgr = pkg.fw.UndoRedoStackManager()
        votes = a.initial_objects["votes"]
        mgr.attach(votes)
        with mgr.operation():
            votes.set("a", 1)
            votes.set("b", 2)
            votes.set("c", 3)
        sync([a, b])
        assert mgr.undo()
        sync([a, b])
        assert votes.get("a") is None and votes.get("c") is None
        assert not mgr.can_undo
        return digests(a, b), mgr.can_redo

    run_both(scenario)


def test_undo_merges_with_concurrent_remote_edit():
    def scenario(pkg):
        _service, (a, b) = make_clients(pkg)
        mgr = pkg.fw.UndoRedoStackManager()
        notes_a = a.initial_objects["notes"]
        notes_b = b.initial_objects["notes"]
        mgr.attach(notes_a)
        notes_a.insert_text(0, "AAA ")
        sync([a, b])
        notes_b.insert_text(4, "BBB ")
        sync([a, b])
        assert notes_a.text == "AAA BBB "
        mgr.undo()
        sync([a, b])
        assert notes_a.text == notes_b.text == "BBB "
        return digests(a, b)

    run_both(scenario)
