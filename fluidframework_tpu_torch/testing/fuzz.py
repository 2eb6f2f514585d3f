"""The DDS fuzz harness — seeded eventual-consistency testing.

Capability-equivalent of the reference's DDS fuzz harness
(SURVEY.md §4: test-dds-utils + stochastic-test-utils): seeded op
generators drive N client replicas through random edits with random
partial delivery (interleaving exploration — the framework's real race
detector), periodically synchronizing and asserting all replicas
equivalent by state AND by canonical summary digest.  The same harness
drives CPU-oracle vs device-kernel equivalence: replay the generated op
log through the device path and compare digests.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional

from ..dds.shared_object import SharedObject
from .mocks import MockContainerRuntimeFactory

ALPHABET = "abcdefghijklmnopqrstuvwxyz"


class FuzzSpec:
    """Per-DDS-type fuzz behavior: how to build an instance, generate one
    random local edit, and snapshot comparable state."""

    #: weight of generating an op vs doing nothing in a step
    op_probability: float = 0.8

    def create(self, object_id: str) -> SharedObject:
        raise NotImplementedError

    def random_op(self, rng: random.Random, dds: SharedObject) -> None:
        raise NotImplementedError

    def observable(self, dds: SharedObject):
        """Human-readable converged-state projection (for failure messages)."""
        return None


class StringFuzzSpec(FuzzSpec):
    def __init__(self, annotate: bool = True, intervals: bool = False,
                 obliterate: bool = False) -> None:
        self.annotate = annotate
        self.intervals = intervals
        self.obliterate = obliterate

    def create(self, object_id: str) -> SharedObject:
        from ..dds.sequence import SharedString

        return SharedString(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        n = len(dds)
        r = rng.random()
        if self.intervals and r > 0.82 and n > 0:
            self._interval_op(rng, dds, n)
            return
        if r < 0.55 or n == 0:
            pos = rng.randint(0, n)
            text = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(1, 6)))
            dds.insert_text(pos, text)
        elif self.obliterate and r < 0.68:
            start = rng.randint(0, n - 1)
            dds.obliterate_range(start, min(n, start + rng.randint(1, 8)))
        elif r < 0.8 or not self.annotate:
            start = rng.randint(0, n - 1)
            dds.remove_range(start, min(n, start + rng.randint(1, 8)))
        else:
            start = rng.randint(0, n - 1)
            end = min(n, start + rng.randint(1, 8))
            dds.annotate_range(start, end, {rng.choice("xyz"): rng.randint(0, 3)})

    def _interval_op(self, rng: random.Random, dds, n: int) -> None:
        # Small shared id pool so concurrent add/change/delete conflict.
        interval_id = f"iv{rng.randint(0, 3)}"
        coll = dds.get_interval_collection()
        r = rng.random()
        start = rng.randint(0, n - 1)
        end = min(n - 1, start + rng.randint(0, 6))
        if r < 0.5 or coll.get(interval_id) is None:
            dds.add_interval(start, end, interval_id=interval_id,
                             props={"tag": rng.randint(0, 3)})
        elif r < 0.85:
            dds.change_interval(interval_id, start=start, end=end,
                                props={"tag": rng.randint(0, 3)})
        else:
            dds.delete_interval(interval_id)

    def observable(self, dds):
        ivs = {
            label: coll.summary_obj()
            for label, coll in dds._interval_collections.items()
        }
        return (dds.text, ivs)


class MapFuzzSpec(FuzzSpec):
    KEYS = [f"k{i}" for i in range(8)]

    def create(self, object_id: str) -> SharedObject:
        from ..dds.map import SharedMap

        return SharedMap(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        r = rng.random()
        key = rng.choice(self.KEYS)
        if r < 0.7:
            dds.set(key, rng.randint(0, 99))
        elif r < 0.95:
            dds.delete(key)
        else:
            dds.clear()

    def observable(self, dds):
        return dict(sorted(dds._kernel.data.items()))


class DirectoryFuzzSpec(FuzzSpec):
    PATHS = ["/", "a", "a/b", "c"]
    KEYS = [f"k{i}" for i in range(4)]

    def create(self, object_id: str) -> SharedObject:
        from ..dds.map import SharedDirectory

        return SharedDirectory(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        r = rng.random()
        path = rng.choice(self.PATHS)
        if r < 0.6:
            dds.set(rng.choice(self.KEYS), rng.randint(0, 99), path=path)
        elif r < 0.8:
            dds.delete(rng.choice(self.KEYS), path=path)
        elif r < 0.9:
            dds.create_subdirectory(rng.choice(["a", "a/b", "c", "d/e"]))
        else:
            dds.delete_subdirectory(rng.choice(["a/b", "c", "d/e"]))

    def observable(self, dds):
        return dds._root.summary_obj()


class RegisterFuzzSpec(FuzzSpec):
    """Consensus register collection: concurrent writes to a small key
    pool — version lists and winners must converge."""

    KEYS = [f"r{i}" for i in range(4)]

    def create(self, object_id: str) -> SharedObject:
        from ..dds.consensus import ConsensusRegisterCollection

        return ConsensusRegisterCollection(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        dds.write(rng.choice(self.KEYS), rng.randint(0, 99))

    def observable(self, dds):
        return {k: dds.read_versions(k) for k in sorted(dds.keys())}


class QueueFuzzSpec(FuzzSpec):
    """Consensus queue: adds racing acquire/complete/release — held items
    and remaining queue contents must converge (the acquire order is the
    total order, so every replica agrees who holds what)."""

    def create(self, object_id: str) -> SharedObject:
        from ..dds.consensus import ConsensusQueue

        return ConsensusQueue(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        r = rng.random()
        held = sorted(dds.held_by_me)
        if r < 0.45 or (len(dds) == 0 and not held):
            dds.add(rng.randint(0, 999))
        elif r < 0.75 and len(dds):
            dds.acquire()
        elif held and r < 0.9:
            dds.complete(rng.choice(held))
        elif held:
            dds.release(rng.choice(held))

    def observable(self, dds):
        return (dds.items, sorted(dds.held_by_me))


class MatrixFuzzSpec(FuzzSpec):
    """Random row/col structure edits + cell writes; optional FWW switch."""

    def __init__(self, fww: bool = False) -> None:
        self.fww = fww

    def create(self, object_id: str) -> SharedObject:
        from ..dds.matrix import SharedMatrix

        return SharedMatrix(object_id)

    def random_op(self, rng: random.Random, dds) -> None:
        rows, cols = dds.row_count, dds.col_count
        r = rng.random()
        if self.fww and dds.policy == "lww" and r > 0.97:
            dds.switch_policy("fww")
        elif r < 0.18 or rows == 0:
            dds.insert_rows(rng.randint(0, rows), rng.randint(1, 3))
        elif r < 0.3 or cols == 0:
            dds.insert_cols(rng.randint(0, cols), rng.randint(1, 3))
        elif r < 0.4 and rows > 1:
            start = rng.randint(0, rows - 1)
            dds.remove_rows(start, min(rows - start, rng.randint(1, 2)))
        elif r < 0.5 and cols > 1:
            start = rng.randint(0, cols - 1)
            dds.remove_cols(start, min(cols - start, rng.randint(1, 2)))
        else:
            dds.set_cell(
                rng.randint(0, rows - 1), rng.randint(0, cols - 1),
                rng.randint(0, 99),
            )

    def observable(self, dds):
        return dds.to_list()


def run_fuzz(
    spec: FuzzSpec,
    seed: int,
    n_clients: int = 3,
    rounds: int = 40,
    ops_per_client_round: int = 3,
    sync_every: int = 8,
    on_sync: Optional[Callable[[MockContainerRuntimeFactory, List[SharedObject]], None]] = None,
):
    """Drive N replicas through seeded random edits with random partial
    delivery; synchronize periodically and at the end, asserting convergence
    by canonical summary digest.  Returns ``(replicas, factory)`` so callers
    can replay ``factory.sequencer.log`` through a device kernel and compare
    digests."""
    rng = random.Random(seed)
    factory = MockContainerRuntimeFactory()
    replicas: List[SharedObject] = []
    for i in range(n_clients):
        client = factory.create_client(f"client{i}")
        replicas.append(client.attach(spec.create("fuzz")))

    def check_converged() -> None:
        digests = {r.summarize().digest() for r in replicas}
        if len(digests) != 1:
            states = [spec.observable(r) for r in replicas]
            raise AssertionError(
                f"divergence (seed={seed}): "
                + " | ".join(repr(s) for s in states)
            )

    for round_no in range(rounds):
        for replica in replicas:
            for _ in range(ops_per_client_round):
                if rng.random() < spec.op_probability:
                    spec.random_op(rng, replica)
        # Random partial delivery explores interleavings.
        factory.process_some_messages(rng.randint(0, factory.pending_count))
        if (round_no + 1) % sync_every == 0:
            factory.process_all_messages()
            check_converged()
            if rng.random() < 0.5:
                factory.advance_min_seq()  # exercise zamboni mid-run
            if on_sync is not None:
                on_sync(factory, replicas)
    factory.process_all_messages()
    check_converged()
    return replicas, factory
