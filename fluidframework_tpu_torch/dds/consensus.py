"""Consensus-style DDSes: ordered collection, register collection, task
manager.

Capability-equivalent of the reference's ``ordered-collection``
(ConsensusQueue), ``register-collection`` (ConsensusRegisterCollection) and
``task-manager`` packages (SURVEY.md §2.2; upstream paths UNVERIFIED —
empty reference mount).  Unlike the optimistic DDSes, these are
**pessimistic**: a mutation takes effect only when its op is *sequenced* —
nothing is applied optimistically, so every client transitions state at the
same fold position and the sequencer's total order IS the consensus.

These are control-plane structures (work distribution, election, versioned
configuration): their op volume is tiny, so they ride the CPU fold path and
are deliberately not device-kernel targets — the device budget goes to the
content-bearing DDSes (SURVEY.md §7).

Design notes vs the reference:
- ConsensusQueue.acquire(): the reference returns a promise resolved at
  sequencing; here acquire() submits and returns a ticket id — after
  drain(), ``acquired`` holds what this client holds (same protocol, pull
  instead of push).
- Quorum LEAVE handling: items held by (tasks assigned to) a departed
  client re-queue automatically, driven by the sequenced LEAVE — identical
  on every client.  The runtime routes non-OP messages to channels via
  ``observe_protocol`` (see ContainerRuntime.process).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .shared_object import SharedObject


class ConsensusQueue(SharedObject):
    """Ordered work queue with acquire/complete semantics (at-least-once
    hand-off: a held item whose holder leaves returns to the front)."""

    TYPE = "ordered-collection-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._items: List[list] = []       # [id, value] FIFO
        self._held: Dict[str, list] = {}   # item_id -> [value, holder_client]
        self._next_item = 0

    # -- reads -----------------------------------------------------------------

    @property
    def items(self) -> List[Any]:
        return [v for _i, v in self._items]

    @property
    def held_by_me(self) -> Dict[str, Any]:
        return {i: v for i, (v, holder) in self._held.items()
                if holder == self.client_id}

    def holder_of(self, item_id: str) -> Optional[str]:
        entry = self._held.get(item_id)
        return entry[1] if entry else None

    def __len__(self) -> int:
        return len(self._items)

    # -- writes (sequenced-only: no optimistic apply) --------------------------

    def add(self, value: Any) -> None:
        self._submit_local_op({"kind": "add", "value": value})

    def acquire(self) -> None:
        """Ask for the queue head; after the op sequences (drain), the item
        appears in ``held_by_me`` — or nothing does, if the queue was empty
        by then."""
        self._submit_local_op({"kind": "acquire"})

    def complete(self, item_id: str) -> None:
        self._submit_local_op({"kind": "complete", "id": item_id})

    def release(self, item_id: str) -> None:
        self._submit_local_op({"kind": "release", "id": item_id})

    # -- sequenced fold --------------------------------------------------------

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        op = msg.contents
        kind = op["kind"]
        if kind == "add":
            self._items.append([f"item-{self._next_item}", op["value"]])
            self._next_item += 1
        elif kind == "acquire":
            if self._items:
                item_id, value = self._items.pop(0)
                self._held[item_id] = [value, msg.client_id]
        elif kind == "complete":
            self._held.pop(op["id"], None)
        elif kind == "release":
            entry = self._held.pop(op["id"], None)
            if entry is not None:
                self._items.insert(0, [op["id"], entry[0]])
        else:
            raise ValueError(f"unknown queue op {kind!r}")

    def observe_protocol(self, msg: SequencedMessage) -> None:
        """Sequenced LEAVE: everything the departed client held re-queues at
        the front (deterministic: same fold position on every client)."""
        if msg.type is not MessageType.LEAVE:
            return
        gone = msg.contents["clientId"]
        requeue = [(i, v) for i, (v, holder) in self._held.items()
                   if holder == gone]
        for item_id, value in sorted(requeue):
            del self._held[item_id]
            self._items.insert(0, [item_id, value])

    def apply_stashed_op(self, contents) -> None:
        # Pessimistic DDS: nothing was applied locally; re-submit verbatim.
        self._submit_local_op(dict(contents))

    # -- summary ---------------------------------------------------------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json({
            "items": self._items,
            "held": {k: self._held[k] for k in sorted(self._held)},
            "next": self._next_item,
        }))
        return tree

    def load(self, summary: SummaryTree) -> None:
        obj = json.loads(summary.blob_bytes("header"))
        self._items = [list(x) for x in obj["items"]]
        self._held = {k: list(v) for k, v in obj["held"].items()}
        self._next_item = obj["next"]
        self.discard_pending()


class ConsensusRegisterCollection(SharedObject):
    """Versioned registers: concurrent writes all survive as versions until
    a later write supersedes them (its ref_seq has seen them)."""

    TYPE = "register-collection-tpu"

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        # key -> list of [value, seq] versions, oldest first
        self._registers: Dict[str, List[list]] = {}

    def _resubmit_rebased(self, pending) -> None:
        """Registers carry no positions, but ``ref_seq`` IS semantic here:
        it records which versions the writer had observed (the supersede
        filter in _process_core).  Re-pinning it to the current view would
        silently supersede concurrent versions the author never saw, so a
        stale resubmit keeps the *original* ref_seq — out-of-window is
        harmless because the fold never resolves a view, it only compares
        sequence numbers."""
        for _old_client_seq, contents, metadata, ref_seq in pending:
            self._resubmit_core(contents, metadata, ref_seq)

    # -- reads -----------------------------------------------------------------

    def read(self, key: str, default: Any = None) -> Any:
        """Atomic read: the first (winning) version — first write in total
        order among still-concurrent writes."""
        versions = self._registers.get(key)
        return versions[0][0] if versions else default

    def read_versions(self, key: str) -> List[Any]:
        return [v for v, _seq in self._registers.get(key, [])]

    def keys(self):
        return self._registers.keys()

    # -- writes ----------------------------------------------------------------

    def write(self, key: str, value: Any) -> None:
        self._submit_local_op({"kind": "write", "key": key, "value": value})

    # -- sequenced fold --------------------------------------------------------

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        op = msg.contents
        if op["kind"] != "write":
            raise ValueError(f"unknown register op {op['kind']!r}")
        versions = self._registers.setdefault(op["key"], [])
        # Versions this write has already observed are superseded.
        versions[:] = [v for v in versions if v[1] > msg.ref_seq]
        versions.append([op["value"], msg.seq])

    def apply_stashed_op(self, contents) -> None:
        self._submit_local_op(dict(contents))

    # -- summary ---------------------------------------------------------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json(
            {k: self._registers[k] for k in sorted(self._registers)}
        ))
        return tree

    def load(self, summary: SummaryTree) -> None:
        obj = json.loads(summary.blob_bytes("header"))
        self._registers = {k: [list(v) for v in vs] for k, vs in obj.items()}
        self.discard_pending()


class TaskManager(SharedObject):
    """Exclusive task assignment: clients volunteer for a task id; the
    first in the sequenced volunteer queue holds the task; abandoning or
    leaving passes it down the queue."""

    TYPE = "task-manager-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._queues: Dict[str, List[str]] = {}  # task -> client queue

    # -- reads -----------------------------------------------------------------

    def assigned_to(self, task_id: str) -> Optional[str]:
        queue = self._queues.get(task_id)
        return queue[0] if queue else None

    def assigned_to_me(self, task_id: str) -> bool:
        return (self.client_id is not None
                and self.assigned_to(task_id) == self.client_id)

    def queued(self, task_id: str) -> List[str]:
        return list(self._queues.get(task_id, []))

    # -- writes ----------------------------------------------------------------

    def volunteer(self, task_id: str) -> None:
        self._submit_local_op({"kind": "volunteer", "task": task_id})

    def abandon(self, task_id: str) -> None:
        self._submit_local_op({"kind": "abandon", "task": task_id})

    def complete(self, task_id: str) -> None:
        """The assignee marks the task done: the whole queue clears (the
        reference's task completion semantics)."""
        self._submit_local_op({"kind": "complete", "task": task_id})

    # -- sequenced fold --------------------------------------------------------

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        op = msg.contents
        kind = op["kind"]
        queue = self._queues.setdefault(op["task"], [])
        if kind == "volunteer":
            if msg.client_id not in queue:
                queue.append(msg.client_id)
        elif kind == "abandon":
            if msg.client_id in queue:
                queue.remove(msg.client_id)
        elif kind == "complete":
            if queue and queue[0] == msg.client_id:
                queue.clear()
        else:
            raise ValueError(f"unknown task op {kind!r}")
        if not queue:
            del self._queues[op["task"]]

    def observe_protocol(self, msg: SequencedMessage) -> None:
        if msg.type is not MessageType.LEAVE:
            return
        gone = msg.contents["clientId"]
        for task_id in sorted(self._queues):
            queue = self._queues[task_id]
            if gone in queue:
                queue.remove(gone)
            if not queue:
                del self._queues[task_id]

    def apply_stashed_op(self, contents) -> None:
        self._submit_local_op(dict(contents))

    # -- summary ---------------------------------------------------------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json(
            {k: self._queues[k] for k in sorted(self._queues)}
        ))
        return tree

    def load(self, summary: SummaryTree) -> None:
        self._queues = {
            k: list(v)
            for k, v in json.loads(summary.blob_bytes("header")).items()
        }
        self.discard_pending()
