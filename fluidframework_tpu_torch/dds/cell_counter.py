"""SharedCell and SharedCounter — the small DDSes.

Capability-equivalent of the reference's cell/counter packages (SURVEY.md
§2.2; upstream paths UNVERIFIED — empty reference mount).  SharedCell is a
single LWW register (pending-local-wins like the map kernel); SharedCounter is
a commutative increment counter (ops always apply — addition commutes, so no
pending masking is needed).
"""

from __future__ import annotations

import json
from typing import Any

from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .shared_object import SharedObject


class SharedCell(SharedObject):
    TYPE = "cell-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._value: Any = None
        self._empty = True
        self._pending_writes = 0

    def get(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        return self._empty

    def set(self, value: Any) -> None:
        prev = self._value
        self._value, self._empty = value, False
        if self.is_attached:
            self._pending_writes += 1
        self._submit_local_op({"kind": "set", "value": value})
        self._emit("valueChanged", {"previousValue": prev}, local=True)

    def delete(self) -> None:
        self._value, self._empty = None, True
        if self.is_attached:
            self._pending_writes += 1
        self._submit_local_op({"kind": "delete"})
        self._emit("delete", local=True)

    def apply_stashed_op(self, contents) -> None:
        kind = contents["kind"]
        if kind == "set":
            self.set(contents["value"])
        elif kind == "delete":
            self.delete()
        else:
            raise ValueError(f"unknown stashed cell op {kind!r}")

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        if local:
            self._pending_writes -= 1
            return
        if self._pending_writes > 0:
            return  # pending local write sequences later → wins
        op = msg.contents
        if op["kind"] == "set":
            prev = self._value
            self._value, self._empty = op["value"], False
            if not local:
                self._emit("valueChanged", {"previousValue": prev},
                           local=False)
        else:
            self._value, self._empty = None, True
            if not local:
                self._emit("delete", local=False)

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob(
            "header", canonical_json({"empty": self._empty, "value": self._value})
        )
        return tree

    def load(self, summary: SummaryTree) -> None:
        obj = json.loads(summary.blob_bytes("header"))
        self._empty, self._value = obj["empty"], obj["value"]
        self._pending_writes = 0
        self.discard_pending()


class SharedCounter(SharedObject):
    TYPE = "counter-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def increment(self, delta: int) -> None:
        if not isinstance(delta, int):
            raise TypeError("counter delta must be an integer")
        self._value += delta  # optimistic; increments commute
        self._submit_local_op({"kind": "increment", "delta": delta})
        self._emit("incremented", {"incrementAmount": delta,
                                   "newValue": self.value}, local=True)

    def apply_stashed_op(self, contents) -> None:
        self.increment(contents["delta"])

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        if local:
            return  # already counted optimistically
        self._value += msg.contents["delta"]
        self._emit("incremented",
                   {"incrementAmount": msg.contents["delta"],
                    "newValue": self._value}, local=False)

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json({"value": self._value}))
        return tree

    def load(self, summary: SummaryTree) -> None:
        self._value = json.loads(summary.blob_bytes("header"))["value"]
        self.discard_pending()
