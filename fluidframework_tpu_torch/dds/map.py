"""SharedMap / SharedDirectory — the LWW key-value merge engines.

Capability-equivalent of the reference's map package (SURVEY.md §2.2:
``SharedMap``/``MapKernel``/``SharedDirectory``; upstream paths UNVERIFIED —
empty reference mount).

Merge semantics (documented in SEMANTICS.md §map):

- Sequenced ops apply in total order; set/delete are last-writer-wins because
  later ops simply overwrite.
- Optimistic local reads: a pending local op on a key will be sequenced with a
  *larger* seq than any op arriving before its ack, so it wins — therefore
  remote ops on keys with pending local ops are **not** applied to the local
  view (pending-key tracking, the reference's MapKernel pattern).  The same
  argument applies to a pending ``clear``.
- ``clear`` empties sequenced state; pending local sets survive (they will
  re-populate when sequenced).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .shared_object import SharedObject


class MapKernel:
    """The LWW kernel shared by SharedMap and each SharedDirectory node.

    This is the logic the ``ops.map_kernel`` TPU path replays in bulk: final
    value per key = the op with the maximum seq for that key, with deletes and
    clears masking earlier sets.
    """

    def __init__(self) -> None:
        self.data: Dict[str, Any] = {}
        self._pending_keys: Dict[str, int] = {}
        self._pending_clears = 0

    # -- local (optimistic) ----------------------------------------------------

    def local_set(self, key: str, value: Any, attached: bool) -> None:
        self.data[key] = value
        if attached:
            self._pending_keys[key] = self._pending_keys.get(key, 0) + 1

    def local_delete(self, key: str, attached: bool) -> bool:
        existed = key in self.data
        self.data.pop(key, None)
        if attached:
            self._pending_keys[key] = self._pending_keys.get(key, 0) + 1
        return existed

    def local_clear(self, attached: bool) -> None:
        self.data.clear()
        if attached:
            self._pending_clears += 1
            self._pending_keys.clear()

    # -- sequenced -------------------------------------------------------------

    def process(self, op: dict, local: bool) -> bool:
        """Apply one sequenced op; returns True when the op changed the
        *visible* state (False for local acks and for remote ops masked by
        pending local ops) — the event-emission signal."""
        kind = op["kind"]
        if kind == "clear":
            if local:
                if self._pending_clears > 0:
                    self._pending_clears -= 1
                    return False  # already applied optimistically
                # Pending hold lost to a kernel reset (subdir delete/recreate
                # sequenced under the in-flight clear): apply like a remote op.
            elif self._pending_clears > 0:
                return False  # our pending clear will win (larger seq)
            # Remote clear: drop sequenced state; keep keys with pending local
            # ops (those will be re-established when our ops sequence).
            survivors = {
                k: v for k, v in self.data.items() if self._pending_keys.get(k, 0) > 0
            }
            self.data = survivors
            return True

        key = op["key"]
        if local:
            n = self._pending_keys.get(key, 0)
            if n > 0:
                # Ack of our own op: value already applied; release the hold.
                if n == 1:
                    self._pending_keys.pop(key, None)
                else:
                    self._pending_keys[key] = n - 1
                return False
            if self._pending_clears > 0:
                return False  # our later clear wiped the hold; it outranks
            # No pending hold: the kernel was reset underneath the in-flight
            # op (e.g. its subdirectory was deleted and recreated).  The op is
            # still the latest writer in sequence order — apply it like a
            # remote op so every replica converges.
        elif self._pending_clears > 0 or self._pending_keys.get(key, 0) > 0:
            return False  # a pending local op outranks this remote op
        if kind == "set":
            self.data[key] = op["value"]
        elif kind == "delete":
            self.data.pop(key, None)
        else:
            raise ValueError(f"unknown map op kind {kind!r}")
        return True

    # -- summary ---------------------------------------------------------------

    def summary_obj(self) -> dict:
        return {"data": self.data}

    def load_obj(self, obj: dict) -> None:
        self.data = dict(obj["data"])
        self._pending_keys.clear()
        self._pending_clears = 0


class SharedMap(SharedObject):
    """Flat LWW key-value DDS."""

    TYPE = "map-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._kernel = MapKernel()

    # -- public API ------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._kernel.data.get(key, default)

    def has(self, key: str) -> bool:
        return key in self._kernel.data

    def keys(self):
        return self._kernel.data.keys()

    def __len__(self) -> int:
        return len(self._kernel.data)

    def set(self, key: str, value: Any) -> None:
        existed = key in self._kernel.data
        prev = self._kernel.data.get(key)
        self._kernel.local_set(key, value, self.is_attached)
        self._submit_local_op({"kind": "set", "key": key, "value": value})
        self._emit("valueChanged",
                   {"key": key, "previousValue": prev,
                    "previousExisted": existed}, local=True)

    def delete(self, key: str) -> bool:
        existed = key in self._kernel.data
        prev = self._kernel.data.get(key)
        self._kernel.local_delete(key, self.is_attached)
        self._submit_local_op({"kind": "delete", "key": key})
        if existed:
            self._emit("valueChanged",
                       {"key": key, "previousValue": prev,
                        "previousExisted": True}, local=True)
        return existed

    def clear(self) -> None:
        self._kernel.local_clear(self.is_attached)
        self._submit_local_op({"kind": "clear"})
        self._emit("clear", local=True)

    def apply_stashed_op(self, contents) -> None:
        kind = contents["kind"]
        if kind == "set":
            self.set(contents["key"], contents["value"])
        elif kind == "delete":
            self.delete(contents["key"])
        elif kind == "clear":
            self.clear()
        else:
            raise ValueError(f"unknown stashed map op {kind!r}")

    # -- SharedObject ----------------------------------------------------------

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        op = msg.contents
        key = op.get("key")
        existed = key in self._kernel.data if key is not None else False
        prev = self._kernel.data.get(key) if key is not None else None
        applied = self._kernel.process(op, local)
        if local or not applied:
            return  # optimistic apply already emitted / masked by pending
        if op["kind"] == "clear":
            self._emit("clear", local=False)
        else:
            self._emit("valueChanged",
                       {"key": key, "previousValue": prev,
                        "previousExisted": existed}, local=False)

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json(self._kernel.summary_obj()))
        return tree

    def load(self, summary: SummaryTree) -> None:
        import json

        self._kernel.load_obj(json.loads(summary.blob_bytes("header")))
        self.discard_pending()


class SubDirectory:
    """One node of a SharedDirectory: a MapKernel plus named children."""

    def __init__(self) -> None:
        self.kernel = MapKernel()
        self.children: Dict[str, "SubDirectory"] = {}

    def resolve(self, path: str, create: bool = False) -> Optional["SubDirectory"]:
        node = self
        for part in [p for p in path.split("/") if p]:
            child = node.children.get(part)
            if child is None:
                if not create:
                    return None
                child = SubDirectory()
                node.children[part] = child
            node = child
        return node

    def summary_obj(self) -> dict:
        return {
            "data": self.kernel.data,
            "subdirs": {k: v.summary_obj() for k, v in sorted(self.children.items())},
        }

    def load_obj(self, obj: dict) -> None:
        self.kernel.load_obj(obj)
        self.children = {}
        for name, sub in obj.get("subdirs", {}).items():
            child = SubDirectory()
            child.load_obj(sub)
            self.children[name] = child


class SharedDirectory(SharedObject):
    """Hierarchical LWW key-value DDS: a tree of SubDirectories, each with its
    own MapKernel.  Ops carry an absolute path."""

    TYPE = "directory-tpu"
    REBASE_POSITION_FREE = True

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self._root = SubDirectory()

    # -- public API ------------------------------------------------------------

    @property
    def root(self) -> SubDirectory:
        return self._root

    def get(self, key: str, path: str = "/", default: Any = None) -> Any:
        node = self._root.resolve(path)
        return default if node is None else node.kernel.data.get(key, default)

    def set(self, key: str, value: Any, path: str = "/") -> None:
        node = self._root.resolve(path, create=True)
        node.kernel.local_set(key, value, self.is_attached)
        self._submit_local_op(
            {"kind": "set", "path": path, "key": key, "value": value}
        )

    def delete(self, key: str, path: str = "/") -> None:
        node = self._root.resolve(path, create=True)
        node.kernel.local_delete(key, self.is_attached)
        self._submit_local_op({"kind": "delete", "path": path, "key": key})

    def clear(self, path: str = "/") -> None:
        node = self._root.resolve(path, create=True)
        node.kernel.local_clear(self.is_attached)
        self._submit_local_op({"kind": "clear", "path": path})

    def create_subdirectory(self, path: str) -> None:
        self._root.resolve(path, create=True)
        self._submit_local_op({"kind": "createSubdir", "path": path})

    def delete_subdirectory(self, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError("cannot delete root")
        parent = self._root.resolve("/".join(parts[:-1]))
        if parent is not None:
            parent.children.pop(parts[-1], None)
        self._submit_local_op({"kind": "deleteSubdir", "path": path})

    # -- SharedObject ----------------------------------------------------------

    def apply_stashed_op(self, contents) -> None:
        kind = contents["kind"]
        if kind == "set":
            self.set(contents["key"], contents["value"], contents["path"])
        elif kind == "delete":
            self.delete(contents["key"], contents["path"])
        elif kind == "clear":
            self.clear(contents["path"])
        elif kind == "createSubdir":
            self.create_subdirectory(contents["path"])
        elif kind == "deleteSubdir":
            self.delete_subdirectory(contents["path"])
        else:
            raise ValueError(f"unknown stashed directory op {kind!r}")

    def _process_core(self, msg: SequencedMessage, local: bool, _meta) -> None:
        op = msg.contents
        kind = op["kind"]
        if kind == "createSubdir":
            # Idempotent create; both local and remote paths converge.
            self._root.resolve(op["path"], create=True)
            return
        if kind == "deleteSubdir":
            # Applied on both the local ack and the remote path (idempotent):
            # a concurrent createSubdir sequenced before this delete must be
            # deleted again on the deleting replica for convergence.
            parts = [p for p in op["path"].split("/") if p]
            parent = self._root.resolve("/".join(parts[:-1]))
            if parent is not None:
                parent.children.pop(parts[-1], None)
            return
        node = self._root.resolve(op["path"], create=True)
        node.kernel.process(op, local)

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        tree = SummaryTree()
        tree.add_blob("header", canonical_json(self._root.summary_obj()))
        return tree

    def load(self, summary: SummaryTree) -> None:
        import json

        self._root = SubDirectory()
        self._root.load_obj(json.loads(summary.blob_bytes("header")))
        self.discard_pending()
