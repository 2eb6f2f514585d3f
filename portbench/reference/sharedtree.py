"""The plain reference for SharedTree catch-up: replay the records, then
summarize.

A plain replay of a sequenced forest, written from the semantics of the
CPU oracle's ``apply_changeset`` (``dds/tree.py``) and its summary, that
reads the binary edit records itself (the layout of
``csrc/treepack.cpp``) and imports nothing of the system under test.

The forest maps node ids to nodes (type, value and its seq, insert seq,
tombstone seq, the (parent, field) holding it, and ordered child lists by
field).  Applying a message at ``seq``:

- **insert**: skipped when its parent is gone; the content is created
  (a node whose id exists already is not cloned) and spliced after the
  anchor when the anchor is in the destination field, else at the field
  start;
- **remove**: the first remover's seq tombstones the node;
- **set**: the value, and its seq the larger of the two;
- **move**: ids that exist, into a parent that exists, unless the parent
  lies inside a moved subtree (the move is dropped); detach, splice
  after the anchor (the field start when the anchor is gone or moved),
  restamp the insert seq;
- then the window: once ``min_seq`` passes a tombstone's seq the node is
  popped; its live (or in-window) children become detached limbo roots
  and its expired children pop with it.

The summary is the oracle's: the root's fields, sorted, of kept nodes (not
expired tombstones) as ``{id, type, insertSeq, value?, valueSeq?,
removedSeq?, fields?}`` with seqs at or below ``minSeq`` written as 0;
``limbo`` the kept detached roots and kept nodes under an unkept parent,
sorted by id; then ``minSeq`` and ``seq``; canonical JSON (sorted keys, no
spaces).

Departures from the oracle, none of which a record stream of the
benchmark's traffic reaches: no revive edits (the replay raises); no
attribution blob; no base summary (every document is caught up from
empty); a node spec's ``removedSeq`` is kept as given.

``replay(records, control=True)`` is the control: the same replica with
the last message left out, a summary one edit stale, which breaks the
guarantee that every sequenced edit is in the caught-up summary.
``replay(records, work=counter)`` also counts, for every move, the steps
the tree fold's ancestor walk takes: from the destination's parent up to
the root, at most ``MAX_DEPTH``.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

_HEADER = struct.Struct("<6id")
_I32 = struct.Struct("<i")
_ITEM = struct.Struct("<6i")
INSERT, REMOVE, SET, MOVE = 1, 2, 3, 4
VALUE_ABSENT, VALUE_NULL = -1, -2
REMOVED_ABSENT = -2 ** 31
ROOT = ""
#: the fold's ancestor-walk budget
MAX_DEPTH = 64


class _Node:
    __slots__ = ("id", "type", "value", "value_seq", "insert_seq",
                 "removed_seq", "parent", "fields")

    def __init__(self, nid: str, type_: str, value, seq: int,
                 removed: Optional[int], parent) -> None:
        self.id = nid
        self.type = type_
        self.value = value
        self.value_seq = max(seq, 0)
        self.insert_seq = seq
        self.removed_seq = removed
        self.parent = parent
        self.fields: Dict[str, List[str]] = {}


class Replica:
    """One document's sequenced forest."""

    def __init__(self, work=None) -> None:
        self.nodes: Dict[str, _Node] = {ROOT: _Node(ROOT, "", None, 0, None,
                                                    None)}
        self.seq = 0
        self.min_seq = 0
        self.work = work

    # -- structure ----------------------------------------------------------

    def _create(self, spec: dict, parent: str, field: str, seq: int) -> bool:
        if spec["id"] in self.nodes:
            return False
        node = _Node(spec["id"], spec["type"], spec.get("value"), seq,
                     spec.get("removedSeq"), (parent, field))
        self.nodes[node.id] = node
        for f, children in spec.get("fields", {}).items():
            for child in children:
                if self._create(child, node.id, f, seq):
                    node.fields.setdefault(f, []).append(child["id"])
        return True

    def _place(self, parent: str, field: str, anchor: Optional[str],
               ids: List[str]) -> None:
        sibs = self.nodes[parent].fields.setdefault(field, [])
        pos = 0
        if anchor is not None and anchor in sibs:
            pos = sibs.index(anchor) + 1
        sibs[pos:pos] = ids

    def _detach(self, nid: str) -> None:
        node = self.nodes[nid]
        if node.parent is None or node.parent[0] not in self.nodes:
            return
        sibs = self.nodes[node.parent[0]].fields.get(node.parent[1], [])
        if nid in sibs:
            sibs.remove(nid)

    def _inside(self, nid: str, root: str) -> bool:
        while nid is not None:
            if nid == root:
                return True
            node = self.nodes.get(nid)
            nid = node.parent[0] if node is not None and node.parent \
                else None
        return False

    def _walk_steps(self, owner: str) -> int:
        steps, nid = 0, owner
        while nid is not None and steps < MAX_DEPTH:
            steps += 1
            node = self.nodes.get(nid)
            nid = node.parent[0] if node is not None and node.parent \
                else None
        return steps

    # -- edits --------------------------------------------------------------

    def insert(self, parent: str, field: str, anchor: Optional[str],
               content: List[dict], seq: int) -> None:
        if parent not in self.nodes:
            return
        if anchor is not None and anchor not in self.nodes:
            anchor = None
        made = [spec["id"] for spec in content
                if self._create(spec, parent, field, seq)]
        self._place(parent, field, anchor, made)

    def remove(self, ids: List[str], seq: int) -> None:
        for nid in ids:
            node = self.nodes.get(nid)
            if node is not None and node.removed_seq is None:
                node.removed_seq = seq

    def set(self, nid: str, value, seq: int) -> None:
        node = self.nodes.get(nid)
        if node is not None:
            node.value = value
            node.value_seq = max(seq, node.value_seq)

    def move(self, ids: List[str], parent: str, field: str,
             anchor: Optional[str], seq: int) -> None:
        if self.work is not None and parent in self.nodes:
            self.work["walk_steps"] += self._walk_steps(parent)
        ids = [nid for nid in ids if nid in self.nodes]
        if not ids or parent not in self.nodes:
            return
        if any(self._inside(parent, nid) for nid in ids):
            return
        if anchor is not None and (anchor not in self.nodes or anchor in ids):
            anchor = None
        for nid in ids:
            self._detach(nid)
        self._place(parent, field, anchor, ids)
        for nid in ids:
            node = self.nodes[nid]
            node.parent = (parent, field)
            node.insert_seq = seq

    def advance(self, min_seq: int) -> None:
        if min_seq <= self.min_seq:
            return
        self.min_seq = min_seq
        expired = [n.id for n in self.nodes.values()
                   if n.removed_seq is not None and n.removed_seq <= min_seq]
        for nid in expired:
            if nid in self.nodes:
                self._detach(nid)
                self._pop(nid, min_seq)

    def _pop(self, nid: str, min_seq: int) -> None:
        node = self.nodes.pop(nid, None)
        if node is None:
            return
        for kids in list(node.fields.values()):
            for cid in list(kids):
                child = self.nodes.get(cid)
                if child is None:
                    continue
                if child.removed_seq is not None \
                        and child.removed_seq <= min_seq:
                    self._pop(cid, min_seq)
                else:
                    child.parent = None

    # -- summary ------------------------------------------------------------

    def _keep(self, nid: str) -> bool:
        node = self.nodes.get(nid)
        return node is not None and not (
            node.removed_seq is not None and node.removed_seq <= self.min_seq)

    def _fields(self, nid: str) -> dict:
        node = self.nodes[nid]
        return {f: [self._node(c) for c in sibs if self._keep(c)]
                for f, sibs in sorted(node.fields.items())
                if any(self._keep(c) for c in sibs)}

    def _node(self, nid: str) -> dict:
        node, msn = self.nodes[nid], self.min_seq
        obj = {"id": node.id, "type": node.type,
               "insertSeq": 0 if node.insert_seq <= msn else node.insert_seq}
        if node.value is not None:
            obj["value"] = node.value
            obj["valueSeq"] = 0 if node.value_seq <= msn else node.value_seq
        if node.removed_seq is not None:
            obj["removedSeq"] = node.removed_seq
        fields = self._fields(nid)
        if fields:
            obj["fields"] = fields
        return obj

    def summary(self) -> dict:
        root = {"fields": self._fields(ROOT), "minSeq": self.min_seq,
                "seq": self.seq}
        limbo = {nid for nid, n in self.nodes.items()
                 if nid != ROOT and n.parent is None}
        for nid, n in self.nodes.items():
            if nid == ROOT or n.parent is None or not self._keep(nid):
                continue
            if n.parent[0] != ROOT and not self._keep(n.parent[0]):
                limbo.add(nid)
        kept = [self._node(nid) for nid in sorted(limbo) if self._keep(nid)]
        if kept:
            root["limbo"] = kept
        return root


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")


def messages(records: dict) -> List[tuple]:
    """``(seq, min_seq, edits)`` of each message of a record stream, an
    edit as ``(kind, fields)`` with names resolved through the tables."""
    blob, nodes = records["blob"], records["nodes"]
    fields, types, values = records["fields"], records["types"], \
        records["values"]
    off = 0

    def i32() -> int:
        nonlocal off
        (v,) = _I32.unpack_from(blob, off)
        off += 4
        return v

    def node_of(i: int) -> Optional[str]:
        return None if i == -1 else nodes[i]

    def ids() -> List[str]:
        return [nodes[i32()] for _ in range(i32())]

    def value_of(v: int):
        return None if v in (VALUE_ABSENT, VALUE_NULL) else values[v]

    def content() -> List[dict]:
        nonlocal off
        specs: List[dict] = []
        top: List[dict] = []
        for _ in range(i32()):
            nid, typ, val, removed, up, fld = _ITEM.unpack_from(blob, off)
            off += _ITEM.size
            spec = {"id": nodes[nid], "type": types[typ]}
            if val != VALUE_ABSENT:
                spec["value"] = value_of(val)
            if removed != REMOVED_ABSENT:
                spec["removedSeq"] = removed
            specs.append(spec)
            if up == -1:
                top.append(spec)
            else:
                specs[up].setdefault("fields", {}).setdefault(
                    fields[fld], []).append(spec)
        return top

    out = []
    while off < len(blob):
        seq, _cseq, _ref, min_seq, _client, n_edits, _ts = \
            _HEADER.unpack_from(blob, off)
        off += _HEADER.size
        edits = []
        for _ in range(n_edits):
            kind = blob[off]
            off += 1
            if kind == INSERT:
                parent, fld, anchor = nodes[i32()], fields[i32()], \
                    node_of(i32())
                edits.append((kind, (parent, fld, anchor, content())))
            elif kind == REMOVE:
                edits.append((kind, (ids(),)))
            elif kind == SET:
                edits.append((kind, (nodes[i32()], value_of(i32()))))
            elif kind == MOVE:
                parent, fld, anchor = nodes[i32()], fields[i32()], \
                    node_of(i32())
                edits.append((kind, (ids(), parent, fld, anchor)))
            else:
                raise ValueError(f"the reference does not replay record "
                                 f"kind {kind}")
        out.append((seq, min_seq, edits))
    return out


def replay(records: dict, final_msn: int, control: bool = False,
           work: Optional[dict] = None) -> Dict[str, bytes]:
    """Summary blobs of a document caught up from empty over its record
    stream, its window at ``final_msn`` at the head; ``control`` leaves
    the last message out."""
    replica = Replica(work)
    msgs = messages(records)
    for seq, min_seq, edits in (msgs[:-1] if control else msgs):
        for kind, f in edits:
            if kind == INSERT:
                replica.insert(f[0], f[1], f[2], f[3], seq)
            elif kind == REMOVE:
                replica.remove(f[0], seq)
            elif kind == SET:
                replica.set(f[0], f[1], seq)
            else:
                replica.move(f[0], f[1], f[2], f[3], seq)
        replica.seq = seq
        replica.advance(min_seq)
    replica.advance(final_msn)
    return {"header": canonical_json(replica.summary())}
