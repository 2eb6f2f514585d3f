"""Binary edit records for SharedTree documents, and the native tree pack.

The ingestion side (the sequencer's log, a load generator) encodes each
tree document's changeset messages ONCE into the flat record stream
documented in ``csrc/treepack.cpp`` (``encode_tree_ops``: pure Python, run
once per message).  Node ids, fields, types, values and clients become
indices into the document's own tables, numbered by first appearance; node
ids and values in the order the tree pack interns them, so a record's node
index is the forest row it packs to.  A ``TreeDocInput`` carrying
``records`` may leave ``ops`` empty: the stream is authoritative.

``pack_records`` fills the ``TreeState`` / ``TreeEdits`` planes and the
meta of ``tree_kernel.pack_tree_batch`` for a batch of such documents in
C++ (``libtreepack``, built from the source by the content-hashed rule of
``ops/native_pack.py``; the interpreter lock is released around each
call), bit for bit what the Python pack fills from the same messages;
``RecordPack`` is that pack as steps over document ranges, which the
pipeline runs on several threads.  Without a toolchain it returns None and the Python pack runs on the
decoded messages.  ``decode_tree_ops`` gives back the messages the stream
was encoded from (the oracle's route: MAX_DEPTH overflow, purged-parent
inserts), and ``route_records`` the pre-pack routing verdict.

``write_headers`` is the extract side: the same library writes the
canonical ``header`` bytes of ``tree_kernel.summary_from_state`` for a
slice's documents from their downloaded final-forest planes, one call, the
interpreter lock released; ``value_table`` is the value table it reads,
serialized once a pack.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import operator
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import canonical_json
from .interning import Interner

_HEADER = struct.Struct("<6id")
_I32 = struct.Struct("<i")
_ITEM = struct.Struct("<6i")
_KIND = struct.Struct("<B")

R_INSERT, R_REMOVE, R_SET, R_MOVE, R_REVIVE = 1, 2, 3, 4, 5
_KINDS = {"insert": R_INSERT, "remove": R_REMOVE, "set": R_SET,
          "move": R_MOVE, "revive": R_REVIVE}
_NAMES = {v: k for k, v in _KINDS.items()}
#: an item's or a set's value: no ``value`` key, or a null value
VALUE_ABSENT, VALUE_NULL = -1, -2
#: an item whose spec carries no ``removedSeq``
REMOVED_ABSENT = -2 ** 31
#: the routing verdicts of ``treepack_route``, and the pack's fallback
#: reasons, by code
ROUTES = {1: "revive", 2: "multi_id_move"}
FALLBACKS = {0: None, 1: "revive", 2: "multi_id_move",
             3: "purged_parent_insert"}

_EDIT_KEYS = {
    "insert": {"kind", "parent", "field", "anchor", "content"},
    "remove": {"kind", "ids"},
    "set": {"kind", "id", "value"},
    "move": {"kind", "ids", "parent", "field", "anchor"},
    "revive": {"kind", "ids", "parent", "field", "anchor", "content"},
}
_SPEC_KEYS = {"id", "type", "value", "removedSeq", "fields"}


@dataclasses.dataclass
class TreeRecords:
    """One document's changeset messages as a record stream and its
    tables.  ``nodes[:n_packed]`` are the nodes the pack interns, in its
    order (the root ``""`` first), ``node_types`` their types (``""`` for
    a node no insert materializes); the rest are named only by revives and
    multi-id moves.  ``values[:n_packed_values]`` are the values the pack
    interns, in its order; ``value_keys`` their interning keys where some
    value is a dict or list (None: each value is its own key).
    ``n_nodes_est`` / ``n_edits_est`` are the sizing estimate
    ``tree_kernel.tree_buckets`` takes of the messages."""

    blob: bytes
    clients: List[Optional[str]]
    nodes: List[str]
    n_packed: int
    node_types: List[str]
    types: List[str]
    fields: List[str]
    values: List[Any]
    n_packed_values: int
    n_nodes_est: int
    n_edits_est: int
    value_keys: Optional[List[Any]] = None


def _check_spec(spec) -> None:
    if not isinstance(spec, dict) or not set(spec) <= _SPEC_KEYS \
            or not isinstance(spec.get("id"), str) \
            or not isinstance(spec.get("type"), str):
        raise ValueError(f"tree records cannot carry the node spec {spec!r}")
    removed = spec.get("removedSeq", 0)
    if not isinstance(removed, int) or not 0 <= removed < 2 ** 31 - 1:
        raise ValueError(f"tree records cannot carry removedSeq {removed!r}")
    fields = spec.get("fields", {})
    if not isinstance(fields, dict) or not all(
            isinstance(f, str) and isinstance(ch, list) and ch
            for f, ch in fields.items()):
        raise ValueError(f"tree records cannot carry the fields {fields!r}")


def _check_edit(edit) -> str:
    kind = edit.get("kind") if isinstance(edit, dict) else None
    if kind not in _EDIT_KEYS or set(edit) != _EDIT_KEYS[kind]:
        raise ValueError(f"tree records cannot carry the edit {edit!r}")
    if kind in ("insert", "revive") and not edit["content"]:
        raise ValueError("tree records cannot carry an empty insert")
    return kind


def _preorder(content: Sequence[dict]) -> List[Tuple[dict, int, Optional[str]]]:
    """(spec, index of the item whose field holds it, that field) of every
    node of ``content``, in pre-order (the pack's materialization order)."""
    out: List[Tuple[dict, int, Optional[str]]] = []

    def walk(spec, up, field):
        _check_spec(spec)
        me = len(out)
        out.append((spec, up, field))
        for f, children in spec.get("fields", {}).items():
            for child in children:
                walk(child, me, f)

    for spec in content:
        walk(spec, -1, None)
    return out


def encode_tree_ops(msgs: Sequence[SequencedMessage]) -> TreeRecords:
    """A tree document's changeset messages (ascending seq) → its record
    stream and tables.  Raises ValueError for what the records cannot
    carry exactly (a message that is not an op of edits, an unknown edit
    kind or key, an empty insert or field): such a document keeps its
    messages."""
    nodes, values = Interner(), Interner()
    nodes.intern("")
    node_types = [""]

    def node(nid) -> int:
        if not isinstance(nid, str):
            raise ValueError(f"tree records cannot carry the node id {nid!r}")
        i = nodes.intern(nid)
        if i == len(node_types):
            node_types.append("")
        return i

    def value_id(v) -> int:
        i = values.intern(v)
        if type(values.values[i]) is not type(v):
            # 1 and True (or 1.0) share an interning key, and the table
            # would give back the first
            raise ValueError(f"tree records cannot carry both "
                             f"{values.values[i]!r} and {v!r}")
        return i

    def value(spec_or_edit) -> None:
        v = spec_or_edit.get("value")
        if v is not None:
            value_id(v)

    deferred = []
    # The pack's interning order: nodes and values as
    # fill_tree_doc_messages interns them.
    for msg in msgs:
        if msg.type is not MessageType.OP or not isinstance(
                msg.contents, dict) or set(msg.contents) != {"edits"}:
            raise ValueError("tree records carry changeset ops only")
        for edit in msg.contents["edits"]:
            kind = _check_edit(edit)
            if kind == "insert":
                node(edit["parent"])
                for spec, _up, _f in _preorder(edit["content"]):
                    i = node(spec["id"])
                    node_types[i] = spec["type"]
                    value(spec)
                if edit["anchor"] is not None:
                    node(edit["anchor"])
            elif kind == "remove":
                for nid in edit["ids"]:
                    node(nid)
            elif kind == "set":
                node(edit["id"])
                value(edit)
            elif kind == "move" and len(edit["ids"]) == 1:
                node(edit["parent"])
                node(edit["ids"][0])
                if edit["anchor"] is not None:
                    node(edit["anchor"])
            else:
                deferred.append(edit)
    n_packed, n_packed_values = len(nodes), len(values)
    for edit in deferred:
        for nid in edit["ids"]:
            node(nid)
        node(edit["parent"])
        if edit["anchor"] is not None:
            node(edit["anchor"])
        for spec, _up, _f in _preorder(edit.get("content", ())):
            node(spec["id"])
            value(spec)

    clients, fields, types = Interner(), Interner(), Interner()
    n_nodes_est, n_edits_est = 1, 0
    out = bytearray()

    def anchor_of(edit) -> int:
        return -1 if edit["anchor"] is None else nodes.intern(edit["anchor"])

    def ids_of(edit) -> bytes:
        return _I32.pack(len(edit["ids"])) + b"".join(
            _I32.pack(nodes.intern(nid)) for nid in edit["ids"])

    def items_of(content) -> bytes:
        nonlocal n_nodes_est
        items = _preorder(content)
        n_nodes_est += len(items)
        parts = [_I32.pack(len(items))]
        for spec, up, f in items:
            v = VALUE_ABSENT if "value" not in spec else (
                VALUE_NULL if spec["value"] is None
                else value_id(spec["value"]))
            parts.append(_ITEM.pack(
                nodes.intern(spec["id"]), types.intern(spec["type"]), v,
                spec.get("removedSeq", REMOVED_ABSENT), up,
                -1 if f is None else fields.intern(f)))
        return b"".join(parts)

    for msg in msgs:
        edits = msg.contents["edits"]
        client = -1 if msg.client_id is None \
            else clients.intern(msg.client_id)
        try:
            out += _HEADER.pack(msg.seq, msg.client_seq, msg.ref_seq,
                                msg.min_seq, client, len(edits),
                                float(msg.timestamp))
        except struct.error as exc:
            raise ValueError(f"tree records cannot carry the message "
                             f"header of seq {msg.seq!r}") from exc
        for edit in edits:
            kind = edit["kind"]
            out += _KIND.pack(_KINDS[kind])
            if kind in ("insert", "move", "revive"):
                out += struct.pack("<3i", nodes.intern(edit["parent"]),
                                   fields.intern(edit["field"]),
                                   anchor_of(edit))
            if kind == "insert":
                out += items_of(edit["content"])
                n_edits_est += 1
            elif kind in ("remove", "move"):
                out += ids_of(edit)
                n_edits_est += len(edit["ids"])
            elif kind == "set":
                v = VALUE_NULL if edit["value"] is None \
                    else value_id(edit["value"])
                out += struct.pack("<2i", nodes.intern(edit["id"]), v)
                n_edits_est += 1
            else:
                out += ids_of(edit) + items_of(edit["content"])
                n_edits_est += len(edit["ids"])
    keyed = any(isinstance(v, (dict, list)) for v in values.values)
    return TreeRecords(
        blob=bytes(out), clients=clients.values, nodes=nodes.values,
        n_packed=n_packed, node_types=node_types[:n_packed],
        types=types.values, fields=fields.values, values=values.values,
        n_packed_values=n_packed_values, n_nodes_est=n_nodes_est,
        n_edits_est=n_edits_est,
        value_keys=[Interner._hashable(v) for v in values.values]
        if keyed else None)


# -- reading the stream in Python ----------------------------------------------


def _parse(blob: bytes):
    """``(header, edits)`` per message; an edit is ``(kind, fields)``:
    insert ``(parent, field, anchor, items)``, remove ``(ids,)``, set
    ``(node, value)``, move ``(parent, field, anchor, ids)``, revive
    ``(parent, field, anchor, ids, items)``."""
    off = 0
    out = []

    def i32():
        nonlocal off
        (v,) = _I32.unpack_from(blob, off)
        off += 4
        return v

    def ids():
        n = i32()
        return [i32() for _ in range(n)]

    def items():
        nonlocal off
        n = i32()
        got = [_ITEM.unpack_from(blob, off + 24 * j) for j in range(n)]
        off += 24 * n
        return got

    try:
        while off < len(blob):
            header = _HEADER.unpack_from(blob, off)
            off += _HEADER.size
            edits = []
            for _ in range(header[5]):
                (kind,) = _KIND.unpack_from(blob, off)
                off += 1
                if kind == R_INSERT:
                    edits.append((kind, (i32(), i32(), i32(), items())))
                elif kind == R_REMOVE:
                    edits.append((kind, (ids(),)))
                elif kind == R_SET:
                    edits.append((kind, (i32(), i32())))
                elif kind == R_MOVE:
                    edits.append((kind, (i32(), i32(), i32(), ids())))
                elif kind == R_REVIVE:
                    edits.append((kind, (i32(), i32(), i32(), ids(),
                                         items())))
                else:
                    raise ValueError(f"unknown tree record kind {kind}")
            out.append((header, edits))
    except struct.error as exc:
        raise ValueError("malformed tree record stream") from exc
    return out


def decode_tree_ops(rec: TreeRecords) -> List[SequencedMessage]:
    """The messages ``rec`` was encoded from (the oracle's route)."""
    nodes, fields, values = rec.nodes, rec.fields, rec.values

    def anchor(a):
        return None if a == -1 else nodes[a]

    def content(items) -> List[dict]:
        specs: List[dict] = []
        top: List[dict] = []
        for node, typ, value, removed, up, field in items:
            spec: Dict[str, Any] = {"id": nodes[node], "type": rec.types[typ]}
            if value != VALUE_ABSENT:
                spec["value"] = None if value == VALUE_NULL else values[value]
            if removed != REMOVED_ABSENT:
                spec["removedSeq"] = removed
            specs.append(spec)
            if up == -1:
                top.append(spec)
            else:
                specs[up].setdefault("fields", {}).setdefault(
                    fields[field], []).append(spec)
        return top

    out = []
    for (seq, client_seq, ref_seq, min_seq, client, _n, ts), edits in \
            _parse(rec.blob):
        got = []
        for kind, f in edits:
            name = _NAMES[kind]
            if kind == R_INSERT:
                got.append({"kind": name, "parent": nodes[f[0]],
                            "field": fields[f[1]], "anchor": anchor(f[2]),
                            "content": content(f[3])})
            elif kind == R_REMOVE:
                got.append({"kind": name, "ids": [nodes[i] for i in f[0]]})
            elif kind == R_SET:
                got.append({"kind": name, "id": nodes[f[0]],
                            "value": None if f[1] == VALUE_NULL
                            else values[f[1]]})
            else:
                edit = {"kind": name, "ids": [nodes[i] for i in f[3]],
                        "parent": nodes[f[0]], "field": fields[f[1]],
                        "anchor": anchor(f[2])}
                if kind == R_REVIVE:
                    edit["content"] = content(f[4])
                got.append(edit)
        out.append(SequencedMessage(
            seq=seq, client_id=None if client == -1 else rec.clients[client],
            client_seq=client_seq, ref_seq=ref_seq, min_seq=min_seq,
            type=MessageType.OP, contents={"edits": got}, timestamp=ts))
    return out


def _route_py(blob: bytes) -> Optional[str]:
    for _header, edits in _parse(blob):
        for kind, f in edits:
            if kind == R_REVIVE:
                return "revive"
            if kind == R_MOVE and len(f[3]) != 1:
                return "multi_id_move"
    return None


def removal_times(rec: TreeRecords) -> Dict[str, int]:
    """Each removed node's first remover's seq (the pack's
    ``removal_time``), read from the stream."""
    out: Dict[str, int] = {}
    for header, edits in _parse(rec.blob):
        for kind, f in edits:
            if kind == R_REMOVE:
                for i in f[0]:
                    out.setdefault(rec.nodes[i], header[0])
    return out


# -- the native library --------------------------------------------------------


_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled tree packer, or None (the Python pack runs)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from .native_pack import build_native

    path = build_native("treepack")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.treepack_route.restype = ctypes.c_int
    lib.treepack_route.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.treepack_begin.restype = ctypes.c_void_p
    lib.treepack_begin.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32)]
    lib.treepack_containers.restype = None
    lib.treepack_containers.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.treepack_finish.restype = ctypes.c_int
    lib.treepack_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.treepack_free.restype = None
    lib.treepack_free.argtypes = [ctypes.c_void_p]
    lib.treepack_json_offsets.restype = ctypes.c_int
    lib.treepack_json_offsets.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
    lib.treepack_split.restype = ctypes.c_int
    lib.treepack_split.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_void_p]
    lib.treepack_extract.restype = ctypes.c_int64
    lib.treepack_extract.argtypes = (
        [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int32, ctypes.c_int32]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_char_p, ctypes.c_void_p] * 3
        + [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32]
        + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3)
    _lib = lib
    return lib


def route_records(rec: TreeRecords) -> Optional[str]:
    """``"revive"`` / ``"multi_id_move"`` when the stream holds one
    (whichever comes first), else None: ``known_tree_fallback``'s verdict,
    read from the records."""
    lib = load_library()
    if lib is None:
        return _route_py(rec.blob)
    code = lib.treepack_route(rec.blob, len(rec.blob))
    if code < 0:
        raise ValueError("malformed tree record stream")
    return ROUTES.get(code)


class TableInterner(Interner):
    """An ``Interner`` over a finished table; its key map is made on first
    use (extraction reads only ``values``)."""

    def __init__(self, values: List[Any]) -> None:
        self.values = values

    def __getattr__(self, name):
        if name != "_by_key":
            raise AttributeError(name)
        self._by_key = {self._hashable(v): i
                        for i, v in enumerate(self.values)}
        return self._by_key


def _intern_values(recs: Sequence[TreeRecords]):
    """The batch-global value interner (the Python pack's, in its order)
    and each document's doc-local -> global map, concatenated, with
    ``D + 1`` offsets."""
    values = Interner()
    by_key = values._by_key
    maps: List[np.ndarray] = []
    offs = np.zeros(len(recs) + 1, np.int64)
    for d, rec in enumerate(recs):
        k = rec.n_packed_values
        keys = (rec.value_keys or rec.values)[:k]
        for i in [i for i, key in enumerate(keys) if key not in by_key]:
            by_key[keys[i]] = len(values.values)
            values.values.append(rec.values[i])
        maps.append(np.fromiter(map(by_key.__getitem__, keys), np.int32, k))
        offs[d + 1] = offs[d] + k
    flat = np.concatenate(maps) if maps else np.zeros(0, np.int32)
    return values, np.ascontiguousarray(flat, np.int32), offs


class RecordPack:
    """The native record pack of one batch, cut into ``k`` document ranges
    and run a step at a time, so that the ranges' steps can run on
    several threads (each native step releases the interpreter lock):

    1. ``intern()``: the batch-global value table, in first-appearance
       order, and each document's doc-local -> global value map;
    2. ``begin(j)``: parse range ``j``'s streams (``treepack_begin``);
    3. ``size()``: the chunk-wide container bucket ``C`` from every
       range's facts, and every plane allocated once for the batch;
    4. ``finish(j)``: fill range ``j``'s rows of those planes in place
       (``treepack_finish``), and its containers;
    5. ``join()``: the meta, and ``pack_records``'s result.

    Steps 2 and 4 of different ranges may run at once; every step 2 ends
    before step 3, and every step 4 before step 5.  A malformed stream or
    an overflow names the first such document of the batch, as one range
    does.  ``close()`` frees what a failed pack leaves."""

    def __init__(self, lib, docs, N: int, T: int, k: int) -> None:
        self.lib, self.docs, self.N, self.T = lib, docs, N, T
        D = len(docs)
        self.cuts = [D * j // k for j in range(k + 1)]
        self.handles: List[Optional[int]] = [None] * k
        self.bad = [-1] * k
        self.rcs = [0] * k

    def intern(self) -> None:
        self.recs = [doc.records for doc in self.docs]
        self.values, self.vmap, self.voffs = _intern_values(self.recs)
        self.lens = np.asarray([len(r.blob) for r in self.recs], np.int64)
        self.facts = np.empty((len(self.recs), 7), np.int32)

    def begin(self, j: int) -> None:
        lo, hi = self.cuts[j], self.cuts[j + 1]
        blobs = (ctypes.c_char_p * (hi - lo))(
            *[r.blob for r in self.recs[lo:hi]])
        bad = ctypes.c_int32(-1)
        # The value map stays whole: the range's offsets index it from
        # its start.
        self.handles[j] = self.lib.treepack_begin(
            hi - lo, blobs, self.lens[lo:].ctypes.data, self.vmap.ctypes.data,
            self.voffs[lo:].ctypes.data, self.facts[lo:].ctypes.data,
            ctypes.byref(bad))
        self.bad[j] = bad.value

    def size(self) -> None:
        from .interning import next_bucket
        from .tree_kernel import TreeEdits, TreeState

        for j, handle in enumerate(self.handles):
            if not handle:
                self.close()
                bad = self.docs[self.cuts[j] + self.bad[j]]
                raise ValueError(f"{bad.doc_id}: malformed tree record "
                                 "stream")
        D, N, T = len(self.docs), self.N, self.T
        self.n_nodes, self.n_cont, self.t_rows = (
            np.ascontiguousarray(self.facts[:, i]) for i in range(3))
        self.C = C = next_bucket(max(int(self.n_cont.max(initial=0)), 1),
                                 floor=8)
        self.cont_at = np.concatenate(([0], np.cumsum(self.n_cont,
                                                      dtype=np.int64)))
        self.conts = np.empty((int(self.cont_at[-1]), 2), np.int32)
        self.st = {f: np.empty((D, C if f in ("head", "container_parent")
                                else N), np.int32)
                   for f in TreeState._fields if f != "overflow"}
        self.st["overflow"] = np.zeros((D,), np.bool_)
        self.ed = {f: np.empty((D, T), np.int32) for f in TreeEdits._fields}
        self.planes = [self.st[f] for f in TreeState._fields
                       if f != "overflow"] \
            + [self.ed[f] for f in TreeEdits._fields]

    def finish(self, j: int) -> None:
        lo = self.cuts[j]
        handle, self.handles[j] = self.handles[j], None
        try:
            self.lib.treepack_containers(
                handle, self.conts[self.cont_at[lo]:].ctypes.data)
            ptrs = (ctypes.c_void_p * len(self.planes))(
                *[a[lo:].ctypes.data for a in self.planes])
            self.rcs[j] = self.lib.treepack_finish(handle, self.N, self.C,
                                                   self.T, ptrs)
        finally:
            self.lib.treepack_free(handle)

    def join(self):
        from .tree_kernel import TreeEdits, TreeState, _RecordDocPack

        docs, recs, facts = self.docs, self.recs, self.facts
        for lo, rc in zip(self.cuts, self.rcs):
            if rc != 0:
                raise ValueError(
                    f"{docs[lo - 1 - rc].doc_id}: tree records overflow the "
                    f"buckets N={self.N}, C={self.C}, T={self.T}")
        conts, at = self.conts, 0
        doc_packs = []
        for d, rec in enumerate(recs):
            n, c = int(self.n_nodes[d]), int(self.n_cont[d])
            if n != rec.n_packed or len(rec.node_types) != n:
                raise ValueError(f"{docs[d].doc_id}: tree records' node "
                                 "table is not in the pack's order")
            pack = _RecordDocPack(rec)
            pack.node_ids = TableInterner(rec.nodes[:n])
            pack.node_types = list(rec.node_types)
            pack.containers = TableInterner(
                [(int(p), rec.fields[f])
                 for p, f in conts[at:at + c].tolist()])
            at += c
            pack.fallback_reason = FALLBACKS[int(facts[d, 6])]
            pack.header_seq = int(facts[d, 3])
            pack.base_min_seq = int(facts[d, 4])
            pack.boundary = int(facts[d, 5])
            doc_packs.append(pack)
        meta = {"doc_packs": doc_packs, "values": self.values, "docs": docs,
                "n_nodes": self.n_nodes, "n_cont": self.n_cont,
                "t_rows": self.t_rows, "native_docs": len(docs),
                "value_json": value_table(self.values)}
        return TreeState(**self.st), TreeEdits(**self.ed), meta

    def close(self) -> None:
        for j, handle in enumerate(self.handles):
            if handle:
                self.lib.treepack_free(handle)
            self.handles[j] = None


def pack_records(docs, N: int, T: int):
    """``pack_tree_batch``'s ``(TreeState, TreeEdits, meta)`` for
    documents that all carry records and no base summary, from the native
    library at the buckets ``(N, T)``: the steps of :class:`RecordPack`
    over one range, on this thread.  None without the library.  The meta
    also counts the documents packed here (``native_docs``)."""
    lib = load_library()
    if lib is None:
        return None
    pack = RecordPack(lib, docs, N, T, 1)
    pack.intern()
    pack.begin(0)
    pack.size()
    pack.finish(0)
    return pack.join()


# -- the native summary writer ------------------------------------------------


#: the planes the writer reads, in its order
_WRITER_PLANES = ("head", "next", "removed_seq", "insert_seq", "value",
                  "value_seq", "container_parent")
#: the writer's statuses: written; a cycle (a chain longer than the
#: document's rows, or a node reached twice); any other is the Python
#: route's to decide
WRITTEN, CYCLE = 0, 1


def value_table(values: Interner):
    """``values`` as the writer reads them: ``(count, bytes, offsets)``,
    the table's canonical JSON array and where each value lies in it; None
    without the library, or where the list has no canonical JSON (the
    Python route then decides each document)."""
    lib = load_library()
    if lib is None:
        return None
    vals = values.values
    try:
        blob = canonical_json(vals)
    except (TypeError, ValueError, RecursionError):
        return None
    offs = np.empty(len(vals) + 1, np.int64)
    if lib.treepack_json_offsets(blob, len(blob), len(vals),
                                 offs.ctypes.data) != 0:
        return None
    return len(vals), blob, offs


def _string_table(lib, strings: List[str]):
    """``strings`` as the writer reads a table: their UTF-8 joined with NUL
    bytes, and where each lies (``treepack_split``'s offsets).  Where a
    string holds a NUL or a lone surrogate, each string is measured here
    (the writer leaves a document that emits a lone surrogate to the
    Python route)."""
    n = len(strings)
    offs = np.empty(n + 1, np.int64)
    try:
        blob = "\x00".join(strings).encode()
        if lib.treepack_split(blob, len(blob), n, offs.ctypes.data) == 0:
            return blob, offs
    except UnicodeEncodeError:
        pass
    parts = [s.encode("utf-8", "surrogatepass") for s in strings]
    offs[0] = 0
    np.cumsum(np.fromiter(map(len, parts), np.int64, n) + 1, out=offs[1:])
    return b"\x00".join(parts), offs


def _row_plane(a: np.ndarray) -> np.ndarray:
    """A downloaded plane as it is, unless the writer cannot step its rows
    (not int32, or elements not adjacent within a row)."""
    if a.dtype != np.int32 or (a.shape[1] > 1 and a.strides[1] != 4) \
            or a.strides[0] % 4:
        return np.ascontiguousarray(a, np.int32)
    return a


def write_headers(meta: dict, state_np: dict, rows: Sequence[int]):
    """The canonical ``header`` bytes ``summary_from_state`` writes for the
    documents at ``rows`` of ``meta`` and of the final-forest planes
    ``state_np`` (downloaded, read in place), from one call of the native
    writer with the interpreter lock released: per row ``(header, emitted
    nodes)``, or ``(None, status)`` where the writer left the document to
    the Python route (``CYCLE``: a chain cycle).  None for every row
    without the library or the value table, or where a table holds what is
    not a string."""
    lib = load_library()
    table = meta["value_json"] if "value_json" in meta \
        else value_table(meta["values"])
    if lib is None or table is None:
        return None
    n_vals, val_blob, val_offs = table
    packs, docs = meta["doc_packs"], meta["docs"]
    sel = [packs[d] for d in rows]
    k = len(sel)
    chain = itertools.chain.from_iterable
    try:
        conts = list(chain(p.containers.values for p in sel))
        ids, id_offs = _string_table(
            lib, list(chain(p.node_ids.values for p in sel)))
        types, type_offs = _string_table(
            lib, list(chain(p.node_types for p in sel)))
        fields, field_offs = _string_table(
            lib, list(map(operator.itemgetter(1), conts)))
        owners = np.fromiter(map(operator.itemgetter(0), conts), np.int32,
                             len(conts))
        msn = np.fromiter((max(docs[d].final_msn, p.base_min_seq)
                           for d, p in zip(rows, sel)), np.int64, k)
        seq = np.fromiter((p.header_seq for p in sel), np.int64, k)
    except (TypeError, ValueError, OverflowError):
        return None
    n_nodes = np.fromiter((len(p.node_ids.values) for p in sel), np.int32, k)
    n_types = np.fromiter((len(p.node_types) for p in sel), np.int32, k)
    if not np.array_equal(n_nodes, n_types):
        return None
    n_cont = np.fromiter((len(p.containers.values) for p in sel), np.int32,
                         k)
    planes = [_row_plane(state_np[f]) for f in _WRITER_PLANES]
    N, C = planes[1].shape[1], planes[0].shape[1]
    if any(a.shape[1] != (C if f in ("head", "container_parent") else N)
           for f, a in zip(_WRITER_PLANES, planes)):
        return None
    ptrs = (ctypes.c_void_p * len(planes))(*[a.ctypes.data for a in planes])
    strides = np.asarray([a.strides[0] // 4 for a in planes], np.int64)
    row_idx = np.asarray(rows, np.int32)
    out_offs = np.empty(k + 1, np.int64)
    out_nodes = np.empty(k, np.int64)
    status = np.empty(k, np.int32)
    per_node = 96 + 2 * len(val_blob) // max(n_vals, 1)
    cap = 2 * (len(ids) + len(types)) + len(fields) \
        + per_node * int(n_nodes.sum()) + 64 * k + 64
    for _attempt in range(2):
        out = np.empty(cap, np.uint8)
        rc = lib.treepack_extract(
            k, row_idx.ctypes.data, ptrs, strides.ctypes.data, N, C,
            msn.ctypes.data, seq.ctypes.data, n_nodes.ctypes.data,
            n_cont.ctypes.data, owners.ctypes.data,
            ids, id_offs.ctypes.data, types, type_offs.ctypes.data,
            fields, field_offs.ctypes.data,
            val_blob, val_offs.ctypes.data, n_vals,
            out.ctypes.data, cap, out_offs.ctypes.data,
            out_nodes.ctypes.data, status.ctypes.data)
        if rc == 0:
            break
        cap = int(-rc - 2)
    else:
        raise RuntimeError("treepack_extract: capacity negotiation failed")
    buf = out[:out_offs[k]].tobytes()
    offs, nodes, status = out_offs.tolist(), out_nodes.tolist(), \
        status.tolist()
    return [(buf[offs[i]:offs[i + 1]], nodes[i]) if status[i] == WRITTEN
            else (None, status[i]) for i in range(k)]
