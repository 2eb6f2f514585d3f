"""The tree traffic generator: SharedTree edit records for a whole pool.

Every document of a pool gets the same number of messages, one edit each.
The configuration fixes the pool's size, each document's shape (``deep``:
a nested chain, ``wide``: fan-out under two root fields), each deep
document's chain depth and every message's kind, from its own
``layout_seed``; ``--seed`` draws only content: which live node a message
names, its anchor, its field among the root's two, the chain node it
targets, and the values.  So every seed is the same work, and the draws
are made one message index at a time across all documents (numpy).

The edit model is the port's pinned tree workload
(``synth_tree_messages``) restricted to its two device-path shapes:
clients ``0..clients-1`` round robin, ``ref_seq`` one behind, ``min_seq``
``lag`` behind the head every ``every``-th message past ``after``.  A deep
document first inserts its chain (each node holding the next in field
``k``) under the root's field ``a``; then, on a roll below the traffic's
chain share, it moves a live leaf into a chain node, moves a chain node
into its own child (a cycle the fold drops) or inserts a leaf under a
chain node, and otherwise runs the wide mix.  A wide document's message
inserts a leaf into a root field, anchored after a live node half the
time (always while fewer than ``min_live`` leaves live), sets a live
leaf's value, removes one, or moves one within the root's fields.

``TreePool.records(d)`` is document ``d``'s record stream and tables as
the port's encoder (``ops/tree_native.encode_tree_ops``) writes them,
byte for byte: node ids ``n<i>`` by the pack's interning order, fields,
types, values and clients by first appearance.  ``final_forest(d)`` is
the generator's own account of the document's live forest at the head.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# message kinds
CHAIN, INS_ROOT, INS_CHAIN, SET, REMOVE, MOVE_ROOT, MOVE_LEAF, MOVE_CYCLE = \
    range(8)
FIELD_NAMES = ("a", "b", "k")
F_A, F_B, F_K = 0, 1, 2
NODE_TYPE = "n"
#: the record layout's constants (ops/tree_native.py, csrc/treepack.cpp)
_R_INSERT, _R_REMOVE, _R_SET, _R_MOVE = 1, 2, 3, 4
_REMOVED_ABSENT = -2 ** 31
_HEADER = np.dtype([("seq", "<i4"), ("client_seq", "<i4"),
                    ("ref_seq", "<i4"), ("min_seq", "<i4"),
                    ("client", "<i4"), ("n_edits", "<i4"), ("ts", "<f8")])
assert _HEADER.itemsize == 32
_ROW = 32 + 1 + 40
_BLOCK_DOCS = 256


@dataclasses.dataclass
class TreePool:
    """A generated pool: ``[D, T]`` message arrays (doc-major) and each
    document's record stream with its tables."""

    kind: np.ndarray      # [D, T] int8
    target: np.ndarray    # [D, T] int32: the new leaf, or the node named
    parent: np.ndarray    # [D, T] int32: insert / move destination node
    field: np.ndarray     # [D, T] int8: F_A / F_B / F_K
    anchor: np.ndarray    # [D, T] int32: -1 the field start
    value: np.ndarray     # [D, T] int32: leaf or set value, -1 none
    depth: np.ndarray     # [D] int32: chain depth (0: wide)
    n_nodes: np.ndarray   # [D] int32: nodes at the head, the root included
    min_seq: np.ndarray   # [T] int32: each message's min_seq
    purged: np.ndarray    # [D] int32: removed leaves purged by the head
    clients: List[str]
    names: List[str]      # node ids by index: the root "", then "n<i>"
    blobs: List[bytes]
    fields: List[List[str]]
    values: List[List[int]]

    @property
    def n_docs(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[1])

    @property
    def final_msn(self) -> int:
        return int(self.min_seq[-1])

    def live_nodes(self, d: int) -> int:
        """Nodes a correct summary of document ``d`` emits: every node
        but the root and the removed leaves purged by the head."""
        return int(self.n_nodes[d]) - 1 - int(self.purged[d])

    def records(self, d: int) -> Dict:
        """Document ``d``'s record stream and tables (the fields of the
        port's ``TreeRecords``)."""
        n = int(self.n_nodes[d])
        return {"blob": self.blobs[d], "clients": list(self.clients),
                "nodes": self.names[:n], "n_packed": n,
                "node_types": [""] + [NODE_TYPE] * (n - 1),
                "types": [NODE_TYPE], "fields": self.fields[d],
                "values": self.values[d],
                "n_packed_values": len(self.values[d]),
                "n_nodes_est": n, "n_edits_est": self.n_ops}

    def final_forest(self, d: int) -> Dict:
        """Document ``d``'s live forest at the head, replayed from the
        generator's own arrays: ``{field: [(node id, value, fields)]}``
        from the root, removed leaves left out.  Only what this traffic
        makes is modelled: an insert or move lands after its anchor when
        the anchor is in the destination field, else at the field start;
        a chain node's move into its own child is dropped."""
        names = self.names
        lists: Dict[Tuple[int, int], List[int]] = {}
        where: Dict[int, Tuple[int, int]] = {}
        value: Dict[int, int] = {}
        removed = set()

        def place(node, parent, field, anchor):
            sibs = lists.setdefault((parent, field), [])
            pos = 0
            if anchor >= 0 and where.get(anchor) == (parent, field):
                pos = sibs.index(anchor) + 1
            sibs.insert(pos, node)
            where[node] = (parent, field)

        rows = zip(self.kind[d].tolist(), self.target[d].tolist(),
                   self.parent[d].tolist(), self.field[d].tolist(),
                   self.anchor[d].tolist(), self.value[d].tolist())
        for k, tgt, par, fld, anc, val in rows:
            if k == CHAIN:
                depth = int(self.depth[d])
                place(1, 0, F_A, -1)
                for j in range(2, depth + 1):
                    place(j, j - 1, F_K, -1)
                for j in range(1, depth + 1):
                    value[j] = 0
            elif k in (INS_ROOT, INS_CHAIN):
                place(tgt, par, fld, anc)
                value[tgt] = val
            elif k == SET:
                value[tgt] = val
            elif k == REMOVE:
                removed.add(tgt)
            elif k in (MOVE_ROOT, MOVE_LEAF):
                lists[where[tgt]].remove(tgt)
                place(tgt, par, fld, anc)

        def fields_of(node) -> Dict:
            out = {}
            for f in sorted(range(3), key=lambda f: FIELD_NAMES[f]):
                kids = [(names[c], value[c], fields_of(c))
                        for c in lists.get((node, f), []) if c not in removed]
                if kids:
                    out[FIELD_NAMES[f]] = kids
            return out

        return fields_of(0)


def generate(config: dict, traffic: dict, seed: int,
             n_docs: Optional[int] = None,
             n_ops: Optional[int] = None) -> TreePool:
    """The pool of ``config`` under ``traffic`` for ``seed``; ``n_docs`` /
    ``n_ops`` override the configuration's counts (tests only)."""
    D = int(n_docs if n_docs is not None else config["docs"])
    T = int(n_ops if n_ops is not None else config["edits_per_doc"])
    wide, chain_mix = traffic["wide_mix"], traffic["deep_chain_mix"]
    p_ins, p_set, p_rem = (float(wide[k]) for k in ("insert", "set",
                                                    "remove"))
    p_leaf = float(chain_mix["leaf_into_chain"])
    p_cycle = p_leaf + float(chain_mix["chain_into_descendant"])
    p_chain = p_cycle + float(chain_mix["insert_under_chain"])
    min_live = int(traffic["min_live"])
    anchor_share = float(traffic["anchor_share"])
    leaf_values, set_values = int(traffic["leaf_values"]), \
        int(traffic["set_values"])
    lo, hi = config["chain_depth"]
    msn_rule = config["min_seq"]

    # The layout (shapes, depths, the kind of every message) comes from
    # the configuration alone; the seed draws content only.
    layout = np.random.default_rng([int(config["layout_seed"]), 0x7EE])
    deep = (np.arange(D) % int(config["deep_every"])) == 0
    depth = np.where(deep, layout.integers(lo, hi + 1, D), 0).astype(
        np.int32)
    roll = layout.random((T, D))
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x7EE5])
    u_pick, u_anchor, u_coin, u_field, u_chain = \
        (rng.random((T, D)) for _ in range(5))
    leaf_val = rng.integers(0, leaf_values, (T, D), dtype=np.int32)
    set_val = rng.integers(0, set_values, (T, D), dtype=np.int32)

    kind = np.empty((T, D), np.int8)
    target = np.zeros((T, D), np.int32)
    parent = np.zeros((T, D), np.int32)
    field = np.zeros((T, D), np.int8)
    anchor = np.full((T, D), -1, np.int32)
    value = np.full((T, D), -1, np.int32)
    live = np.zeros((D, T + 1), np.int32)
    n_live = np.zeros(D, np.int64)
    next_node = np.where(deep, depth + 1, 1).astype(np.int32)
    rows = np.arange(D)
    for t in range(T):
        r = roll[t]
        first_deep = deep & (t == 0)
        chain_work = deep & (t > 0) & (r < p_chain)
        leaf_mv = chain_work & (r < p_leaf) & (n_live > 0)
        cycle = chain_work & ~leaf_mv & (r < p_cycle)
        ins_chain = chain_work & ~leaf_mv & ~cycle
        rest = ~chain_work & ~first_deep
        ins_root = rest & ((r < p_ins) | (n_live < min_live))
        set_ = rest & ~ins_root & (r < p_ins + p_set)
        rem = rest & ~ins_root & ~set_ & (r < p_ins + p_set + p_rem)
        mv_root = rest & ~ins_root & ~set_ & ~rem

        n = np.maximum(n_live, 1)
        pick = np.minimum((u_pick[t] * n).astype(np.int64), n - 1)
        picked = live[rows, pick]
        anch = live[rows, np.minimum((u_anchor[t] * n).astype(np.int64),
                                     n - 1)]
        coin = (u_coin[t] < anchor_share) & (n_live > 0)
        ab = np.where(u_field[t] < 0.5, F_A, F_B).astype(np.int8)
        chain_node = 1 + np.minimum((u_chain[t] * depth).astype(np.int64),
                                    np.maximum(depth - 1, 0))
        hi_node = 3 + np.minimum(
            (u_chain[t] * np.maximum(depth - 3, 1)).astype(np.int64),
            np.maximum(depth - 4, 0))

        ins = ins_root | ins_chain
        k = np.full(D, MOVE_ROOT, np.int8)
        for mask, code in ((first_deep, CHAIN), (ins_root, INS_ROOT),
                           (ins_chain, INS_CHAIN), (set_, SET),
                           (rem, REMOVE), (leaf_mv, MOVE_LEAF),
                           (cycle, MOVE_CYCLE)):
            k[mask] = code
        kind[t] = k
        target[t] = np.where(first_deep, 1, np.where(
            ins, next_node, np.where(cycle, hi_node - 1, picked)))
        parent[t] = np.where(ins_chain | leaf_mv, chain_node,
                             np.where(cycle, hi_node, 0))
        field[t] = np.where(ins_chain | leaf_mv | cycle, F_K,
                            np.where(first_deep, F_A, ab))
        anc = np.where((ins_root | mv_root) & coin, anch, -1)
        anchor[t] = np.where(mv_root & (anc == picked), -1, anc)
        value[t] = np.where(first_deep, 0, np.where(
            ins, leaf_val[t], np.where(set_, set_val[t], -1)))
        # the live leaves: inserts append, removes swap the last in
        live[rows[ins], n_live[ins]] = next_node[ins]
        n_live += ins
        next_node += ins
        last = live[rows, np.maximum(n_live - 1, 0)]
        live[rows[rem], pick[rem]] = last[rem]
        n_live -= rem

    seq = np.arange(1, T + 1, dtype=np.int32)
    msn = np.zeros(T, np.int32)
    cur = 0
    for i, s in enumerate(seq.tolist()):
        if s > int(msn_rule["after"]) and s % int(msn_rule["every"]) == 0:
            cur = s - int(msn_rule["lag"])
        msn[i] = cur
    purged = ((kind == REMOVE) & (seq[:, None] <= msn[-1])).sum(axis=0)
    pool = TreePool(
        kind=np.ascontiguousarray(kind.T), target=np.ascontiguousarray(
            target.T), parent=np.ascontiguousarray(parent.T),
        field=np.ascontiguousarray(field.T),
        anchor=np.ascontiguousarray(anchor.T),
        value=np.ascontiguousarray(value.T), depth=depth,
        n_nodes=next_node, min_seq=msn, purged=purged.astype(np.int32),
        clients=[f"client{c}" for c in range(int(config["clients"]))],
        names=[""] + [f"n{i}" for i in range(1, int(next_node.max()))],
        blobs=[], fields=[], values=[])
    _encode(pool)
    return pool


def _value_tables(pool: TreePool) -> Tuple[np.ndarray, List[List[int]]]:
    """Each message's doc-local value id (first appearance, as the pack
    interns values) and each document's value table."""
    D, T = pool.value.shape
    n_values = int(pool.value.max()) + 1 if pool.value.size else 1
    first = np.full((D, max(n_values, 1)), T, np.int64)
    d_idx, t_idx = np.nonzero(pool.value >= 0)
    np.minimum.at(first, (d_idx, pool.value[d_idx, t_idx]), t_idx)
    order = np.argsort(first, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(order.shape[1])[None, :], axis=1)
    local = np.full((D, T), -1, np.int32)
    local[d_idx, t_idx] = rank[d_idx, pool.value[d_idx, t_idx]]
    present = first < T
    tables = [[int(v) for v in order[d] if present[d, v]] for d in range(D)]
    return local, tables


def _field_tables(pool: TreePool) -> Tuple[np.ndarray, List[List[str]]]:
    """Each document's field ids by first appearance (a chain's ``a``
    before its ``k``), and its field table."""
    D, T = pool.field.shape
    key = np.full((D, 3), 4 * T, np.int64)
    at = 2 * np.arange(T, dtype=np.int64)[None, :] \
        + (pool.kind == CHAIN) * (pool.field == F_K)
    for f in range(3):
        used = (pool.field == f) & (pool.kind != SET) & (pool.kind != REMOVE)
        key[:, f] = np.where(used, at, 4 * T).min(axis=1)
    chain = pool.depth > 0
    key[chain, F_K] = np.minimum(key[chain, F_K], 1)
    order = np.argsort(key, axis=1, kind="stable")
    ids = np.empty_like(order)
    np.put_along_axis(ids, order, np.arange(3)[None, :], axis=1)
    tables = [[FIELD_NAMES[f] for f in order[d] if key[d, f] < 4 * T]
              for d in range(D)]
    return ids.astype(np.int32), tables


def _encode(pool: TreePool) -> None:
    """Every document's record stream, a block of documents at a time:
    one fixed row a message, compacted to each kind's true length, the
    chain message of a deep document written in front."""
    D, T = pool.kind.shape
    vloc, pool.values = _value_tables(pool)
    fid, pool.fields = _field_tables(pool)
    n_clients = len(pool.clients)
    seq = np.arange(1, T + 1, dtype=np.int32)
    size_of = np.zeros(8, np.int64)
    size_of[[INS_ROOT, INS_CHAIN]] = 32 + 1 + 40
    size_of[[SET, REMOVE]] = 32 + 1 + 8
    size_of[[MOVE_ROOT, MOVE_LEAF, MOVE_CYCLE]] = 32 + 1 + 20
    for lo in range(0, D, _BLOCK_DOCS):
        hi = min(D, lo + _BLOCK_DOCS)
        B = hi - lo
        k = pool.kind[lo:hi]
        hdr = np.zeros((B, T), _HEADER)
        hdr["seq"] = seq
        hdr["client_seq"] = seq
        hdr["ref_seq"] = seq - 1
        hdr["min_seq"] = pool.min_seq
        hdr["client"] = np.arange(T) % n_clients
        hdr["n_edits"] = 1
        rows = np.zeros((B, T, _ROW), np.uint8)
        rows[:, :, :32] = hdr.view(np.uint8).reshape(B, T, 32)
        f = np.take_along_axis(fid[lo:hi], pool.field[lo:hi].astype(np.int64),
                               axis=1)
        tgt, par, anc = (a[lo:hi] for a in (pool.target, pool.parent,
                                            pool.anchor))
        v = vloc[lo:hi]
        ins = (k == INS_ROOT) | (k == INS_CHAIN)
        mv = (k == MOVE_ROOT) | (k == MOVE_LEAF) | (k == MOVE_CYCLE)
        words = np.zeros((B, T, 10), "<i4")
        one = np.ones_like(tgt)
        for i, plane in enumerate((par, f, anc, one, tgt, 0 * tgt, v,
                                   np.full_like(tgt, _REMOVED_ABSENT),
                                   -one, -one)):
            words[:, :, i] = np.where(ins, plane, words[:, :, i])
        for i, plane in enumerate((par, f, anc, one, tgt)):
            words[:, :, i] = np.where(mv, plane, words[:, :, i])
        words[:, :, 0] = np.where(k == SET, tgt, words[:, :, 0])
        words[:, :, 1] = np.where(k == SET, v, words[:, :, 1])
        words[:, :, 0] = np.where(k == REMOVE, 1, words[:, :, 0])
        words[:, :, 1] = np.where(k == REMOVE, tgt, words[:, :, 1])
        code = np.zeros((B, T), np.uint8)
        code[ins] = _R_INSERT
        code[mv] = _R_MOVE
        code[k == SET] = _R_SET
        code[k == REMOVE] = _R_REMOVE
        rows[:, :, 32] = code
        rows[:, :, 33:] = words.view(np.uint8).reshape(B, T, 40)
        size = size_of[k]
        keep = np.arange(_ROW)[None, None, :] < size[:, :, None]
        flat = rows[keep]
        ends = np.cumsum(size.sum(axis=1))
        starts = ends - size.sum(axis=1)
        for j, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            d = lo + j
            body = flat[s:e].tobytes()
            if pool.depth[d] > 0:
                body = _chain_message(pool, d, fid[d], vloc[d, 0]) + body
            pool.blobs.append(body)


def _chain_message(pool: TreePool, d: int, fid: np.ndarray,
                   v0: int) -> bytes:
    """A deep document's first message: its chain, one item a node, each
    under the one before in field ``k``."""
    depth = int(pool.depth[d])
    out = bytearray(struct.pack("<6id", 1, 1, 0, int(pool.min_seq[0]), 0, 1,
                                0.0))
    out += struct.pack("<B4i", _R_INSERT, 0, int(fid[F_A]), -1, depth)
    for j in range(depth):
        out += struct.pack("<6i", j + 1, 0, int(v0), _REMOVED_ABSENT,
                           j - 1, -1 if j == 0 else int(fid[F_K]))
    return bytes(out)
