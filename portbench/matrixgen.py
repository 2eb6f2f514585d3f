"""The matrix traffic generator: SharedMatrix message records for a whole
pool.

Every document gets the same number of messages.  The configuration
fixes the pool's size and, from its own ``layout_seed``, every message's
kind and its insert or remove count, so every document's row and column
counts at every message; ``--seed`` draws only content: each position
(an insert's, a remove's start, a setCell's row and column), each value,
and which documents switch to first-writer-wins.  So every seed is the
same work, and the draws are made one message index at a time across all
documents (numpy).

The message model is the port's pinned matrix workload
(``gen_matrix_doc``, BASELINE's config #4): clients ``0..clients-1`` round
robin, ``ref_seq`` one behind, each message on a roll of the traffic's
mix: insertRows / insertCols (forced while the grid has no row / column),
removeRows / removeCols (while more than two remain), else setCell on the
live grid.  One document in ``fww.every`` sends setPolicy at its
``fww.at``-th message, which the layout holds as a setCell for every
document; ``min_seq`` trails the head by ``lag`` every ``every``-th
message past ``after``.

``MatrixPool.records(d)`` is document ``d``'s record stream and tables as
the port's encoder (``ops/matrix_native.encode_matrix_ops``) writes them,
byte for byte: values and clients by first appearance.  ``final_grid(d)``
is the generator's own account of the document's visible grid at the
head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the record layout's constants (ops/matrix_native.py,
#: csrc/matrixpack.cpp)
MAGIC = 0x3158524D
INSERT_ROWS, INSERT_COLS, REMOVE_ROWS, REMOVE_COLS, SET_CELL, SET_POLICY = \
    range(1, 7)
MSG_FIELDS = 9
_BLOCK_DOCS = 256


@dataclasses.dataclass
class MatrixPool:
    """A generated pool: ``[D, T]`` message arrays (doc-major) and each
    document's record stream with its tables."""

    kind: np.ndarray      # [D, T] int8: the record kinds
    a: np.ndarray         # [D, T] int32: pos / start / row
    b: np.ndarray         # [D, T] int32: count / end / col
    value: np.ndarray     # [D, T] int32: a setCell's value, else -1
    rows: np.ndarray      # [D] int32: visible rows at the head
    cols: np.ndarray      # [D] int32: visible columns at the head
    fww: np.ndarray       # [D] bool: the document switched to FWW
    min_seq: np.ndarray   # [T] int32: each message's min_seq
    clients: List[str]
    blobs: List[bytes]
    values: List[List[int]]
    n_cells: np.ndarray   # [D] int32: setCell messages
    row_rows: np.ndarray  # [D] int32: rows of the row stream
    col_rows: np.ndarray  # [D] int32: rows of the column stream

    @property
    def n_docs(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[1])

    @property
    def final_msn(self) -> int:
        return int(self.min_seq[-1])

    def records(self, d: int) -> Dict:
        """Document ``d``'s record stream and tables (the fields of the
        port's ``MatrixRecords``)."""
        return {"blob": self.blobs[d], "clients": list(self.clients),
                "values": self.values[d], "n_cells": int(self.n_cells[d]),
                "row_rows": int(self.row_rows[d]),
                "col_rows": int(self.col_rows[d])}

    def final_grid(self, d: int) -> Dict[Tuple[int, int], int]:
        """Document ``d``'s visible grid at the head, replayed from the
        generator's own arrays: ``{(row, col): value}`` by visible
        position, cells that were never set left out."""
        rows: List[int] = []
        cols: List[int] = []
        cells: Dict[Tuple[int, int], int] = {}
        made = 0
        for k, a, b, v in zip(self.kind[d].tolist(), self.a[d].tolist(),
                              self.b[d].tolist(), self.value[d].tolist()):
            if k in (INSERT_ROWS, INSERT_COLS):
                ids = list(range(made, made + b))
                made += b
                (rows if k == INSERT_ROWS else cols)[a:a] = ids
            elif k in (REMOVE_ROWS, REMOVE_COLS):
                del (rows if k == REMOVE_ROWS else cols)[a:b]
            elif k == SET_CELL:
                cells[(rows[a], cols[b])] = v
        at_row = {r: i for i, r in enumerate(rows)}
        at_col = {c: j for j, c in enumerate(cols)}
        return {(at_row[r], at_col[c]): v for (r, c), v in cells.items()
                if r in at_row and c in at_col}


def generate(config: dict, traffic: dict, seed: int,
             n_docs: Optional[int] = None,
             n_ops: Optional[int] = None) -> MatrixPool:
    """The pool of ``config`` under ``traffic`` for ``seed``; ``n_docs`` /
    ``n_ops`` override the configuration's counts (tests only)."""
    D = int(n_docs if n_docs is not None else config["docs"])
    T = int(n_ops if n_ops is not None else config["messages_per_doc"])
    mix = traffic["mix"]
    edges = np.cumsum([float(mix[k]) for k in (
        "insert_rows", "insert_cols", "remove_rows", "remove_cols")])
    ins_lo, ins_hi = traffic["insert_count"]
    rem_lo, rem_hi = traffic["remove_count"]
    fww_every, fww_at = int(config["fww"]["every"]), \
        int(config["fww"]["at"])
    msn_rule = config["min_seq"]

    # The layout (every message's kind and count) comes from the
    # configuration alone; the seed draws content only.
    layout = np.random.default_rng([int(config["layout_seed"]), 0x3A7])
    roll = layout.random((T, D))
    ins_n = layout.integers(ins_lo, ins_hi + 1, (T, D), dtype=np.int32)
    rem_n = layout.integers(rem_lo, rem_hi + 1, (T, D), dtype=np.int32)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x3A75])
    u_a, u_b = rng.random((T, D)), rng.random((T, D))
    val = rng.integers(0, int(traffic["values"]), (T, D), dtype=np.int32)
    fww = np.zeros(D, bool)
    fww[rng.permutation(D)[:D // fww_every]] = True
    policy_t = fww_at - 1 if fww_at <= T else -1

    kind = np.empty((T, D), np.int8)
    a = np.zeros((T, D), np.int32)
    b = np.zeros((T, D), np.int32)
    value = np.full((T, D), -1, np.int32)
    rows = np.zeros(D, np.int32)
    cols = np.zeros(D, np.int32)
    for t in range(T):
        r = roll[t]
        if t == policy_t:
            # the policy slot: a setCell in the layout
            if not ((rows > 0) & (cols > 0)).all():
                raise ValueError("the layout leaves a document without a "
                                 "grid at its policy message")
            ins_r = ins_c = rem_r = rem_c = np.zeros(D, bool)
        else:
            ins_r = (r < edges[0]) | (rows == 0)
            ins_c = ~ins_r & ((r < edges[1]) | (cols == 0))
            rest = ~ins_r & ~ins_c
            rem_r = rest & (r < edges[2]) & (rows > 2)
            rem_c = rest & ~rem_r & (r < edges[3]) & (cols > 2)
        cell = ~(ins_r | ins_c | rem_r | rem_c)
        k = np.full(D, SET_CELL, np.int8)
        k[ins_r] = INSERT_ROWS
        k[ins_c] = INSERT_COLS
        k[rem_r] = REMOVE_ROWS
        k[rem_c] = REMOVE_COLS
        span = np.where(ins_r, rows + 1, np.where(
            ins_c, cols + 1, np.where(rem_r, rows - 1, np.where(
                rem_c, cols - 1, rows))))
        pos = np.minimum((u_a[t] * span).astype(np.int64),
                         np.maximum(span - 1, 0)).astype(np.int32)
        col = np.minimum((u_b[t] * cols).astype(np.int64),
                         np.maximum(cols - 1, 0)).astype(np.int32)
        a[t] = pos
        b[t] = np.where(ins_r | ins_c, ins_n[t], np.where(
            rem_r | rem_c, pos + rem_n[t], np.where(cell, col, 0)))
        value[t] = np.where(cell, val[t], -1)
        if t == policy_t:
            k[fww] = SET_POLICY
            a[t, fww] = b[t, fww] = 0
            value[t, fww] = -1
        kind[t] = k
        rows += np.where(ins_r, ins_n[t], 0) - np.where(rem_r, rem_n[t], 0)
        cols += np.where(ins_c, ins_n[t], 0) - np.where(rem_c, rem_n[t], 0)

    seq = np.arange(1, T + 1, dtype=np.int32)
    msn = np.zeros(T, np.int32)
    cur = 0
    for i, s in enumerate(seq.tolist()):
        if s > int(msn_rule["after"]) and s % int(msn_rule["every"]) == 0:
            cur = s - int(msn_rule["lag"])
        msn[i] = cur
    kind, a, b, value = (np.ascontiguousarray(x.T) for x in
                         (kind, a, b, value))
    cells = kind == SET_CELL
    n_cells = cells.sum(axis=1).astype(np.int32)
    pool = MatrixPool(
        kind=kind, a=a, b=b, value=value, rows=rows, cols=cols, fww=fww,
        min_seq=msn,
        clients=[f"client{c}" for c in range(int(config["clients"]))],
        blobs=[], values=[], n_cells=n_cells,
        row_rows=(n_cells + ((kind == INSERT_ROWS) | (kind == REMOVE_ROWS))
                  .sum(axis=1)).astype(np.int32),
        col_rows=(n_cells + ((kind == INSERT_COLS) | (kind == REMOVE_COLS))
                  .sum(axis=1)).astype(np.int32))
    _encode(pool)
    return pool


def _value_tables(pool: MatrixPool) -> Tuple[np.ndarray, List[List[int]]]:
    """Each message's doc-local value id (first appearance, as the
    encoder interns values) and each document's value table."""
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


def _table(items: List[bytes]) -> Tuple[bytes, bytes]:
    """A table section: its ``len + 1`` int32 offsets and its bytes."""
    offs = np.zeros(len(items) + 1, "<i4")
    np.cumsum([len(x) for x in items], out=offs[1:])
    return offs.tobytes(), b"".join(items)


def _encode(pool: MatrixPool) -> None:
    """Every document's record stream, a block of documents at a time."""
    D, T = pool.kind.shape
    vloc, pool.values = _value_tables(pool)
    n_clients = len(pool.clients)
    seq = np.arange(1, T + 1, dtype=np.int32)
    client_offs, client_json = _table([f'"{c}"'.encode()
                                       for c in pool.clients])
    for lo in range(0, D, _BLOCK_DOCS):
        hi = min(D, lo + _BLOCK_DOCS)
        msgs = np.empty((hi - lo, T, MSG_FIELDS), "<i4")
        msgs[:, :, 0] = seq
        msgs[:, :, 1] = seq
        msgs[:, :, 2] = seq - 1
        msgs[:, :, 3] = pool.min_seq
        msgs[:, :, 4] = np.arange(T) % n_clients
        msgs[:, :, 5] = pool.kind[lo:hi]
        msgs[:, :, 6] = pool.a[lo:hi]
        msgs[:, :, 7] = pool.b[lo:hi]
        msgs[:, :, 8] = vloc[lo:hi]
        for j in range(hi - lo):
            d = lo + j
            table = pool.values[d]
            value_offs, value_json = _table([str(v).encode() for v in table])
            header = np.asarray(
                [MAGIC, T, len(table), n_clients, pool.n_cells[d],
                 pool.row_rows[d], pool.col_rows[d], 0], "<i4")
            pool.blobs.append(b"".join((
                header.tobytes(), msgs[j].tobytes(), value_offs,
                client_offs, value_json, client_json)))
