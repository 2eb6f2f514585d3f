"""Binary message records for SharedMatrix documents, the native matrix
pack and the native matrix summary writer.

The ingestion side (the sequencer's log, a load generator) encodes each
matrix document's messages ONCE into the flat record stream documented in
``csrc/matrixpack.cpp`` (``encode_matrix_ops``: pure Python, run once per
message).  Clients and values become indices into the document's own
tables, numbered by first appearance, and the tables travel beside the
stream as their canonical JSON, so that neither the pack nor the writer
touches a Python object.  A ``MatrixDocInput`` carrying ``records`` may
leave ``ops`` empty: the stream is authoritative, and ``decode_matrix_ops``
gives the messages back (the oracle's route, and the Python pack's where a
chunk mixes records with messages).

``pack_records`` fills the ``MTOps`` planes of
``matrix_kernel.pack_matrix_batch`` for a batch of such documents with no
base summary, bit for bit, and each document's cell table, in C++
(``libmatrixpack``, built from the source by the content-hashed rule of
``ops/native_pack.py``; the interpreter lock is released around each
call); :class:`RecordPack` is that pack as steps over document ranges,
which the pipeline runs on several threads.  Such a batch is cold: its
state is the fill (``matrix_kernel.matrix_fill_state``), which the fold
builds itself, so the native pack returns None in its place.  Without a
toolchain it returns None and the Python pack runs on the decoded
messages.

``write_summaries`` is the extract side: the same library writes the
``header`` and ``body`` blobs of ``matrix_kernel.summary_from_matrix_state``
for a slice's natively packed documents from their downloaded axis planes
and resolved handles (the canonical records, the handle renumbering and
the LWW / FWW cell fold), one call, the interpreter lock released.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import canonical_json
from .interning import Interner, next_bucket

MAGIC = 0x3158524D
#: record kinds, by message kind
R_INSERT_ROWS, R_INSERT_COLS, R_REMOVE_ROWS, R_REMOVE_COLS, R_SET_CELL, \
    R_SET_POLICY = range(1, 7)
_KINDS = {"insertRows": R_INSERT_ROWS, "insertCols": R_INSERT_COLS,
          "removeRows": R_REMOVE_ROWS, "removeCols": R_REMOVE_COLS,
          "setCell": R_SET_CELL, "setPolicy": R_SET_POLICY}
_NAMES = {v: k for k, v in _KINDS.items()}
#: each kind's message keys and the two of them a record carries in a / b
_KEYS = {"insertRows": ("pos", "count"), "insertCols": ("pos", "count"),
         "removeRows": ("start", "end"), "removeCols": ("start", "end"),
         "setCell": ("row", "col"), "setPolicy": ()}
_MSG_KEYS = {name: {"kind", *keys} for name, keys in _KEYS.items()}
_MSG_KEYS["setCell"].add("value")
_MSG_KEYS["setPolicy"].add("policy")
#: header flags: a message without a client; timestamps follow the messages
F_NULL_CLIENT, F_TIMESTAMPS = 1, 2
HEADER_FIELDS, MSG_FIELDS, CELL_FIELDS = 8, 9, 6
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


@dataclasses.dataclass
class MatrixRecords:
    """One document's messages as a record stream, with its tables:
    ``clients`` and ``values`` by first appearance (their JSON rides in
    ``blob``), the setCell messages (``n_cells``) and the rows of each
    axis stream (``row_rows`` / ``col_rows``: its inserts and removes and
    one a setCell), as the header holds them."""

    blob: bytes
    clients: List[str]
    values: List[Any]
    n_cells: int
    row_rows: int
    col_rows: int


def _int32(v, what: str) -> int:
    if type(v) is not int or not _I32_MIN <= v <= _I32_MAX:
        raise ValueError(f"matrix records cannot carry the {what} {v!r}")
    return v


def _table_section(items: Sequence[Any]) -> Tuple[np.ndarray, bytes]:
    """Each item's canonical JSON, back to back, and the ``len + 1``
    offsets where each lies."""
    parts = [canonical_json(x) for x in items]
    offs = np.zeros(len(parts) + 1, np.int32)
    np.cumsum([len(p) for p in parts], out=offs[1:])
    return offs, b"".join(parts)


def encode_matrix_ops(msgs: Sequence[SequencedMessage]) -> MatrixRecords:
    """A matrix document's messages (ascending seq) → its record stream and
    tables.  Raises ValueError for what the records cannot carry exactly
    (a message that is not an op, an unknown kind or key, a position
    outside int32, a policy other than ``fww``, two values that intern
    alike but differ): such a document keeps its messages."""
    clients, values = Interner(), Interner()
    rows = np.empty((len(msgs), MSG_FIELDS), np.int64)
    stamps = np.empty(len(msgs), np.float64)
    flags = n_cells = row_rows = col_rows = 0
    for i, msg in enumerate(msgs):
        op = msg.contents
        kind = op.get("kind") if isinstance(op, dict) else None
        if msg.type is not MessageType.OP or kind not in _KINDS \
                or set(op) != _MSG_KEYS[kind] \
                or (kind == "setPolicy" and op["policy"] != "fww"):
            raise ValueError(f"matrix records cannot carry {op!r}")
        if msg.client_id is None:
            client = -1
            flags |= F_NULL_CLIENT
        elif isinstance(msg.client_id, str):
            client = clients.intern(msg.client_id)
        else:
            raise ValueError(f"matrix records cannot carry the client "
                             f"{msg.client_id!r}")
        a, b = [_int32(op[key], key) for key in _KEYS[kind]] or [0, 0]
        value = -1
        if kind == "setCell":
            v = op["value"]
            try:
                value = values.intern(v)
                same = canonical_json(values.values[value]) \
                    == canonical_json(v)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"matrix records cannot carry the value "
                                 f"{v!r}") from exc
            if not same:
                # 1 and True (or 0.0 and -0.0) share an interning key, and
                # the table would give back the first
                raise ValueError(f"matrix records cannot carry both "
                                 f"{values.values[value]!r} and {v!r}")
            n_cells += 1
            row_rows += 1
            col_rows += 1
        elif kind.endswith("Rows"):
            row_rows += 1
        elif kind.endswith("Cols"):
            col_rows += 1
        rows[i] = (_int32(msg.seq, "seq"), _int32(msg.client_seq,
                                                  "client_seq"),
                   _int32(msg.ref_seq, "ref_seq"),
                   _int32(msg.min_seq, "min_seq"), client, _KINDS[kind], a,
                   b, value)
        stamps[i] = float(msg.timestamp)
    if np.any(stamps != 0.0):
        flags |= F_TIMESTAMPS
    value_offs, value_json = _table_section(values.values)
    client_offs, client_json = _table_section(clients.values)
    header = np.asarray([MAGIC, len(msgs), len(values), len(clients),
                         n_cells, row_rows, col_rows, flags], np.int32)
    parts = [header.tobytes(), rows.astype(np.int32).tobytes()]
    if flags & F_TIMESTAMPS:
        parts.append(stamps.tobytes())
    parts += [value_offs.tobytes(), client_offs.tobytes(), value_json,
              client_json]
    return MatrixRecords(blob=b"".join(parts), clients=clients.values,
                         values=values.values, n_cells=n_cells,
                         row_rows=row_rows, col_rows=col_rows)


def _sections(rec: MatrixRecords):
    """``(header, messages [M, 9], timestamps or None)`` of a stream."""
    blob = rec.blob
    header = np.frombuffer(blob, np.int32, HEADER_FIELDS)
    if int(header[0]) != MAGIC:
        raise ValueError("malformed matrix record stream")
    m = int(header[1])
    off = 4 * HEADER_FIELDS
    msgs = np.frombuffer(blob, np.int32, m * MSG_FIELDS, off).reshape(
        m, MSG_FIELDS)
    off += 4 * m * MSG_FIELDS
    stamps = None
    if int(header[7]) & F_TIMESTAMPS:
        stamps = np.frombuffer(blob, np.float64, m, off)
    return header, msgs, stamps


def decode_matrix_ops(rec: MatrixRecords) -> List[SequencedMessage]:
    """The messages ``rec`` was encoded from (the oracle's route)."""
    _header, msgs, stamps = _sections(rec)
    out = []
    for i, (seq, cseq, ref, msn, client, kind, a, b, value) in enumerate(
            msgs.tolist()):
        name = _NAMES[kind]
        if kind == R_SET_POLICY:
            contents = {"kind": name, "policy": "fww"}
        else:
            first, second = _KEYS[name]
            contents = {"kind": name, first: a, second: b}
            if kind == R_SET_CELL:
                contents["value"] = rec.values[value]
        out.append(SequencedMessage(
            seq=seq, client_id=None if client == -1 else rec.clients[client],
            client_seq=cseq, ref_seq=ref, min_seq=msn, type=MessageType.OP,
            contents=contents,
            timestamp=0.0 if stamps is None else float(stamps[i])))
    return out


# -- the native library --------------------------------------------------------


_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_lock = threading.Lock()


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled matrix packer, or None (the Python pack runs).  The
    first call builds it; the pack pool's threads may make that call at
    once."""
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib = _bind()
            _lib_tried = True
    return _lib


def _bind() -> Optional[ctypes.CDLL]:
    from .native_pack import build_native

    path = build_native("matrixpack")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    ptr = ctypes.c_void_p
    lib.matrixpack_fill.restype = ctypes.c_int
    lib.matrixpack_fill.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), ptr, ctypes.c_int32,
        ctypes.POINTER(ptr), ptr, ptr, ptr, ctypes.POINTER(ctypes.c_int32)]
    lib.matrixpack_extract.restype = ptr
    lib.matrixpack_extract.argtypes = (
        [ctypes.c_int32, ptr, ctypes.POINTER(ptr), ptr, ptr, ptr,
         ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p)]
        + [ptr] * 10)
    lib.matrixpack_size.restype = ctypes.c_int64
    lib.matrixpack_size.argtypes = [ptr]
    lib.matrixpack_take.restype = None
    lib.matrixpack_take.argtypes = [ptr, ptr]
    return lib


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


class RecordDocPack:
    """A document's bookkeeping as the native pack leaves it: the
    ``matrix_kernel._MatrixDocPack`` fields the summary routes read, its
    clients and values as the records' own tables (``values``: the
    Python route reads a record document's values here, not from the
    batch's interner), its cells as rows of the chunk's cell table."""

    base_cells = ()
    base_policy = "lww"
    base_seq = 0

    def __init__(self, records: MatrixRecords, cells: np.ndarray,
                 fww: int) -> None:
        self.records = records
        self.clients = TableInterner(records.clients)
        self.values = TableInterner(records.values)
        self._cells = cells
        self.fww_from_seq = None if fww < 0 else fww

    @property
    def cells(self) -> List[tuple]:
        """(seq, ref_seq, client, value, row row, col row) of each setCell
        message, in seq order."""
        return [tuple(c) for c in self._cells.tolist()]


def buckets(recs: Sequence[MatrixRecords]) -> Tuple[int, int]:
    """``(S, T)`` of ``pack_matrix_batch`` for documents with no base
    summary: every stream's rows to the power-of-two bucket (at least
    16), twice that to the slot bucket (at least 32)."""
    most = max((max(r.row_rows, r.col_rows) for r in recs), default=1)
    return next_bucket(2 * most, floor=32), next_bucket(most, floor=16)


def axis_width(recs: Sequence[MatrixRecords], S: int) -> int:
    """The slots any stream of a cold batch can hold after its fold: an
    insert adds at most two (a split and its own), a remove at most two
    splits; at most ``S``."""
    most = max((max(r.row_rows, r.col_rows) - r.n_cells for r in recs),
               default=0)
    return max(1, min(S, 2 * most))


class RecordPack:
    """The native record pack of one batch, cut into ``k`` document ranges
    and run a step at a time, so that the ranges' steps can run on
    several threads (each native step releases the interpreter lock):

    1. ``intern()``: the buckets, the cell table's offsets, and every
       plane allocated once for the batch (no value or client is interned
       across documents: each keeps its own tables);
    2. ``begin(j)``: fill range ``j``'s rows of the planes and its cells
       (``matrixpack_fill``);
    3. ``size()``: check every range;
    4. ``finish(j)``: nothing (the fill is whole);
    5. ``join()``: the meta, and ``pack_records``'s result.

    The steps take the pipeline's ``slice_pack`` contract
    (``tree_native.RecordPack``'s).  A malformed stream names the first
    such document of the batch."""

    def __init__(self, lib, docs, k: int) -> None:
        self.lib, self.docs = lib, docs
        D = len(docs)
        self.cuts = [D * j // k for j in range(k + 1)]
        self.rcs = [0] * k
        self.bad = [-1] * k

    def intern(self) -> None:
        from .mergetree_kernel import MTOps

        self.recs = [doc.records for doc in self.docs]
        D = len(self.recs)
        self.S, self.T = buckets(self.recs)
        self.lens = np.fromiter((len(r.blob) for r in self.recs), np.int64, D)
        self.cell_at = np.zeros(D + 1, np.int64)
        np.cumsum(np.fromiter((r.n_cells for r in self.recs), np.int64, D),
                  out=self.cell_at[1:])
        self.cells = np.empty((int(self.cell_at[-1]), CELL_FIELDS), np.int32)
        self.facts = np.empty((D, 4), np.int32)
        self.op = {f: np.empty((2 * D, self.T), np.int32)
                   for f in MTOps._fields}
        self.op["pvals"] = self.op["pvals"].reshape(2 * D, self.T, 1)
        self.planes = [self.op[f] for f in MTOps._fields]

    def begin(self, j: int) -> None:
        lo, hi = self.cuts[j], self.cuts[j + 1]
        if hi == lo:
            return
        blobs = (ctypes.c_char_p * (hi - lo))(
            *[r.blob for r in self.recs[lo:hi]])
        ptrs = (ctypes.c_void_p * len(self.planes))(
            *[a[2 * lo:].ctypes.data for a in self.planes])
        at = self.cell_at[lo:hi] - self.cell_at[lo]
        bad = ctypes.c_int32(-1)
        self.rcs[j] = self.lib.matrixpack_fill(
            hi - lo, blobs, self.lens[lo:].ctypes.data, self.T, ptrs,
            self.cells[self.cell_at[lo]:].ctypes.data, at.ctypes.data,
            self.facts[lo:].ctypes.data, ctypes.byref(bad))
        self.bad[j] = bad.value

    def size(self) -> None:
        for j, rc in enumerate(self.rcs):
            if rc != 0:
                doc = self.docs[self.cuts[j] + self.bad[j]]
                what = "malformed" if rc == -1 else f"longer than T={self.T}"
                raise ValueError(f"{doc.doc_id}: matrix record stream "
                                 f"{what}")

    def finish(self, j: int) -> None:
        return

    def join(self):
        from .mergetree_kernel import MTOps

        cells, at, facts = self.cells, self.cell_at, self.facts
        packs = [RecordDocPack(rec, cells[at[d]:at[d + 1]],
                               int(facts[d, 0]))
                 for d, rec in enumerate(self.recs)]
        meta = {"packs": packs, "doc_packs": packs, "values": None,
                "docs": self.docs, "cold": True, "S": self.S,
                "width": axis_width(self.recs, self.S), "cells": cells,
                "cell_lo": np.ascontiguousarray(at[:-1]),
                "cell_hi": np.ascontiguousarray(at[1:]),
                "fww": np.ascontiguousarray(facts[:, 0]),
                "native_docs": len(self.docs),
                "resolve_rows": 2 * int(at[-1])}
        return None, MTOps(**self.op), meta

    def close(self) -> None:
        return


def pack_records(docs):
    """``pack_matrix_batch``'s ``MTOps`` and a meta for documents that all
    carry records and no base summary, from the native library: ``(None,
    ops, meta)`` (the state of a cold batch is its fill), the steps of
    :class:`RecordPack` over one range, on this thread.  None without the
    library.  The meta counts the documents packed here (``native_docs``)
    and the resolve rows (``resolve_rows``)."""
    lib = load_library()
    if lib is None:
        return None
    pack = RecordPack(lib, docs, 1)
    pack.intern()
    pack.begin(0)
    pack.size()
    return pack.join()


# -- the native summary writer ------------------------------------------------


#: the axis planes the writer reads, in its order
WRITER_PLANES = ("tstart", "tlen", "ins_seq", "ins_client", "rem_seq",
                 "rem_client", "rem2_client")
#: the writer's statuses: written; an axis overflowed; a plane or table
#: outside what the writer reads (the Python route decides it)
WRITTEN, OVERFLOW, OUTSIDE = 0, 1, 2


def write_summaries(meta: dict, arr: dict, rows: Sequence[int]):
    """The ``header`` and ``body`` bytes ``summary_from_matrix_state``
    writes for the natively packed documents at ``rows`` of ``meta``, from
    the downloaded planes ``arr`` (``[D, 2, W]`` axis planes by name, ``n``
    and ``overflow`` ``[D, 2]``, ``resolved`` ``[D, 2, T]``), one call of
    the native writer with the interpreter lock released: per row
    ``(header, body, cells)``, or ``(None, None, status)`` where the writer
    left the document to the Python route.  None without the library."""
    lib = load_library()
    if lib is None:
        return None
    k = len(rows)
    planes = [np.ascontiguousarray(arr[f], np.int32) for f in WRITER_PLANES]
    n = np.ascontiguousarray(arr["n"], np.int32)
    overflow = np.ascontiguousarray(arr["overflow"], np.uint8)
    resolved = np.ascontiguousarray(arr["resolved"], np.int32)
    W, T = planes[0].shape[2], resolved.shape[2]
    docs, packs = meta["docs"], meta["doc_packs"]
    blobs = (ctypes.c_char_p * k)(*[packs[d].records.blob for d in rows])
    lens = np.fromiter((len(packs[d].records.blob) for d in rows), np.int64, k)
    idx = np.asarray(rows, np.intp)
    cell_lo = np.ascontiguousarray(meta["cell_lo"][idx], np.int64)
    cell_hi = np.ascontiguousarray(meta["cell_hi"][idx], np.int64)
    fww = np.ascontiguousarray(meta["fww"][idx], np.int32)
    seq = np.fromiter((docs[d].final_seq for d in rows), np.int64, k)
    msn = np.fromiter((docs[d].final_msn for d in rows), np.int64, k)
    row_idx = np.asarray(rows, np.int32)
    offs = np.empty(2 * k + 1, np.int64)
    n_cells = np.empty(k, np.int64)
    status = np.empty(k, np.int32)
    ptrs = (ctypes.c_void_p * len(planes))(*[a.ctypes.data for a in planes])
    handle = lib.matrixpack_extract(
        k, row_idx.ctypes.data, ptrs, n.ctypes.data, overflow.ctypes.data,
        resolved.ctypes.data, W, T, blobs, lens.ctypes.data,
        meta["cells"].ctypes.data, cell_lo.ctypes.data, cell_hi.ctypes.data,
        fww.ctypes.data, seq.ctypes.data, msn.ctypes.data, offs.ctypes.data,
        n_cells.ctypes.data, status.ctypes.data)
    out = np.empty(int(lib.matrixpack_size(handle)), np.uint8)
    lib.matrixpack_take(handle, out.ctypes.data if out.size else None)
    buf = out.tobytes()
    offs, n_cells, status = offs.tolist(), n_cells.tolist(), status.tolist()
    return [(buf[offs[2 * i]:offs[2 * i + 1]],
             buf[offs[2 * i + 1]:offs[2 * i + 2]], n_cells[i])
            if status[i] == WRITTEN else (None, None, status[i])
            for i in range(k)]
