"""Shared wire-protocol constants, framing, and message codecs for the
TCP server/driver — plus the columnar batch-ingress wire form.

One definition point so a protocol bump can never ship a client/server
pair that disagree on the version they stamp/accept — or on the field
names a message serializes under.  Every dataclass in
``protocol/messages.py`` has exactly one encode and one decode function
here, registered in ``MESSAGE_CODECS``; drivers, the standalone server,
and the durable op log all dispatch through these instead of calling
``to_dict``/``from_dict`` at scattered call sites (fluidlint's
FL-WIRE-COMPLETE rule pins the registry exhaustive — including the wire
dataclasses defined in THIS module).

Frame layout: [4-byte big-endian length][json bytes].

Columnar ingress (SEMANTICS.md "Columnar ingress"): a
:class:`ColumnBatch` carries a whole swarm tick's raw ops as
struct-packed numpy column arrays — no per-op Python objects on the
wire or in the ingress hot path.  The payload vocabulary is CLOSED
(``set``/``increment``/``insert`` over interned key/char tables);
``materialize(i)`` reconstructs the exact boxed ``groupedBatch``
:class:`RawOperation` envelope, which is what makes the boxed path a
byte-identical oracle for the columnar one.  The sequencer's stamped
output rides :class:`OpColumnSegment`/:class:`JoinColumnSegment` — lazy
:class:`SequencedMessage` ranges that materialize per message only when
something actually consumes messages (a broadcast subscriber, a
catch-up read, a failover replay).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from typing import Sequence, Tuple

import numpy as np

from .messages import MessageType, RawOperation, SequencedMessage

WIRE_VERSION = 1
LEN = struct.Struct(">I")
MAX_FRAME = 256 << 20


def frame_bytes(obj: dict) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    return LEN.pack(len(payload)) + payload


# -- message codecs -----------------------------------------------------------


def encode_raw_operation(op: RawOperation) -> dict:
    return op.to_dict()


def decode_raw_operation(d: dict) -> RawOperation:
    return RawOperation.from_dict(d)


def encode_sequenced_message(msg: SequencedMessage) -> dict:
    return msg.to_dict()


def decode_sequenced_message(d: dict) -> SequencedMessage:
    return SequencedMessage.from_dict(d)


# -- columnar batch ingress ---------------------------------------------------

#: closed op-kind vocabulary of the columnar payload columns
COL_KIND_SET = 0        # kv channel:    {"kind": "set", "key", "value"}
COL_KIND_INCREMENT = 1  # count channel: {"kind": "increment", "delta"}
COL_KIND_INSERT = 2     # text channel:  {"kind": "insert", "pos": 0, "text"}

#: op kind -> channel name (the swarm's three attach channels)
COL_CHANNELS = ("kv", "count", "text")

#: interned payload string tables: the closed vocabulary's key and
#: single-char insert strings are built ONCE here instead of per op
#: (f"k{n}" / chr(97+i) used to be formatted inside the generation loop)
KEY_STRINGS: Tuple[str, ...] = tuple(f"k{n}" for n in range(64))
CHAR_STRINGS: Tuple[str, ...] = tuple(chr(97 + i) for i in range(26))


def key_string(n: int) -> str:
    """Interned ``f"k{n}"`` (table hit for the swarm's 32-key vocabulary)."""
    return KEY_STRINGS[n] if 0 <= n < len(KEY_STRINGS) else f"k{n}"


#: column name -> little-endian dtype, in pack order (the struct layout)
COLUMN_LAYOUT = (
    ("doc_index", "<i4"),
    ("client_index", "<i4"),
    ("client_seq", "<i8"),
    ("ref_seq", "<i8"),
    ("kind", "<i1"),
    ("key_index", "<i2"),
    ("value", "<i8"),
    ("char_index", "<i2"),
)

_COL_MAGIC = b"FCB1"
_COL_HEADER = struct.Struct(">4sII")  # magic, n_rows, tables-json bytes


@dataclasses.dataclass(eq=False)
class ColumnBatch:
    """A batch of raw client ops as parallel numpy columns.

    ``doc_index``/``client_index`` index the ``doc_ids``/``client_ids``
    string tables (shared by reference in-process; compacted to the
    referenced entries when packed to bytes).  ``client_seq``/``ref_seq``
    are the per-op sequencing numbers; ``kind`` selects the payload shape
    from the closed vocabulary above, with ``key_index``/``value``/
    ``char_index`` as its payload columns (``value`` doubles as the
    increment delta).  ``v`` is the groupedBatch envelope version the
    boxed materialization stamps; ``ds`` the target datastore id.
    """

    doc_index: np.ndarray
    client_index: np.ndarray
    client_seq: np.ndarray
    ref_seq: np.ndarray
    kind: np.ndarray
    key_index: np.ndarray
    value: np.ndarray
    char_index: np.ndarray
    doc_ids: Sequence[str]
    client_ids: Sequence[str]
    v: int = 1
    ds: str = "ds"

    def __len__(self) -> int:
        return int(self.doc_index.shape[0])

    def __eq__(self, other) -> bool:
        if not isinstance(other, ColumnBatch):
            return NotImplemented
        return (
            self.v == other.v and self.ds == other.ds
            and tuple(self.doc_ids) == tuple(other.doc_ids)
            and tuple(self.client_ids) == tuple(other.client_ids)
            and all(
                np.array_equal(getattr(self, name), getattr(other, name))
                for name, _dtype in COLUMN_LAYOUT
            )
        )

    # -- boxed equivalence -----------------------------------------------------

    def contents(self, i: int) -> dict:
        """The exact ``groupedBatch`` contents dict the boxed generator
        builds for row ``i`` — the materialization-equivalence surface
        the parity oracle pins byte-for-byte."""
        k = int(self.kind[i])
        if k == COL_KIND_SET:
            inner = {"kind": "set", "key": key_string(int(self.key_index[i])),
                     "value": int(self.value[i])}
        elif k == COL_KIND_INCREMENT:
            inner = {"kind": "increment", "delta": int(self.value[i])}
        elif k == COL_KIND_INSERT:
            inner = {"kind": "insert", "pos": 0,
                     "text": CHAR_STRINGS[int(self.char_index[i])]}
        else:
            raise ValueError(f"unknown column op kind {k}")
        sub = {"clientSeq": int(self.client_seq[i]),
               "refSeq": int(self.ref_seq[i]),
               "ds": self.ds, "channel": COL_CHANNELS[k],
               "contents": inner}
        return {"type": "groupedBatch", "v": self.v, "ops": [sub]}

    def materialize(self, i: int) -> RawOperation:
        """Row ``i`` as the boxed :class:`RawOperation` envelope — the
        per-op fallback (deferred/faulted batches) and the parity oracle."""
        return RawOperation(
            client_id=self.client_ids[int(self.client_index[i])],
            client_seq=int(self.client_seq[i]),
            ref_seq=int(self.ref_seq[i]),
            type=MessageType.OP,
            contents=self.contents(i),
        )

    def client_id(self, i: int) -> str:
        return self.client_ids[int(self.client_index[i])]

    def doc_id(self, i: int) -> str:
        return self.doc_ids[int(self.doc_index[i])]

    def take(self, rows: np.ndarray) -> "ColumnBatch":
        """A new batch holding only ``rows`` (in the given order), sharing
        the string tables by reference — the front door's per-shard split
        of one client batch.  Row order is preserved, so per-document
        stamp order is exactly the original batch's."""
        return ColumnBatch(
            doc_index=self.doc_index[rows],
            client_index=self.client_index[rows],
            client_seq=self.client_seq[rows],
            ref_seq=self.ref_seq[rows],
            kind=self.kind[rows],
            key_index=self.key_index[rows],
            value=self.value[rows],
            char_index=self.char_index[rows],
            doc_ids=self.doc_ids,
            client_ids=self.client_ids,
            v=self.v,
            ds=self.ds,
        )


def column_batch_to_bytes(batch: ColumnBatch) -> bytes:
    """Struct-pack a :class:`ColumnBatch`: fixed-dtype column buffers
    back to back, then a canonical-JSON table blob COMPACTED to the
    referenced ``doc_ids``/``client_ids`` entries (in-process producers
    share full population tables by reference; the wire carries only
    what the batch uses)."""
    n = len(batch)
    doc_u, doc_inv = np.unique(batch.doc_index, return_inverse=True)
    cli_u, cli_inv = np.unique(batch.client_index, return_inverse=True)
    compact = {
        "doc_index": doc_inv, "client_index": cli_inv,
    }
    tables = {
        "v": batch.v,
        "ds": batch.ds,
        "docs": [batch.doc_ids[int(i)] for i in doc_u.tolist()],
        "clients": [batch.client_ids[int(i)] for i in cli_u.tolist()],
    }
    blob = json.dumps(tables, sort_keys=True,
                      separators=(",", ":"), ensure_ascii=False
                      ).encode("utf-8")
    parts = [_COL_HEADER.pack(_COL_MAGIC, n, len(blob))]
    for name, dtype in COLUMN_LAYOUT:
        col = compact.get(name)
        if col is None:
            col = getattr(batch, name)
        parts.append(np.ascontiguousarray(col.astype(dtype, copy=False))
                     .tobytes())
    parts.append(blob)
    return b"".join(parts)


def column_batch_from_bytes(data: bytes) -> ColumnBatch:
    """Inverse of :func:`column_batch_to_bytes`; validates the closed
    vocabulary so a malformed peer fails loudly, not as a KeyError deep
    in materialization."""
    if len(data) < _COL_HEADER.size:
        raise ValueError("column batch frame too short")
    magic, n, blob_len = _COL_HEADER.unpack_from(data, 0)
    if magic != _COL_MAGIC:
        raise ValueError(f"bad column batch magic {magic!r}")
    offset = _COL_HEADER.size
    cols = {}
    for name, dtype in COLUMN_LAYOUT:
        width = np.dtype(dtype).itemsize
        end = offset + n * width
        if end > len(data):
            raise ValueError(f"column batch truncated in column {name!r}")
        # copy so the columns are writable, independent of the frame buffer
        cols[name] = np.frombuffer(data, dtype=dtype, count=n,
                                   offset=offset).copy()
        offset = end
    if offset + blob_len > len(data):
        raise ValueError("column batch truncated in table blob")
    tables = json.loads(data[offset:offset + blob_len].decode("utf-8"))
    batch = ColumnBatch(
        doc_ids=tuple(tables["docs"]),
        client_ids=tuple(tables["clients"]),
        v=int(tables.get("v", 1)),
        ds=str(tables.get("ds", "ds")),
        **cols,
    )
    if n:
        if int(batch.kind.min()) < COL_KIND_SET \
                or int(batch.kind.max()) > COL_KIND_INSERT:
            raise ValueError("column batch op kind outside the vocabulary")
        if int(batch.char_index.min()) < 0 \
                or int(batch.char_index.max()) >= len(CHAR_STRINGS):
            raise ValueError("column batch char index outside the vocabulary")
        if int(batch.key_index.min()) < 0 \
                or int(batch.key_index.max()) >= len(KEY_STRINGS):
            raise ValueError("column batch key index outside the vocabulary")
        if int(batch.doc_index.min()) < 0 \
                or int(batch.doc_index.max()) >= len(batch.doc_ids):
            raise ValueError("column batch doc index outside its table")
        if int(batch.client_index.min()) < 0 \
                or int(batch.client_index.max()) >= len(batch.client_ids):
            raise ValueError("column batch client index outside its table")
    return batch


def encode_column_batch(batch: ColumnBatch) -> dict:
    """Codec-registry form: the struct-packed bytes, base64'd so the
    JSON framing (`frame_bytes`) can carry them unchanged."""
    return {"packed": base64.b64encode(column_batch_to_bytes(batch))
            .decode("ascii")}


def decode_column_batch(d: dict) -> ColumnBatch:
    return column_batch_from_bytes(base64.b64decode(d["packed"]))


# -- lazy sequenced segments --------------------------------------------------


class ColumnSegment:
    """A contiguous run of sequenced messages stored columnar.

    The sequencer's columnar stamp output and the op log's columnar
    storage unit: seq numbers are ``start_seq + j`` by construction, all
    rows share one (conservative, batch-start) ``min_seq``, and
    timestamps are ``clock0 + j`` — so heads, contiguity checks, and
    durable encoding never touch per-message Python objects.
    ``materialize(j)`` rebuilds the exact boxed
    :class:`SequencedMessage`; ``wire_dict(j)`` its codec form.
    """

    __slots__ = ("start_seq", "min_seq", "clock0")

    def __init__(self, start_seq: int, min_seq: int, clock0: int) -> None:
        self.start_seq = start_seq
        self.min_seq = min_seq
        self.clock0 = clock0

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def last_seq(self) -> int:
        return self.start_seq + len(self) - 1

    def materialize(self, j: int) -> SequencedMessage:  # pragma: no cover
        raise NotImplementedError

    def prefix(self, j: int) -> "ColumnSegment":  # pragma: no cover
        raise NotImplementedError

    def messages(self):
        return [self.materialize(j) for j in range(len(self))]

    def wire_dict(self, j: int) -> dict:
        return encode_sequenced_message(self.materialize(j))


class OpColumnSegment(ColumnSegment):
    """The stamped view of a :class:`ColumnBatch` slice: ``rows`` are
    the KEPT (non-duplicate) batch row indexes, in stamp order."""

    __slots__ = ("batch", "rows")

    def __init__(self, batch: ColumnBatch, rows: np.ndarray,
                 start_seq: int, min_seq: int, clock0: int) -> None:
        super().__init__(start_seq, min_seq, clock0)
        self.batch = batch
        self.rows = rows

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def materialize(self, j: int) -> SequencedMessage:
        i = int(self.rows[j])
        return SequencedMessage(
            seq=self.start_seq + j,
            client_id=self.batch.client_id(i),
            client_seq=int(self.batch.client_seq[i]),
            ref_seq=int(self.batch.ref_seq[i]),
            min_seq=self.min_seq,
            type=MessageType.OP,
            contents=self.batch.contents(i),
            timestamp=float(self.clock0 + j),
        )

    def prefix(self, j: int) -> "OpColumnSegment":
        return OpColumnSegment(self.batch, self.rows[:j],
                               self.start_seq, self.min_seq, self.clock0)


class JoinColumnSegment(ColumnSegment):
    """A bulk-admitted JOIN cohort: one JOIN message per client id, each
    referencing the seq directly before it (the boxed ``connect_many``
    stamping shape)."""

    __slots__ = ("cohort",)

    def __init__(self, cohort: Tuple[str, ...], start_seq: int,
                 min_seq: int, clock0: int) -> None:
        super().__init__(start_seq, min_seq, clock0)
        self.cohort = cohort

    def __len__(self) -> int:
        return len(self.cohort)

    def materialize(self, j: int) -> SequencedMessage:
        return SequencedMessage(
            seq=self.start_seq + j,
            client_id=None,
            client_seq=-1,
            ref_seq=self.start_seq + j - 1,
            min_seq=self.min_seq,
            type=MessageType.JOIN,
            contents={"clientId": self.cohort[j]},
            timestamp=float(self.clock0 + j),
        )

    def prefix(self, j: int) -> "JoinColumnSegment":
        return JoinColumnSegment(self.cohort[:j], self.start_seq,
                                 self.min_seq, self.clock0)


def entry_last_seq(entry) -> int:
    """Highest seq of an op-log entry (message or columnar segment)."""
    return entry.last_seq if isinstance(entry, ColumnSegment) else entry.seq


#: class name -> (encode, decode); the dispatch surface drivers/services
#: use, and the exhaustiveness surface FL-WIRE-COMPLETE checks.
MESSAGE_CODECS = {
    "RawOperation": (encode_raw_operation, decode_raw_operation),
    "SequencedMessage": (encode_sequenced_message, decode_sequenced_message),
    "ColumnBatch": (encode_column_batch, decode_column_batch),
}
