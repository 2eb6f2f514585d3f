"""The yardstick of the matrix fold's work: operations and bytes a
message.

A frozen copy of the fold-work arithmetic that ``chip_smoke.py`` holds
the matrix fold (K4) to (``fold_work_of`` and its constants, and the
matrix phase's bytes: ``state_out_bytes`` of the axis streams plus their
resolved handles), applied to both axis streams of a chunk of sampled
documents.  Per real row of an axis stream (an insert or a remove):

- one visible-length test and scan add over every slot live at the row
  (``VIEW_SCAN_OPS_PER_SLOT``), after its boundary splits;
- one write per state word the row moves: every plane of each slot from
  its first split (or its insert index) on;
- the insert's own slot and decision (``INSERT_ROW_OPS``), a remove's
  tail over each slot it covers (``RANGE_OPS_PER_SLOT_REMOVE``).

Per resolve row (one on each stream a setCell), one view and scan over
the slots live at the row.  Bytes: the streams' state in and out, their
op rows and the resolved handles once, at the pack's buckets.  The slots
and rows come from the plain reference's replay
(``reference/sharedmatrix.py``, whose segments split as the fold's slots
do), never from the system's packed tensors, so the count is the same
whatever implements the fold.
"""

from __future__ import annotations

from typing import Sequence, Tuple

#: per live slot of a row: the visible-length test (~15) and a scan add
VIEW_SCAN_OPS_PER_SLOT = 16
#: per insert row: the tie-break and the obliterate-on-arrival decision
INSERT_ROW_OPS = 40
#: per covered slot: a remove's tail
RANGE_OPS_PER_SLOT_REMOVE = 8
#: state planes of a slot besides its property planes, and the property
#: key planes of a matrix stream
SLOT_PLANES, PROPS_K = 12, 1
#: op row fields besides the property values
OP_ROW_FIELDS = 9


class FoldWork:
    """Counts the fold's operations row by row as a replica replays."""

    def __init__(self) -> None:
        self.int_ops = 0
        self.rows = 0
        self.resolves = 0

    def row(self, m: int, moved: int, is_insert: bool, covered: int) -> None:
        """An insert or remove row: ``m`` slots live after its splits
        (before an insert's own), ``moved`` slots shifted, ``covered``
        slots a remove stamps."""
        self.int_ops += (m * VIEW_SCAN_OPS_PER_SLOT
                         + moved * (SLOT_PLANES + PROPS_K)
                         + int(is_insert) * INSERT_ROW_OPS
                         + covered * RANGE_OPS_PER_SLOT_REMOVE)
        self.rows += 1

    def resolve(self, n: int) -> None:
        """A resolve row on a stream of ``n`` live slots."""
        self.int_ops += n * VIEW_SCAN_OPS_PER_SLOT
        self.resolves += 1


def next_bucket(n: int, floor: int) -> int:
    """The power-of-two bucket the pack sizes an axis to."""
    size = floor
    while size < n:
        size *= 2
    return size


def buckets(stream_rows: Sequence[int]) -> Tuple[int, int]:
    """``(S, T)`` of a cold chunk whose streams hold ``stream_rows`` rows
    each: the rows' bucket (at least 16), and twice the rows' bucket of
    slots (at least 32)."""
    most = max(stream_rows, default=1)
    return next_bucket(2 * most, 32), next_bucket(most, 16)


def matrix_fold_bytes(n_docs: int, S: int, T: int) -> int:
    """The bytes the fold moves on ``n_docs`` documents (two streams
    each): every state word in and out, each op row once and each
    resolved handle once, int32."""
    D2 = 2 * n_docs
    state = D2 * ((SLOT_PLANES + PROPS_K) * S * 4 + 4 + 1)
    return 2 * state + D2 * T * (OP_ROW_FIELDS + PROPS_K) * 4 + D2 * T * 4


def fold_kernel_seconds(reduced) -> float:
    """Device seconds of the matrix fold kernel (``matrix_fold_kernel``,
    either placement) in a reduced trace."""
    by_name = (reduced or {}).get("by_name", {})
    return sum(s for n, s in by_name.items() if "matrix_fold_kernel" in n)
