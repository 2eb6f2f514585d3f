"""The yardstick of the fold's work: operations and bytes, and the peaks.

A frozen copy of the fold-work arithmetic that ``chip_smoke.py`` holds
its kernel bounds to (``fold_work_of`` and its constants), counted here
from the plain reference's own replay of the documents (the live
segments at each op), never from the system's packed tensors, so the
count is the same whatever implements the fold.  Per real op row:

- one visible-length test and scan add over every slot live at the row
  (``VIEW_SCAN_OPS_PER_SLOT``);
- one write per state word the row moves: every plane of each slot from
  its first boundary split (or its insert index) on;
- the insert's own slot and decision (``INSERT_ROW_OPS``);
- the range tail over each slot the op covers: a remove's
  (``RANGE_OPS_PER_SLOT``), an annotate's per property key.

The fold+export build then writes every live slot's state words once.
Bytes count each op row's fields and each exported word at one byte, a
floor that no transfer layout goes under, so the bytes term can never
raise a share of the bound.
"""

from __future__ import annotations

from typing import Optional

#: per live slot of an op row: the visible-length test (~15) and a scan add
VIEW_SCAN_OPS_PER_SLOT = 16
#: per insert row: the tie-break and the obliterate-on-arrival decision
INSERT_ROW_OPS = 40
#: per covered slot: a remove's tail
RANGE_OPS_PER_SLOT_REMOVE = 8
#: per covered slot and property key: an annotate's tail
ANNOTATE_OPS_PER_SLOT_PER_KEY = 2
#: state planes of a slot besides its property planes
SLOT_PLANES = 12
#: op row fields besides the property values
OP_ROW_FIELDS = 9
#: property key planes the fold carries (the key vocabulary's bucket, at
#: least one)
PROPS_K = 1

#: Peaks by ``torch.cuda.get_device_name()``: int32 lanes x clock, and
#: HBM bytes/s.  H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#: (Hopper architecture white paper), 3.35 TB/s (data sheet).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int32_ops_per_s": 132 * 64 * 1.98e9,
                              "hbm_bytes_per_s": 3.35e12},
}


class FoldWork:
    """Counts the fold's operations row by row as a replica replays."""

    def __init__(self) -> None:
        self.int_ops = 0
        self.live_slots = 0
        self.rows = 0
        self.final_slots = 0

    def row(self, kind: int, m: int, splits: list, insert_at: Optional[int],
            covered: int) -> None:
        """One op row: ``m`` slots live after its boundary splits (before
        an insert's own slot), the indices of the slots it split,
        the insert's index, and the slots a range op covers."""
        planes = SLOT_PLANES + PROPS_K
        is_ins = insert_at is not None
        lo = min((i + 1 for i in splits), default=None)
        if is_ins:
            lo = insert_at if lo is None else min(lo, insert_at)
        moved = m + int(is_ins) - lo if lo is not None else 0
        tail = {1: 0, 2: RANGE_OPS_PER_SLOT_REMOVE,
                3: ANNOTATE_OPS_PER_SLOT_PER_KEY * PROPS_K}[kind]
        self.int_ops += (m * VIEW_SCAN_OPS_PER_SLOT + moved * planes
                         + int(is_ins) * INSERT_ROW_OPS + covered * tail)
        self.live_slots += m
        self.rows += 1

    def finish(self, final_slots: int) -> None:
        """The replay's end: the slots the export writes."""
        self.final_slots += final_slots


def export_ops(final_slots: int) -> int:
    """The export's work: every state word of every live slot, once."""
    return final_slots * (SLOT_PLANES + PROPS_K)


def io_bytes(op_rows: int, final_slots: int) -> int:
    """Each op row read once and each exported word written once, at one
    byte a field."""
    return op_rows * (OP_ROW_FIELDS + PROPS_K) \
        + final_slots * (SLOT_PLANES + PROPS_K)


def least_seconds(device_kind: str, int_ops: float,
                  nbytes: float) -> Optional[float]:
    """The least time the card could take: the larger of the operations
    over its int32 rate and the bytes over its memory bandwidth; None for
    a card with no entry in ``PEAKS``."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    return max(int_ops / peak["int32_ops_per_s"],
               nbytes / peak["hbm_bytes_per_s"])
