"""A plain SharedMatrix replica: the reference the matrix cell's answers
are compared with, byte for byte.

Written from the published semantics of Fluid Framework's SharedMatrix
(``packages/dds/matrix``), independent of the system under test: it
imports nothing of either package and reads the record stream itself.

- Each axis is a permutation vector: an ordered list of segments, each a
  run of handles allocated in sequence, stamped with the insert's seq and
  client and, once removed, the remove's (a later overlapping remover of
  an already removed run is kept beside it).  A message sees the segments
  its view holds: inserted at or below its ``ref_seq`` or by its own
  client, and not removed at or below its ``ref_seq`` or by its own
  client.
- insertRows / insertCols place a new run after the ``pos`` visible
  handles of the view, before any segment that follows them (a removed
  one included), splitting the segment ``pos`` falls inside;
  removeRows / removeCols stamp the visible handles ``[start, end)``,
  splitting at both ends.
- setCell resolves its row and column to handles in its own view (none
  past the view's end: then it does nothing) and stores ``(value, seq,
  client)`` under the handle pair: the last writer wins, or, after
  setPolicy, a write loses to a stored value sequenced after its view by
  another client (first writer wins).
- The summary renumbers handles canonically: the segments in order, those
  removed at or below the final ``minSeq`` dropped, seqs at or below it
  written as 0 with no client, neighbours alike in every field merged;
  the cells on surviving handles by canonical row and column.

``replay(records, final_msn, control=False, work=None)`` catches a
document up from empty and returns its ``header`` and ``body`` blobs;
``control`` leaves the last message out.  ``work`` (a
``portbench.matrixwork.FoldWork``) counts the matrix fold's operations on
this replay: its segments are the fold's slots, split as it splits them
and never merged.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Tuple

INSERT_ROWS, INSERT_COLS, REMOVE_ROWS, REMOVE_COLS, SET_CELL, SET_POLICY = \
    range(1, 7)
_HEADER = struct.Struct("<8i")
_MSG = struct.Struct("<9i")


class Segment:
    __slots__ = ("first", "count", "ins_seq", "ins_client", "rem_seq",
                 "rem_client", "overlap")

    def __init__(self, first: int, count: int, ins_seq: int,
                 ins_client: Optional[str]) -> None:
        self.first, self.count = first, count
        self.ins_seq, self.ins_client = ins_seq, ins_client
        self.rem_seq: Optional[int] = None
        self.rem_client: Optional[str] = None
        self.overlap: List[str] = []

    def split(self, at: int) -> "Segment":
        """Cut this run after ``at`` handles; the right part."""
        right = Segment(self.first + at, self.count - at, self.ins_seq,
                        self.ins_client)
        right.rem_seq, right.rem_client = self.rem_seq, self.rem_client
        right.overlap = list(self.overlap)
        self.count = at
        return right


class Axis:
    """One permutation vector.  ``work`` (when given) counts what the
    matrix fold does on it (``portbench/matrixwork.py``)."""

    def __init__(self, work=None) -> None:
        self.segs: List[Segment] = []
        self.next_handle = 0
        self.work = work

    @staticmethod
    def visible(seg: Segment, ref_seq: int, client: Optional[str]) -> int:
        if not (seg.ins_seq <= ref_seq or seg.ins_client == client):
            return 0
        if seg.rem_seq is not None and (
                seg.rem_seq <= ref_seq or seg.rem_client == client
                or client in seg.overlap):
            return 0
        return seg.count

    def _split_at(self, pos: int, ref_seq: int, client) -> Optional[int]:
        """Split the segment that ``pos`` falls strictly inside (in the
        view); the left part's index, or None when no segment is split."""
        c = 0
        for i, seg in enumerate(self.segs):
            v = self.visible(seg, ref_seq, client)
            if c < pos < c + v:
                self.segs.insert(i + 1, seg.split(pos - c))
                return i
            c += v
        return None

    def _index_at(self, pos: int, ref_seq: int, client) -> int:
        """The first segment whose visible start is at or past ``pos``."""
        c = 0
        for i, seg in enumerate(self.segs):
            if c >= pos:
                return i
            c += self.visible(seg, ref_seq, client)
        return len(self.segs)

    def insert(self, pos: int, count: int, seq: int, client, ref_seq: int):
        split = self._split_at(pos, ref_seq, client)
        at = self._index_at(pos, ref_seq, client)
        if self.work is not None:
            m = len(self.segs)
            lo = at if split is None else min(split + 1, at)
            self.work.row(m, m + 1 - lo, True, 0)
        self.segs.insert(at, Segment(self.next_handle, count, seq, client))
        self.next_handle += count

    def remove(self, start: int, end: int, seq: int, client, ref_seq: int):
        splits = [self._split_at(pos, ref_seq, client)
                  for pos in (start, end)]
        covered, c = [], 0
        for seg in self.segs:
            v = self.visible(seg, ref_seq, client)
            if v and start <= c and c + v <= end:
                covered.append(seg)
            c += v
        if self.work is not None:
            m = len(self.segs)
            made = [i + 1 for i in splits if i is not None]
            self.work.row(m, m - min(made) if made else 0, False,
                          len(covered))
        for seg in covered:
            if seg.rem_seq is None:
                seg.rem_seq, seg.rem_client = seq, client
            elif client != seg.rem_client and client not in seg.overlap:
                seg.overlap.append(client)

    def handle_at(self, pos: int, ref_seq: int, client) -> Optional[int]:
        if self.work is not None:
            self.work.resolve(len(self.segs))
        c = 0
        for seg in self.segs:
            v = self.visible(seg, ref_seq, client)
            if c <= pos < c + v:
                return seg.first + pos - c
            c += v
        return None

    def canonical(self, msn: int) -> Tuple[List[dict], Dict[int, int]]:
        """The summary's records and each surviving handle's canonical
        id."""
        records: List[dict] = []
        ids: Dict[int, int] = {}
        for seg in self.segs:
            if seg.rem_seq is not None and seg.rem_seq <= msn:
                continue
            for h in range(seg.first, seg.first + seg.count):
                ids[h] = len(ids)
            s, c = (0, None) if seg.ins_seq <= msn else (seg.ins_seq,
                                                          seg.ins_client)
            rec = {"n": seg.count, "s": s, "c": c}
            if seg.rem_seq is not None:
                rec["rs"], rec["rc"] = seg.rem_seq, seg.rem_client
            if seg.overlap:
                rec["ro"] = sorted(seg.overlap)
            if records and all(records[-1].get(k) == rec.get(k)
                               for k in ("s", "c", "rs", "rc", "ro")):
                records[-1]["n"] += rec["n"]
                continue
            records.append(rec)
        return records, ids

    def count(self) -> int:
        return sum(seg.count for seg in self.segs if seg.rem_seq is None)


class Replica:
    def __init__(self, work=None) -> None:
        self.rows, self.cols = Axis(work), Axis(work)
        self.cells: Dict[Tuple[int, int], tuple] = {}
        self.fww = False
        self.seq = 0

    def set_cell(self, row: int, col: int, value, seq: int, client,
                 ref_seq: int) -> None:
        rh = self.rows.handle_at(row, ref_seq, client)
        ch = self.cols.handle_at(col, ref_seq, client)
        if rh is None or ch is None:
            return
        stored = self.cells.get((rh, ch))
        if self.fww and stored is not None and stored[1] > ref_seq \
                and stored[2] != client:
            return
        self.cells[(rh, ch)] = (value, seq, client)

    def summary(self, msn: int) -> Dict[str, bytes]:
        rows, row_ids = self.rows.canonical(msn)
        cols, col_ids = self.cols.canonical(msn)
        cells = []
        for (rh, ch), (value, seq, client) in self.cells.items():
            if rh in row_ids and ch in col_ids:
                if seq <= msn:
                    seq, client = 0, None
                cells.append([row_ids[rh], col_ids[ch], value, seq, client])
        cells.sort(key=lambda e: (e[0], e[1]))
        header = {"seq": self.seq, "minSeq": msn, "rows": self.rows.count(),
                  "cols": self.cols.count(),
                  "policy": "fww" if self.fww else "lww"}
        return {"header": canonical_json(header),
                "body": canonical_json({"rows": rows, "cols": cols,
                                        "cells": cells})}


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")


def messages(records: dict) -> List[tuple]:
    """``(seq, ref_seq, client, kind, a, b, value)`` of each message of a
    record stream, clients and values read through the tables."""
    blob = records["blob"]
    _magic, n_msgs, _nv, _nc, _cells, _rr, _cr, flags = \
        _HEADER.unpack_from(blob, 0)
    if flags & ~1:
        raise ValueError("the reference does not read timestamps")
    clients, values = records["clients"], records["values"]
    out = []
    for i in range(n_msgs):
        seq, _cseq, ref_seq, _msn, client, kind, a, b, value = \
            _MSG.unpack_from(blob, _HEADER.size + i * _MSG.size)
        out.append((seq, ref_seq, None if client == -1 else clients[client],
                    kind, a, b, values[value] if kind == SET_CELL else None))
    return out


def replay(records: dict, final_msn: int, control: bool = False,
           work=None) -> Dict[str, bytes]:
    """Summary blobs of a document caught up from empty over its record
    stream, its window at ``final_msn`` at the head; ``control`` leaves
    the last message out."""
    replica = Replica(work)
    msgs = messages(records)
    for seq, ref_seq, client, kind, a, b, value in (
            msgs[:-1] if control else msgs):
        if kind in (INSERT_ROWS, INSERT_COLS):
            axis = replica.rows if kind == INSERT_ROWS else replica.cols
            axis.insert(a, b, seq, client, ref_seq)
        elif kind in (REMOVE_ROWS, REMOVE_COLS):
            axis = replica.rows if kind == REMOVE_ROWS else replica.cols
            axis.remove(a, b, seq, client, ref_seq)
        elif kind == SET_CELL:
            replica.set_cell(a, b, value, seq, client, ref_seq)
        elif kind == SET_POLICY:
            replica.fww = True
        else:
            raise ValueError(f"the reference does not replay record kind "
                             f"{kind}")
        replica.seq = seq
    return replica.summary(final_msn)
