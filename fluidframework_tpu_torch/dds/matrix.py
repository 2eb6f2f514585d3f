"""SharedMatrix — 2D collaborative grid over dual permutation merge-trees.

Capability-equivalent of the reference's matrix package (SURVEY.md §2.2:
``SharedMatrix``/``PermutationVector``/``SparseArray2D``; upstream paths
UNVERIFIED — empty reference mount).  North-star config #4.

Design (SEMANTICS.md §matrix):

- **Rows and columns each merge like text.**  A :class:`PermutationVector` is
  a merge-tree (the exact oracle from ``dds/merge_tree.py``) whose segment
  payloads are runs of *handles* — stable replica-local integers — instead of
  characters.  Row/col insert and remove therefore inherit the merge-tree's
  RGA tie-breaks, tombstones, and zamboni unchanged.
- **Cells are keyed by (row_handle, col_handle)**, not positions, so cell
  writes survive any concurrent row/col reordering.  A cell-set op carries
  *positions* resolved against the op's view ``(ref_seq, client)``; every
  replica resolves them through its own permutation vectors to its own local
  handles — handles never go on the wire.
- **Cell conflict policy**: last-writer-wins by default.  ``setPolicy`` ops
  switch the matrix (one-way) to first-writer-wins, where a sequenced set is
  *rejected* iff the cell already holds a sequenced value with
  ``stored_seq > op.ref_seq`` written by a different client — a rule that
  depends only on sequenced state, so every replica decides identically.
- **Summaries are replica-independent**: handles are renumbered canonically
  (document order over the sequenced, non-expired segments) at summary time,
  so converged replicas emit byte-identical blobs despite having allocated
  different local handles.

The device twin (``ops/matrix_kernel.py``) replays both permutation folds
with the merge-tree kernel — handle runs pack into the same ``(tstart,
tlen)`` span arrays as text spans — and reduces cell-sets over the resolved
handles.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..protocol.messages import UNASSIGNED_SEQ, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .merge_tree import MergeTreeOracle, NO_CLIENT, SegmentGroup
from .shared_object import SharedObject

TILE = 16  # SparseArray2D tile edge


class SparseArray2D:
    """Tiled sparse 2D store (reference capability: SparseArray2D): cells
    bucketed into TILE×TILE tiles keyed by handle coordinates.  Handles grow
    without bound; only touched tiles exist."""

    def __init__(self) -> None:
        self._tiles: Dict[Tuple[int, int], Dict[Tuple[int, int], Any]] = {}
        self._count = 0

    def get(self, r: int, c: int, default: Any = None) -> Any:
        tile = self._tiles.get((r // TILE, c // TILE))
        if tile is None:
            return default
        return tile.get((r % TILE, c % TILE), default)

    def set(self, r: int, c: int, value: Any) -> None:
        tile = self._tiles.setdefault((r // TILE, c // TILE), {})
        if (r % TILE, c % TILE) not in tile:
            self._count += 1
        tile[(r % TILE, c % TILE)] = value

    def delete(self, r: int, c: int) -> None:
        key = (r // TILE, c // TILE)
        tile = self._tiles.get(key)
        if tile is not None and tile.pop((r % TILE, c % TILE), None) is not None:
            self._count -= 1
            if not tile:
                del self._tiles[key]

    def __len__(self) -> int:
        return self._count

    def items(self) -> Iterator[Tuple[Tuple[int, int], Any]]:
        for (tr, tc), tile in self._tiles.items():
            for (r, c), value in tile.items():
                yield (tr * TILE + r, tc * TILE + c), value


class PermutationVector:
    """One axis's ordering: a merge-tree whose segments carry handle runs.

    Reference capability: PermutationVector — rows/cols merge like text.
    Handles are allocated sequentially per replica; identity is local, order
    is replicated.
    """

    def __init__(self) -> None:
        self.tree = MergeTreeOracle()
        self._next_handle = 0

    def alloc(self, count: int) -> Tuple[int, ...]:
        handles = tuple(range(self._next_handle, self._next_handle + count))
        self._next_handle += count
        return handles

    def visible_count(self, client: str = NO_CLIENT) -> int:
        return self.tree.length(client=client)

    def handle_at(self, pos: int, ref_seq: int, client: str,
                  up_to_seq: Optional[int] = None) -> Optional[int]:
        """Resolve a visible position in the view to a handle (None if the
        position is beyond the view's length — deterministic no-op)."""
        c = 0
        for seg in self.tree.segments:
            v = self.tree._visible_len(seg, ref_seq, client, up_to_seq)
            if v > 0 and c + v > pos:
                return seg.text[pos - c]
            c += v
        return None

    def live_handles(self) -> set:
        """Handles still physically present (incl. in-window tombstones)."""
        live = set()
        for seg in self.tree.segments:
            live.update(seg.text)
        return live

    # -- canonical summary form ------------------------------------------------

    def canonical_records(self) -> Tuple[List[dict], Dict[int, int]]:
        """(records, handle→canonical map): the merge-tree's normalized
        record list with handle runs replaced by run lengths.  Canonical
        handle = enumeration order over the normalized runs — identical
        across converged replicas.  All clamp/expire/merge rules live in
        MergeTreeOracle.normalized_records (one normalizer, one behavior)."""
        records: List[dict] = []
        handle_map: Dict[int, int] = {}
        for rec in self.tree.normalized_records():
            handles = rec.pop("t")
            for h in handles:
                handle_map[h] = len(handle_map)
            rec["n"] = len(handles)
            records.append(rec)
        return records, handle_map

    def load_records(self, records: List[dict], seq: int, min_seq: int) -> None:
        """Rebuild from canonical records; handles become 0..n-1 in document
        order (i.e. canonical ids)."""
        self._next_handle = 0
        expanded = []
        for rec in records:
            rec = dict(rec)
            rec["t"] = self.alloc(rec.pop("n"))
            expanded.append(rec)
        self.tree.load_records(expanded, seq, min_seq)


class SharedMatrix(SharedObject):
    """2D sparse collaborative matrix (north-star config #4)."""

    TYPE = "matrix-tpu"

    def __init__(self, object_id: str) -> None:
        super().__init__(object_id)
        self.rows = PermutationVector()
        self.cols = PermutationVector()
        # Sequenced cell state: (row_handle, col_handle) -> (value, seq, client).
        self._cells = SparseArray2D()
        # Optimistic overlay: (rh, ch) -> list of pending local values (last
        # one is the read view); popped front-first as acks arrive.
        self._overlay: Dict[Tuple[int, int], List[Any]] = {}
        # _policy is SEQUENCED state: it flips only when a setPolicy op is
        # processed in total order, so every replica judges every in-window
        # setCell under the same policy (flipping optimistically diverges —
        # fuzz/review-found).  _policy_local is the optimistic read view.
        self._policy = "lww"
        self._policy_local = "lww"

    # -- reads (local optimistic view) -----------------------------------------

    def _local_client(self) -> str:
        return self.client_id if self.client_id is not None else NO_CLIENT

    @property
    def row_count(self) -> int:
        return self.rows.visible_count(self._local_client())

    @property
    def col_count(self) -> int:
        return self.cols.visible_count(self._local_client())

    @property
    def policy(self) -> str:
        return self._policy_local

    def get_cell(self, row: int, col: int, default: Any = None) -> Any:
        client = self._local_client()
        rh = self.rows.handle_at(row, self.rows.tree.current_seq, client)
        ch = self.cols.handle_at(col, self.cols.tree.current_seq, client)
        if rh is None or ch is None:
            raise IndexError(f"cell ({row}, {col}) out of range")
        pending = self._overlay.get((rh, ch))
        if pending:
            return pending[-1]
        entry = self._cells.get(rh, ch)
        return entry[0] if entry is not None else default

    def to_list(self, default: Any = None) -> List[List[Any]]:
        return [
            [self.get_cell(r, c, default) for c in range(self.col_count)]
            for r in range(self.row_count)
        ]

    # -- local edits (optimistic apply, then submit) ---------------------------

    def insert_rows(self, pos: int, count: int) -> None:
        self._insert_axis(self.rows, "insertRows", pos, count)

    def insert_cols(self, pos: int, count: int) -> None:
        self._insert_axis(self.cols, "insertCols", pos, count)

    def remove_rows(self, start: int, count: int) -> None:
        self._remove_axis(self.rows, "removeRows", start, count)

    def remove_cols(self, start: int, count: int) -> None:
        self._remove_axis(self.cols, "removeCols", start, count)

    def _insert_axis(self, vec: PermutationVector, kind: str,
                     pos: int, count: int) -> None:
        if count <= 0:
            return
        client = self._local_client()
        group = SegmentGroup("insert", client=client)
        vec.tree.apply_insert(
            pos, vec.alloc(count), UNASSIGNED_SEQ, client,
            vec.tree.current_seq, group=group,
        )
        self._submit_local_op(
            {"kind": kind, "pos": pos, "count": count}, ("group", group)
        )
        if not self.is_attached:
            vec.tree.ack_insert(group, 0)

    def _remove_axis(self, vec: PermutationVector, kind: str,
                     start: int, count: int) -> None:
        if count <= 0:
            return
        client = self._local_client()
        group = SegmentGroup("remove", client=client)
        vec.tree.apply_remove(
            start, start + count, UNASSIGNED_SEQ, client,
            vec.tree.current_seq, group=group,
        )
        self._submit_local_op(
            {"kind": kind, "start": start, "end": start + count},
            ("group", group),
        )
        if not self.is_attached:
            vec.tree.ack_remove(group, 0, client)

    def set_cell(self, row: int, col: int, value: Any) -> None:
        client = self._local_client()
        rh = self.rows.handle_at(row, self.rows.tree.current_seq, client)
        ch = self.cols.handle_at(col, self.cols.tree.current_seq, client)
        if rh is None or ch is None:
            raise IndexError(f"cell ({row}, {col}) out of range")
        self._submit_local_op(
            {"kind": "setCell", "row": row, "col": col, "value": value},
            ("cell", rh, ch),
        )
        if self.is_attached:
            self._overlay.setdefault((rh, ch), []).append(value)
        else:
            self._cells.set(rh, ch, (value, 0, None))

    def switch_policy(self, policy: str = "fww") -> None:
        """One-way LWW → FWW switch (reference capability:
        switchSetCellPolicy)."""
        if policy != "fww":
            raise ValueError("only the lww->fww switch is supported")
        self._policy_local = "fww"
        self._submit_local_op({"kind": "setPolicy", "policy": "fww"}, None)
        if not self.is_attached:
            self._policy = "fww"

    def _handle_position(self, vec: PermutationVector, handle: int,
                         allowed: set) -> Optional[int]:
        """Current position of a permutation handle in the rebase view
        (sequenced state + already-regenerated pending groups), or None if
        its slot is gone from that view (sequenced-removed)."""
        c = 0
        for seg in vec.tree.segments:
            if handle in seg.text:
                if vec.tree.rebase_visible_len(seg, allowed) == 0:
                    return None
                return c + seg.text.index(handle)
            c += vec.tree.rebase_visible_len(seg, allowed)
        return None

    def _resubmit_rebased(self, pending) -> None:
        """Regenerate pending ops against the current view (removing the
        former stash-and-rehydrate-only limitation): axis ops re-target
        their permutation segments exactly as SharedString's merge-tree
        regeneration does (segment identity), and setCell regenerates
        row/col from its RESOLVED handles — dropped when either slot was
        sequenced-removed (remote replicas would resolve the same
        nothing)."""
        client = self._local_client()
        allowed_by_vec = {id(self.rows): set(), id(self.cols): set()}
        for _old_client_seq, contents, meta, _ref_seq in pending:
            kind = contents["kind"]
            if kind in ("insertRows", "insertCols",
                        "removeRows", "removeCols"):
                vec = self.rows if kind.endswith("Rows") else self.cols
                allowed = allowed_by_vec[id(vec)]
                _tag, group = meta
                segs = [s for s in vec.tree.segments
                        if group in s.pending_groups]
                for seg in segs:
                    seg.pending_groups.remove(group)
                    if group.kind == "insert":
                        vec.tree.rebase_normalize(seg, allowed)
                        pos = vec.tree.rebase_position(seg, allowed)
                        op = {"kind": kind, "pos": pos,
                              "count": len(seg.text)}
                    else:  # remove
                        if seg.removed_seq is not None \
                                and seg.removed_seq != UNASSIGNED_SEQ:
                            # A remote remove won while we were away.
                            seg.pending_overlap.discard(client)
                            continue
                        start = vec.tree.rebase_position(seg, allowed)
                        op = {"kind": kind, "start": start,
                              "end": start + len(seg.text)}
                    new_group = SegmentGroup(group.kind, client=client)
                    new_group.add(seg)
                    self._submit_local_op(op, ("group", new_group))
                    allowed.add(new_group)
            elif kind == "setCell":
                _tag, rh, ch = meta
                row = self._handle_position(self.rows, rh,
                                            allowed_by_vec[id(self.rows)])
                col = self._handle_position(self.cols, ch,
                                            allowed_by_vec[id(self.cols)])
                if row is None or col is None:
                    # The cell's row/col is gone: drop, and release the
                    # optimistic overlay entry its ack would have popped.
                    entries = self._overlay.get((rh, ch))
                    if entries:
                        entries.pop(0)
                        if not entries:
                            self._overlay.pop((rh, ch), None)
                    continue
                self._submit_local_op(
                    {"kind": "setCell", "row": row, "col": col,
                     "value": contents["value"]},
                    ("cell", rh, ch),
                )
            elif kind == "setPolicy":
                self._submit_local_op(dict(contents), None)
            else:
                raise ValueError(f"unknown pending matrix op {kind!r}")

    def apply_stashed_op(self, contents) -> None:
        kind = contents["kind"]
        if kind in ("insertRows", "insertCols"):
            self._insert_axis(self._axis_for(kind), kind,
                              contents["pos"], contents["count"])
        elif kind in ("removeRows", "removeCols"):
            self._remove_axis(self._axis_for(kind), kind, contents["start"],
                              contents["end"] - contents["start"])
        elif kind == "setCell":
            self.set_cell(contents["row"], contents["col"],
                          contents["value"])
        elif kind == "setPolicy":
            self.switch_policy(contents["policy"])
        else:
            raise ValueError(f"unknown stashed matrix op {kind!r}")

    # -- sequenced path --------------------------------------------------------

    def _axis_for(self, kind: str) -> PermutationVector:
        return self.rows if "Row" in kind else self.cols

    def _process_core(self, msg: SequencedMessage, local: bool, meta) -> None:
        op = msg.contents
        kind = op["kind"]
        client = msg.client_id
        if kind == "setPolicy":
            # One-way; idempotent on ack and remote.  Takes effect exactly at
            # this sequence position on every replica.
            self._policy = "fww"
            self._policy_local = "fww"
        elif kind == "setCell":
            self._process_set_cell(msg, local, meta)
        elif kind in ("insertRows", "insertCols"):
            vec = self._axis_for(kind)
            if local:
                tag, group = meta
                assert tag == "group"
                # The wire client id matters: after a rehydrate adoption
                # the sequenced copy carries the crashed session's id,
                # which every remote recorded as the insert attribution.
                vec.tree.ack_insert(group, msg.seq, msg.client_id)
            else:
                vec.tree.apply_insert(
                    op["pos"], vec.alloc(op["count"]), msg.seq, client,
                    msg.ref_seq,
                )
        elif kind in ("removeRows", "removeCols"):
            vec = self._axis_for(kind)
            if local:
                tag, group = meta
                assert tag == "group"
                vec.tree.ack_remove(group, msg.seq, client)
            else:
                vec.tree.apply_remove(
                    op["start"], op["end"], msg.seq, client, msg.ref_seq
                )
        else:
            raise ValueError(f"unknown matrix op kind {kind!r}")
        self._advance_window(msg.seq, msg.min_seq)

    def _process_set_cell(self, msg: SequencedMessage, local: bool, meta) -> None:
        op = msg.contents
        # Every replica resolves the op's positions in the op's own view,
        # bounded to the fold position (identical to the merge-tree ack-time
        # re-resolution rule) — so all replicas agree on the target handles.
        rh = self.rows.handle_at(op["row"], msg.ref_seq, msg.client_id, msg.seq)
        ch = self.cols.handle_at(op["col"], msg.ref_seq, msg.client_id, msg.seq)
        if local:
            tag, srh, sch = meta
            assert tag == "cell"
            pending = self._overlay.get((srh, sch))
            if pending:
                pending.pop(0)
                if not pending:
                    del self._overlay[(srh, sch)]
        if rh is None or ch is None:
            return  # op targeted beyond the view — deterministic no-op
        if self._policy == "fww":
            entry = self._cells.get(rh, ch)
            if (
                entry is not None
                and entry[1] > msg.ref_seq
                and entry[2] != msg.client_id
            ):
                return  # first sequenced writer wins; this op lost
        self._cells.set(rh, ch, (op["value"], msg.seq, msg.client_id))

    def _advance_window(self, seq: int, min_seq: int) -> None:
        for vec in (self.rows, self.cols):
            vec.tree.current_seq = max(vec.tree.current_seq, seq)
        if min_seq > self.rows.tree.min_seq:
            self.rows.tree.zamboni(min_seq)
            self.cols.tree.zamboni(min_seq)
            self._collect_dead_cells()

    def _collect_dead_cells(self) -> None:
        live_rows = self.rows.live_handles()
        live_cols = self.cols.live_handles()
        dead = [
            (rh, ch)
            for (rh, ch), _ in self._cells.items()
            if rh not in live_rows or ch not in live_cols
        ]
        for rh, ch in dead:
            self._cells.delete(rh, ch)

    def advance(self, seq: int, min_seq: int) -> None:
        self._advance_window(seq, min_seq)

    # -- summary ---------------------------------------------------------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        row_records, row_map = self.rows.canonical_records()
        col_records, col_map = self.cols.canonical_records()
        msn = self.rows.tree.min_seq
        cells = []
        for (rh, ch), (value, seq, client) in self._cells.items():
            if rh not in row_map or ch not in col_map:
                continue
            if seq <= msn:
                seq, client = 0, None
            cells.append([row_map[rh], col_map[ch], value, seq, client])
        cells.sort(key=lambda e: (e[0], e[1]))
        header = {
            "seq": self.rows.tree.current_seq,
            "minSeq": msn,
            "rows": self.rows.visible_count(),
            "cols": self.cols.visible_count(),
            "policy": self._policy,
        }
        body = {"rows": row_records, "cols": col_records, "cells": cells}
        tree = SummaryTree()
        tree.add_blob("header", canonical_json(header))
        tree.add_blob("body", canonical_json(body))
        return tree

    def load(self, summary: SummaryTree) -> None:
        import json

        header = json.loads(summary.blob_bytes("header"))
        body = json.loads(summary.blob_bytes("body"))
        self.rows.load_records(body["rows"], header["seq"], header["minSeq"])
        self.cols.load_records(body["cols"], header["seq"], header["minSeq"])
        self._cells = SparseArray2D()
        for r, c, value, seq, client in body["cells"]:
            self._cells.set(r, c, (value, seq, client))
        self._overlay.clear()
        self._policy = self._policy_local = header["policy"]
        self.discard_pending()
