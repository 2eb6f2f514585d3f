"""The yardstick of the tree fold's work: operations and bytes an edit.

A frozen copy of the tree-fold arithmetic that ``chip_smoke.py`` holds
the fold kernel's bound to (``tree_fold_work`` and its ``TREE_*_OPS``
constants, without the digest, which no cell's fold writes), applied to a
chunk of sampled documents: every state word of the chunk's planes read
and written once (7 node planes of ``N`` and 2 container planes of ``C``
int32 a document, at the pack's buckets), the 8 edit planes of ``T``
read once, and the operations charged per state word, per real edit row
and per ancestor-walk step.  The sizes come from the generator's
bookkeeping and the plain reference's replay (the walk steps of every
move, the containers the edits fill), never from the system's packed
tensors, so the count is the same whatever implements the fold.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .reference import sharedtree as ref

#: integer operations charged per state word in and out, per edit row,
#: per ancestor-walk step
TREE_WORD_OPS, TREE_ROW_OPS, TREE_WALK_STEP_OPS = 2, 24, 8
#: int32 planes of a document's forest: node planes, container planes
NODE_PLANES, CONT_PLANES = 7, 2
#: edit planes
EDIT_PLANES = 8


def next_bucket(n: int, floor: int) -> int:
    """The power-of-two bucket the pack sizes an axis to."""
    size = floor
    while size < n:
        size *= 2
    return size


def containers(records: dict) -> int:
    """The containers (a node's field) a document's edits fill: the
    destination of every insert and move, and each field of inserted
    content."""
    seen = set()
    for _seq, _msn, edits in ref.messages(records):
        for kind, f in edits:
            if kind == ref.INSERT:
                seen.add((f[0], f[1]))
                stack = list(f[3])
                while stack:
                    spec = stack.pop()
                    for name, kids in spec.get("fields", {}).items():
                        seen.add((spec["id"], name))
                        stack.extend(kids)
            elif kind == ref.MOVE:
                seen.add((f[1], f[2]))
    return len(seen)


def tree_fold_work(sizes: Sequence[Tuple[int, int]], n_cont: int,
                   walk_steps: int) -> Tuple[int, int, int]:
    """``(bytes, int_ops, rows)`` the fold needs on a chunk of documents
    of ``sizes`` (nodes, edit rows), the most containers ``n_cont`` and
    ``walk_steps`` ancestor-walk steps in all."""
    D = len(sizes)
    N = next_bucket(max(n + 2 * e for n, e in sizes), 16)
    T = next_bucket(max(e for _n, e in sizes), 16)
    C = next_bucket(max(n_cont, 1), 8)
    words = D * (NODE_PLANES * N + CONT_PLANES * C)
    moved = 2 * (words * 4 + D) + EDIT_PLANES * D * T * 4
    rows = sum(e for _n, e in sizes)
    ops = words * TREE_WORD_OPS + rows * TREE_ROW_OPS \
        + walk_steps * TREE_WALK_STEP_OPS
    return moved, ops, rows


def fold_kernel_seconds(reduced) -> float:
    """Device seconds of the tree fold kernel in a reduced trace: the
    kernels named ``tree_fold_kernel`` (either placement), not the
    merge-tree fold's ``mergetree_fold_kernel``."""
    by_name = (reduced or {}).get("by_name", {})
    return sum(s for n, s in by_name.items()
               if "tree_fold_kernel" in n and "mergetree" not in n)
