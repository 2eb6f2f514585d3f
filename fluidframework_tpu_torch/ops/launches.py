"""Every kernel wrapper's launch counter in one place.

Each wrapper counts the launches of its kernel and nothing else
(``fold_cuda.fold.launches`` and its per-placement split, and the like);
:func:`launch_counts` reads them all under one set of names and
:func:`reset_launches` sets them all to 0.  A shard host reports its own
process's counts in its ``stats`` RPC, since a launch in a shard process
never reaches the counters of the process that drives it.
"""

from __future__ import annotations

from typing import Dict


def reset_launches() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    from . import (fold_cuda, map_lww_cuda, matrix_fold_cuda, resident_cuda,
                   tree_fold_cuda)

    fold_cuda.reset_launches()
    matrix_fold_cuda.reset_launches()
    resident_cuda.reset_launches()
    tree_fold_cuda.reset_launches()
    map_lww_cuda.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Launches since the last reset: each build of the merge-tree fold by
    placement (``fold_smem``, ``fold_export_gmem``, ...), the matrix fold
    by placement (``matrix_fold_*``), ``map_lww``, the resident
    ``splice_rows`` and ``widen_resident``, and each build of the tree
    fold by placement (``tree_fold_*``, ``tree_fold_digest_*``)."""
    from . import (fold_cuda, map_lww_cuda, matrix_fold_cuda, resident_cuda,
                   tree_fold_cuda)

    counts = {f"{entry.__name__}_{where}": n
              for entry in (fold_cuda.fold, fold_cuda.fold_export)
              for where, n in entry.placements.items()}
    counts.update({f"matrix_fold_{where}": n for where, n in
                   matrix_fold_cuda.fold_resolving.placements.items()})
    counts["map_lww"] = map_lww_cuda.lww.launches
    counts["splice_rows"] = resident_cuda.splice_rows.launches
    counts["widen_resident"] = resident_cuda.widen_resident.launches
    counts.update({f"tree_{entry.__name__}_{where}": n
                   for entry in (tree_fold_cuda.fold,
                                 tree_fold_cuda.fold_digest)
                   for where, n in entry.placements.items()})
    return counts
