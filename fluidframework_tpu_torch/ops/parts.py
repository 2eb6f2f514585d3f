"""Per-part trees of a device list: the placement of the doc-sharded
fold (``parallel/shard.py``) and of the tier-2.5 cache under a mesh.

A batch of ``D`` documents splits along its leading (document) axis into
``n`` equal contiguous parts, in mesh order: part ``i`` holds rows
``[i * D / n, (i + 1) * D / n)`` and lives on the mesh's ``i``-th device.
A :class:`Parts` holds one tree (a namedtuple of tensors, a plain tuple,
a single tensor) per part; every kernel wrapper launches on the device
its tensors lie on, so the per-part launches need no collective and the
host reassembles the results in order.  A device list may name one card
more than once: the parts then run one after another on that card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def map_leaves(fn, tree):
    """``fn`` over every leaf of a tree of arrays or tensors: a namedtuple
    keeps its type, a plain tuple stays a tuple (a family's aux may be
    either, or a single leaf), another tuple type (``ops.parts.Parts``)
    keeps its type, None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        leaves = [map_leaves(fn, x) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*leaves)
        return tuple(leaves) if type(tree) is tuple else type(tree)(leaves)
    return fn(tree)


class Parts(tuple):
    """One tree per part of a device list, in mesh order."""

    def __new__(cls, items=()):
        return super().__new__(cls, items)


def bounds(n_rows: int, n_parts: int) -> List[Tuple[int, int]]:
    """The row range of each part: ``n_rows`` must split evenly (the
    sharded fold pads its batch to a multiple of the part count first)."""
    if n_parts <= 0 or n_rows % n_parts:
        raise ValueError(f"{n_rows} rows do not split into {n_parts} "
                         "equal parts")
    step = n_rows // n_parts
    return [(i * step, (i + 1) * step) for i in range(n_parts)]


def _rows(tree) -> int:
    lead = tree
    while isinstance(lead, tuple):
        lead = lead[0]
    return int(lead.shape[0])


def put_on(x, device) -> torch.Tensor:
    """A copy of a host array (or tensor) on ``device`` — always a copy,
    as ``DevicePackCache.put``: resident tensors are spliced in place."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, copy=True)


def put_parts(tree, devices: Sequence[torch.device]):
    """``tree`` placed over ``devices``: a host tree is split along its
    document axis into ``len(devices)`` parts and part ``i`` copied to
    ``devices[i]``; a :class:`Parts` (host copies of a placed tree) has
    each part copied back to its device.  None stays None."""
    if tree is None:
        return None
    if isinstance(tree, Parts):
        return Parts(map_leaves(lambda x, d=dev: put_on(x, d), part)
                     for part, dev in zip(tree, devices))
    return Parts(map_leaves(lambda x, lo=lo, hi=hi, d=dev:
                            put_on(x[lo:hi], d), tree)
                 for (lo, hi), dev in zip(bounds(_rows(tree),
                                                 len(devices)), devices))


def per_part(fn, *trees):
    """``fn`` over each part of ``trees`` (Parts of one length), or over
    the trees themselves when they are not placed on parts."""
    if isinstance(trees[0], Parts):
        return Parts(fn(*xs) for xs in zip(*trees))
    return fn(*trees)
