"""The fold+export kernel's share of its roofline: the least time the
card could take for the fold's work on the window's documents
(``portbench.work``: operations over the int32 rate, bytes over HBM,
whichever is larger), counted on the reference's replay of a sample of
documents and scaled by ops, over the kernel's traced device time."""

from portbench.trace import kernel_seconds
from portbench.work import least_seconds


def read(r):
    seconds = kernel_seconds(r.trace, "mergetree_fold_kernel")
    if not seconds or not r.work or not r.ops:
        return None
    least = least_seconds(r.device_kind, r.work["int_ops_per_op"] * r.ops,
                          r.work["bytes_per_op"] * r.ops)
    return 100.0 * least / seconds if least else None
