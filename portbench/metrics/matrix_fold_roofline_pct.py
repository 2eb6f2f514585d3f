"""The matrix fold kernel's share of its roofline: the least time the
card could take for the fold's work on the window's messages
(``portbench.matrixwork``'s operations over the int32 rate and bytes over
HBM, whichever is larger, counted on a sample of documents and scaled by
messages), over the kernel's traced device time."""

from portbench.matrixwork import fold_kernel_seconds
from portbench.work import least_seconds


def read(r):
    seconds = fold_kernel_seconds(r.trace)
    if not seconds or not r.work or not r.ops:
        return None
    least = least_seconds(r.device_kind, r.work["int_ops_per_op"] * r.ops,
                          r.work["bytes_per_op"] * r.ops)
    return 100.0 * least / seconds if least else None
