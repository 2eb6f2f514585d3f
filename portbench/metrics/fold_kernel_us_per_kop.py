"""Device time of the fold+export kernel (``mergetree_fold_kernel``, by
name in the traced window) in microseconds a thousand ops."""

from portbench.trace import kernel_seconds


def read(r):
    seconds = kernel_seconds(r.trace, "mergetree_fold_kernel")
    return seconds * 1e6 / (r.ops / 1e3) if seconds and r.ops else None
