"""Device time of the tree fold kernel (``tree_fold_kernel``, by name in
the traced window, whichever placement ran) in microseconds a thousand
edits."""

from portbench.treework import fold_kernel_seconds


def read(r):
    seconds = fold_kernel_seconds(r.trace)
    return seconds * 1e6 / (r.ops / 1e3) if seconds and r.ops else None
