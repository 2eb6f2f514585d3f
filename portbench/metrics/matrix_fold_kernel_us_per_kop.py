"""Device time of the matrix fold kernel (``matrix_fold_kernel``, by name
in the traced window, whichever placement ran) in microseconds a
thousand messages."""

from portbench.matrixwork import fold_kernel_seconds


def read(r):
    seconds = fold_kernel_seconds(r.trace)
    return seconds * 1e6 / (r.ops / 1e3) if seconds and r.ops else None
