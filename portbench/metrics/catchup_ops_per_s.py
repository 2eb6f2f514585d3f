"""Catch-up throughput: every op of every document whose summary the
window's passes returned, over the window's wall time (host clock, the
window ending in a device synchronize)."""


def read(r):
    return r.ops / r.window_s if r.ops else None
