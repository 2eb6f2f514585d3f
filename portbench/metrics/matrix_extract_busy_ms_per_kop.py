"""The matrix family's extract leg: its busy time (``stage["extract"]``,
summed over the threads that ran its slices) over the traced window, in
ms a thousand messages."""


def read(r):
    busy = r.stage.get("extract")
    return busy * 1e3 / (r.ops / 1e3) if busy and r.ops else None
