"""The matrix family's pack leg: its busy time (``stage["pack"]``, summed
over the threads that ran its steps) over the traced window, in ms a
thousand messages."""


def read(r):
    busy = r.stage.get("pack")
    return busy * 1e3 / (r.ops / 1e3) if busy and r.ops else None
