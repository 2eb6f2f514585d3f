"""The extract leg's busy time (``stage["extract"]``, summed over the
extract pool's threads) over the traced window, in ms a thousand ops."""


def read(r):
    busy = r.stage.get("extract")
    return busy * 1e3 / (r.ops / 1e3) if busy and r.ops else None
