"""The pack leg's busy time (``stage["pack"]``, summed over the pack
pool's threads) over the traced window, in ms a thousand ops."""


def read(r):
    busy = r.stage.get("pack")
    return busy * 1e3 / (r.ops / 1e3) if busy and r.ops else None
