"""Bytes the window's passes uploaded (``stage["h2d_bytes"]``) an op."""


def read(r):
    moved = r.stage.get("h2d_bytes")
    return moved / r.ops if moved and r.ops else None
