"""Bytes the window's passes downloaded (``stage["d2h_bytes"]``) an op."""


def read(r):
    moved = r.stage.get("d2h_bytes")
    return moved / r.ops if moved and r.ops else None
