"""Peak device memory allocated during the window
(``torch.cuda.max_memory_allocated()`` after a reset at its start)."""


def read(r):
    return r.peak_window_bytes / 2 ** 20 if r.on_card else None
