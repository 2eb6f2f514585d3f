"""Share of the traced window in which no kernel, copy or memset ran on
the card."""


def read(r):
    t = r.trace or {}
    if not r.on_card or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
