"""Share of the window's documents that the routing sent to the CPU
oracle instead of the device fold (``stats["fallback_docs"]``)."""


def read(r):
    if not r.passes:
        return None
    return 100.0 * r.stats.get("fallback_docs", 0) / (r.passes * r.n_docs)
