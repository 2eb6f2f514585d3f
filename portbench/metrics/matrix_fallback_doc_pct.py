"""Share of the window's documents that the routing sent to the CPU
oracle instead of the matrix fold (``stats["fallback_docs"]``, absent
while none did); None where the window counted no document at all."""


def read(r):
    if not r.passes or ("device_docs" not in r.stats
                        and "fallback_docs" not in r.stats):
        return None
    return 100.0 * r.stats.get("fallback_docs", 0) / (r.passes * r.n_docs)
