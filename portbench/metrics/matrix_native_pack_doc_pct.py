"""Share of the window's documents that the native matrix record pack
packed (``stats["native_pack_docs"]``); None where the program keeps no
such counter."""


def read(r):
    native = r.stats.get("native_pack_docs")
    if native is None or not r.passes:
        return None
    return 100.0 * native / (r.passes * r.n_docs)
