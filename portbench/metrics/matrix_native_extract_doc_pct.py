"""Share of the documents the matrix family's device route served whose
header and body the native summary writer wrote
(``stage["extract_native_docs"]`` over ``stats["device_docs"]``); None
where the program keeps no such counter."""


def read(r):
    native, device = r.stage.get("extract_native_docs"), \
        r.stats.get("device_docs")
    if native is None or not device:
        return None
    return 100.0 * native / device
