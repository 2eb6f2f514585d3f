"""The extract leg's time off the CPU: its busy time
(``stage["extract"]``) less its threads' CPU time
(``stage["extract_cpu"]``), both summed over the extract pool's threads,
in ms a thousand ops.  Waiting for the interpreter lock, or for a core,
is off the CPU."""


def read(r):
    busy, cpu = r.stage.get("extract"), r.stage.get("extract_cpu")
    if busy is None or cpu is None or not r.ops:
        return None
    return (busy - cpu) * 1e3 / (r.ops / 1e3)
