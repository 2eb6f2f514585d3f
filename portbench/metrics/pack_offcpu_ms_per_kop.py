"""The pack leg's time off the CPU: its busy time (``stage["pack"]``)
less its threads' CPU time (``stage["pack_cpu"]``), both summed over the
pack pool's threads, in ms a thousand ops.  Waiting for the interpreter
lock, or for a core, is off the CPU."""


def read(r):
    busy, cpu = r.stage.get("pack"), r.stage.get("pack_cpu")
    if busy is None or cpu is None or not r.ops:
        return None
    return (busy - cpu) * 1e3 / (r.ops / 1e3)
