"""Set-up: the process's start to the window's start (imports, the CUDA
context, loading the built kernels, generation, the warm pass)."""


def read(r):
    return r.setup_s
