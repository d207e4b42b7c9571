"""Seconds from the start of the run to the first timed frame: imports,
the CUDA context, the kernels loaded (or built, in a checkout's first run),
the scene build and the warm-up of the cell's own shapes."""


def read(r):
    return r["setup_s"]
