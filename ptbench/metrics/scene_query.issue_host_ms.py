"""The host's ms a traced frame in the port's `pt0.query` span
(kernels/traverse.walk_triangles: the nudge, t_init, and the sorted query:
the sort key, argsort, gathers, streamed_kernel's launch, the scatter)."""
from ptbench import spans


def read(r):
    return spans.host_ms(r, "pt0.query")
