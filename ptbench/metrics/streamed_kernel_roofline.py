"""streamed_kernel's share of its roofline, in %: the frozen floor of the
bytes the traced frames' live queries need (roofline.streamed_kernel_s)
over the kernel's time in the trace."""
from ptbench import roofline


def read(r):
    t, rec = r["trace"], r["record"]
    if t is None:
        return None
    ms = sum(e - s for n, s, e in t["device"] if "streamed_kernel" in n)
    if ms <= 0.0:
        return None
    return 100.0 * roofline.streamed_kernel_s(queries=rec.queries) / ms
