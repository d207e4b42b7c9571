"""traverse_kernel's share of its roofline, in %: the frozen floor of the
bytes the traced frames' live queries need (forest_roofline.py) over the
kernel's time in the trace."""
from ptbench import forest_roofline


def read(r):
    t, rec = r["trace"], r["record"]
    if t is None:
        return None
    ms = sum(e - s for n, s, e in t["device"] if "traverse_kernel" in n)
    if ms <= 0.0:
        return None
    return 100.0 * forest_roofline.traverse_kernel_s(
        queries=rec.queries) / ms
