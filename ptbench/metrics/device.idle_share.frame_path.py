"""The share of the traced stretch's wall time in which no device
operation ran, in %: 1 - the union of the device's busy intervals over the
stretch (the benchmark's ptbench.window span)."""
from ptbench.trace import busy_s


def read(r):
    t = r["trace"]
    if t is None:
        return None
    lo, hi = t["window"]
    return 100.0 * (1.0 - busy_s(t["device"], lo, hi) / (hi - lo))
