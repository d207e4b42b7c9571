"""bounce_kernel's share of its roofline, in %, its path and camera forms
together: the frozen floor of the bytes the traced frames' bounces and
samples need (roofline.bounce_kernel_s) over the kernel's time in the
trace."""
from ptbench import roofline


def read(r):
    t, rec = r["trace"], r["record"]
    if t is None:
        return None
    ms = sum(e - s for n, s, e in t["device"] if "bounce_kernel" in n)
    if ms <= 0.0:
        return None
    w, h = r["render"]["width"], r["render"]["height"]
    spp = r["render"]["samples_per_frame"]
    floor = roofline.bounce_kernel_s(
        queries=rec.queries, paths=rec.frames * w * h * spp, pixels=w * h,
        spp=spp, frames=rec.frames, perm=r["info"]["streamed"])
    return 100.0 * floor / ms
