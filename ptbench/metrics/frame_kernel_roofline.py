"""frame_kernel's share of its roofline, in %: the frozen floor of the
traced frames' work (roofline.frame_kernel_s: the pixels' bytes, or the
float operations every scene query surely does, whichever takes longer at
the published peaks) over the kernel's time in the trace."""
from ptbench import roofline


def read(r):
    t, rec = r["trace"], r["record"]
    if t is None:
        return None
    ms = sum(e - s for n, s, e in t["device"] if "frame_kernel" in n)
    if ms <= 0.0:
        return None
    px = r["render"]["width"] * r["render"]["height"] * rec.frames
    floor = roofline.frame_kernel_s(
        pixels=px, queries=rec.queries, n_tris=r["info"]["n_tris"],
        n_ell=r["info"]["n_ell"], n_imp=r["info"]["n_imp"],
        n_rot=r["info"]["n_rot"], n_mats=r["info"]["n_mats"])
    return 100.0 * floor / ms
