"""Pixel samples accumulated in the window over its wall time, in
Msamples/s: every frame that finished in the window, W x H x spp each."""


def read(r):
    rec = r["record"]
    if r["trace"] is not None or not rec.frame_s:
        return None
    return rec.samples / (rec.end - rec.start) / 1e6
