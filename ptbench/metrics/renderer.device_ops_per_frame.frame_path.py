"""Device operations (kernels, copies, sets; the trace's lead kernels
left out) in the traced stretch over its frames: a count."""


def read(r):
    rec, t = r["record"], r["trace"]
    if t is None or not rec.frames:
        return None
    return len(t["device"]) / rec.frames
