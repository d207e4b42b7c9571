"""How `correct` is decided: the images the window showed, at a sample of
their pixels, against the plain reference (reference/) rendering the same
frames (the same poses and frame seeds) at the same pixels.

A shown image is the mean of its frames, so the reference renders every
frame of every image the window showed, at that image's sampled pixels
alone (reference/tracer.py), and accumulates them in order. For each
quality (a complete image, or a first frame shown alone) the number
compared is the relative error pooled over its images,
err.<quality> = sum |program - reference| / sum |reference| over the
pixels and channels; its limit is in limits/<workload>.json. A path that
the card and the reference follow apart (a knife-edge in a comparison or
a last-ulp difference of a transcendental) changes a pixel's mean by a
share of its samples; a wrong or missing sample, frame or pixel, or a
lower precision, moves the error by an order or more (PERF.md gives the
readings each limit was set from).

The reference runs after the window has closed and the program's state is
freed, on the same device, in blocks of rays.
"""
from __future__ import annotations

import torch

from .reference import tracer


def reference_images(ref_scene, render, images, *, dtype, sum_order):
    """The reference's values of each image, (P, 3) float32 each: its
    frames rendered at its pixels from its pose, then accumulated in
    order. The frames of images of one pose and pixel count go through
    the reference together, each at its image's pixels, so its blocks
    hold many images' rays."""
    groups = {}
    for k, im in enumerate(images):
        groups.setdefault((im.pos, im.rot, im.idx.numel()), []).append(k)
    out = [None] * len(images)
    for (pos, rot, _), ks in groups.items():
        index = torch.cat([images[k].idx.expand(len(images[k].seeds), -1)
                           for k in ks])
        frames, _ = tracer.render_frames(
            ref_scene, render, pos, rot, index,
            [s for k in ks for s in images[k].seeds], dtype=dtype,
            sum_order=sum_order)
        f0 = 0
        for k in ks:
            f1 = f0 + len(images[k].seeds)
            out[k] = tracer.display(frames[f0:f1].to(torch.float32))
            f0 = f1
    return out


def numbers(images, program, reference):
    """{err.<quality>: pooled relative error} and per image errors. A
    pixel value that is not finite on both sides the same way (a path that
    drew a uniform of exactly 0 takes log(0), on the card and in the
    reference alike) agrees; one that is not finite on one side alone is
    an infinite error."""
    num, den, per = {}, {}, []
    for im, p, r in zip(images, program, reference):
        p = p.to(torch.float32)
        pf, rf = torch.isfinite(p), torch.isfinite(r)
        same = (torch.isnan(p) & torch.isnan(r)) | (p == r)
        apart = bool(((pf != rf) | (~pf & ~rf & ~same)).any())
        d = float(torch.where(pf & rf, (p - r).abs(), 0.0).sum())
        d = float("inf") if apart else d
        s = float(torch.where(rf, r.abs(), 0.0).sum())
        num[im.quality] = num.get(im.quality, 0.0) + d
        den[im.quality] = den.get(im.quality, 0.0) + s
        per.append((im.quality, d / max(s, 1e-30)))
    return ({f"err.{q}": num[q] / max(den[q], 1e-30) for q in num}, per)


def judge(values: dict, limits: dict, per_image):
    """(correct, failed images, {name: {"value", "limit"}}). A number a
    limit names that the run has nothing of fails."""
    checks, ok = {}, True
    for name, lim in limits["numbers"].items():
        v = values.get(name)
        checks[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not (v <= lim["limit"]):
            ok = False
    failed = sum(1 for q, e in per_image
                 if not (e <= limits["numbers"].get(
                     f"err.{q}", {"limit": 0.0})["limit"]))
    return ok, failed, checks
