"""Decompose the 4M-triangle scale scene's build: the whole
`Scene.build` on the card, then each large table's size and the rate of
copying it alone from the host.

Counterpart of the JAX package's tools/diag_build4m.py: the scale
benchmark's terrain (`diag_scale_frame.terrain`, n = 1416: 4,004,450
triangles) built with RenderConfig() (the streamed LBVH) and timed to a
synchronize; then, for every PackedScene field of at least 4 MB, its
shape, its MB and the seconds and MB/s of `torch.from_numpy(host copy)
.to(device)` ended by a synchronize; then the total bytes of every field.

Run:  python -m pathtracer0_tpu_torch.tools.diag_build4m [n] [--device cpu]

It runs on the card and raises without one; `--device cpu` builds on the
CPU (keep n small) and measures no time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..core.device import resolve_device, synchronize
from .diag_scale_frame import terrain

# fields below this many bytes are not copied alone
PUT_MIN_BYTES = 4_000_000


def main(n=1416, *, device=None, out=print):
    """Build `terrain(n)` on `device` and split its bytes by field. Returns
    (record, scene, info): the record holds build_s, the fields of at least
    PUT_MIN_BYTES (name, shape, MB, put_s, MB/s) and total_mb."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    scene, info = terrain(n, device=dev)
    synchronize(dev)
    build_s = time.perf_counter() - t0
    out(json.dumps({"n": n, "tris": info.num_tris, "streamed": info.streamed,
                    "build_s": build_s if on_card else None}))
    total = 0
    fields = []
    for f in dataclasses.fields(scene):
        arr = getattr(scene, f.name)
        nbytes = arr.numel() * arr.element_size()
        total += nbytes
        if nbytes < PUT_MIN_BYTES:
            continue
        row = {"field": f.name, "shape": list(arr.shape), "mb": nbytes / 1e6,
               "put_s": None, "mb_per_s": None}
        if on_card:
            host = arr.cpu().numpy()
            t0 = time.perf_counter()
            put = torch.from_numpy(host).to(dev)
            synchronize(dev)
            dt = time.perf_counter() - t0
            row.update(put_s=dt, mb_per_s=nbytes / 1e6 / dt)
            del put
        out(json.dumps(row))
        fields.append(row)
    rec = {"n": n, "tris": info.num_tris, "streamed": info.streamed,
           "build_s": build_s if on_card else None, "fields": fields,
           "total_bytes": total, "total_mb": total / 1e6, "device": str(dev)}
    out(json.dumps({"total_mb": rec["total_mb"]}))
    return rec, scene, info


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1416)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.n, device=args.device)
