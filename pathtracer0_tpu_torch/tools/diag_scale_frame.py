"""Per-bounce attribution for the 1M-triangle scale frame: the frame at
max_bounces 1, 2 and 3 and spp 1 and 2; the differences attribute wall
time to each bounce.

Counterpart of the JAX package's tools/diag_scale_frame.py: its terrain
(`diag_streamed.terrain_mesh`) in its rough material, its camera, 800x600,
blur 0, no autofocus, through `render_frame` (the streamed route:
csrc/streamed_kernel.cu once a sample and bounce). Each setting renders a
warm-up frame, then 3 timed frames, each with a fresh seed from
random.Random(1234) and ended by a synchronize; a row reports the least
ms, the live scene queries of the last frame (exact) and Mrays/s.

Run:  python -m pathtracer0_tpu_torch.tools.diag_scale_frame [n]
                                                   [--device cpu]

with n = 708 (999,698 triangles) unless given. It runs on the card and
raises without one; `--device cpu` renders one frame a setting through
the plain versions (keep n tiny) and measures no time.
"""
from __future__ import annotations

import argparse
import json
import random
import time

from ..config import RenderConfig
from ..core.device import resolve_device, synchronize
from ..render.renderer import render_frame
from ..scene.scene import Scene
from .diag_streamed import extent, terrain_mesh

SETTINGS = tuple((spp, bounces) for spp in (1, 2) for bounces in (1, 2, 3))


def terrain(n=708, *, device=None):
    """`terrain_mesh(n)` in the scale benchmark's rough material ("terrain":
    Kd (0.45, 0.52, 0.38), Pr 1.0) under a constant sky, built with
    RenderConfig() (streamed past 65,536 triangles) on `device`."""
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("terrain")
    sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_mesh(*terrain_mesh(n), 0)
    return sc.build(RenderConfig(), device=device)


def camera(n=708):
    """The tool's camera: (0, 14, -1.16 ext) pitched down by 0.25."""
    return (0.0, 14.0, -extent(n) * 1.16), (0.25, 0.0, 0.0)


def main(n=708, *, size=(800, 600), cam=None, device=None, out=print):
    """Every setting of SETTINGS on `terrain(n)` at `size`, from
    `camera(n)` unless `cam` ((position, rotation)) is given (tests give a
    tiny size and a camera that sees a tiny terrain). Returns the rows:
    spp, bounces, ms, live queries, Mrays/s and the seed of the frame
    whose queries they are."""
    dev = resolve_device(device)
    sc, info = terrain(n, device=dev)
    pos, rot = cam or camera(n)
    on_card = dev.type == "cuda"
    rng = random.Random(1234)
    rows = []
    for spp, bounces in SETTINGS:
        cfg = RenderConfig(width=size[0], height=size[1],
                           samples_per_frame=spp, max_bounces=bounces,
                           auto_focus=False, blur=0.0)

        def frame(seed):
            return render_frame(sc, info, cfg, pos, rot, seed, device=dev)

        seed = rng.randrange(1, 2 ** 31)
        _, q = frame(seed)
        times = []
        if on_card:
            synchronize(dev)
            for _ in range(3):
                seed = rng.randrange(1, 2 ** 31)
                t0 = time.perf_counter()
                _, q = frame(seed)
                synchronize(dev)
                times.append(time.perf_counter() - t0)
        queries = int(q.sum())
        ms = 1e3 * min(times) if times else None
        row = {"spp": spp, "bounces": bounces, "width": size[0],
               "height": size[1], "ms": ms, "live_queries": queries,
               "mrays_per_s": None if ms is None else queries / ms / 1e3,
               "seed": seed, "device": str(dev)}
        out(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=708)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.n, device=args.device)
