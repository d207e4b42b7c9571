"""Diagnostic: streamed-kernel counters and timing on the 1M terrain, by
ray population.

Counterpart of the JAX package's tools/diag_streamed.py, on the same
triangles and rays (its numpy recipe, bit for bit) through
`wavefront.trace_streamed` (csrc/streamed_kernel.cu). Four populations of
1,024 x 256 rays: camera-like primary rays and bounce-like rays from
points over the terrain, each in the reference's spatial order
(`traverse.spatial_sort_key`) or in an origin-major order
(`origin_major_key`), sorted by a plain stable argsort before the call. The
rays go to `trace_streamed` directly: `traverse.sorted_query` would sort
them once more by its own key and add the root-box and switched-off keys,
which the tool does not have.

Each population reports, per ray: the box tests, the row visits and the
pair tests they imply (row visits x the triangles of a row of st_tris),
with the kernel's ms (the min of 3 timed calls after a warm-up, each
ended by a synchronize), Mrays/s and the share of rays that hit.

The counters differ from the JAX tool's: its kernel counts per block of
1,024 rays (`bt`, `lf`; its pairs a ray are `lf.sum() x 14 x 1024 / B`),
the port's per ray. The JAX columns `bt/blk` and `gated/blk` have no
per-ray counterpart, and neither has its `block_rows=8`.

Run:  python -m pathtracer0_tpu_torch.tools.diag_streamed [n] [--device cpu]

with n = 708 (999,698 triangles) unless given. It runs on the card and
raises without one; `--device cpu` runs the plain version
(`streamed_reference`; keep n and the rays tiny) and measures no time.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..accel import lbvh
from ..config import RenderConfig
from ..core.device import resolve_device, synchronize
from ..kernels import traverse, wavefront
from ..scene.scene import Scene

# the tool's batch: 256 blocks of 1,024 rays
RAYS = 1024 * 256
# (kind, sort, label) of each population, in the tool's order; sort True is
# the reference's spatial key, "origin" the origin-major one
POPULATIONS = (("primary", True, "primary+sort"),
               ("bounce", True, "bounce+sort"),
               ("bounce", "origin", "bounce+osort"),
               ("primary", "origin", "primary+osort"))


def extent(n):
    """Half the terrain's side: 50 at n = 708, at constant density."""
    return 50.0 * (n / 708.0)


def terrain_mesh(n=708):
    """The tool's height field as a triangle soup (v1, v2, v3), each
    (2 (n - 1)^2, 3) float64: the quads' (a, b, c) triangles, then their
    (d, b, c) ones."""
    ext = extent(n)
    xs = np.linspace(-ext, ext, n)
    X, Z = np.meshgrid(xs, xs)
    Y = (np.sin(X * 0.35) * np.cos(Z * 0.28) * 1.8
         + np.sin(X * 0.09 + 1.3) * 4.0
         + np.random.RandomState(0).rand(n, n) * 0.15)
    P = np.stack([X, Y, Z], axis=-1)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[:-1, 1:].reshape(-1, 3)
    d4 = P[1:, 1:].reshape(-1, 3)
    return np.concatenate([a, d4]), np.concatenate([b, b]), \
        np.concatenate([c, c])


def terrain(n=708, *, config=None, device=None):
    """The tool's scene, `terrain_mesh(n)` in one default material under a
    constant sky, built with `config` (default RenderConfig(): streamed
    past 65,536 triangles) on `device`. Returns (PackedScene, SceneInfo)."""
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    sc.add_mesh(*terrain_mesh(n), 0)
    return sc.build(config or RenderConfig(), device=device)


def make_rays(kind, B, ext, rng):
    """B rays of `kind` from numpy RandomState `rng`, float32 (B, 3) o and
    unit d: "primary" from the camera's point through an image-plane
    window, "bounce" from random points over the terrain, downward."""
    if kind == "primary":
        o = np.tile(np.array([0.0, 14.0, -ext * 1.16], np.float32), (B, 1))
        u = rng.uniform(-0.5, 0.5, B).astype(np.float32)
        v = rng.uniform(-0.28, 0.28, B).astype(np.float32)
        d = np.stack([u, -0.35 + v, np.ones(B, np.float32)], 1)
    else:
        o = np.stack([
            rng.uniform(-ext, ext, B),
            rng.uniform(0.0, 6.0, B),
            rng.uniform(-ext, ext, B)], 1).astype(np.float32)
        d = rng.normal(size=(B, 3)).astype(np.float32)
        d[:, 1] = np.abs(d[:, 1]) * -1.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


def origin_major_key(o, d, lo, hi, o_bits=7):
    """Origin-Morton-major key of rays o, d (R, 3) in the box lo, hi (3,),
    int32, the direction's octant as a tiebreak; bit-equal to the JAX
    tool's `_origin_major_key`. The cell is cast to int32 before it is
    clipped, as there: an origin outside the box (the primary rays') gets
    a negative cell that the clip takes to 0."""
    top = 2 ** o_bits - 1
    span = torch.clamp(hi - lo, min=1e-6)
    qo = torch.clamp(((o - lo) / span * top).to(torch.int32), 0, top)
    spread = traverse._morton_spread
    m_o = ((spread(qo[:, 0]) << 2) | (spread(qo[:, 1]) << 1)
           | spread(qo[:, 2]))
    octant = (((d[:, 0] >= 0).to(torch.int32) << 2)
              | ((d[:, 1] >= 0).to(torch.int32) << 1)
              | (d[:, 2] >= 0).to(torch.int32))
    return (m_o << 3) | octant


def run(scene, info, o, d, sort, label, *, out=print):
    """One population: rays o, d (numpy (B, 3) float32) sorted by `sort`
    (False: as given), traced by `trace_streamed` from t_init = 1e30.
    Returns (row, batch): the row printed through `out`, and the
    batch as the kernel got it, ((ox, oy, oz), (dx, dy, dz), t_init,
    (t, u, v, idx, box tests, row visits), order), order mapping a
    position of the sorted batch to the ray's index in o."""
    dev = scene.device
    B = o.shape[0]
    o3 = torch.from_numpy(o).to(dev)
    d3 = torch.from_numpy(d).to(dev)
    lo, hi = scene.st_top[0, 0:3], scene.st_top[0, 3:6]
    if sort == "origin":
        order = torch.argsort(origin_major_key(o3, d3, lo, hi), stable=True)
    elif sort:
        order = torch.argsort(traverse.spatial_sort_key(o3, d3, lo, hi),
                              stable=True)
    else:
        order = torch.arange(B, device=dev)
    o3, d3 = o3[order], d3[order]
    o_soa = tuple(o3[:, i].contiguous() for i in range(3))
    d_soa = tuple(d3[:, i].contiguous() for i in range(3))
    t_init = torch.full((B,), 1e30, dtype=torch.float32, device=dev)

    def go():
        return wavefront.trace_streamed(o_soa, d_soa, t_init, scene, info)

    res = go()
    ms = None
    if dev.type == "cuda":
        synchronize(dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = go()
            synchronize(dev)
            times.append(time.perf_counter() - t0)
        ms = 1e3 * min(times)
    t, _, _, _, box, rows = res
    visits = int(rows.to(torch.int64).sum())
    hits = int((t < 1e25).sum())
    row = {"label": label, "rays": B, "tris": info.num_tris,
           "treelets": info.st_n_treelets,
           "box_tests_per_ray": int(box.to(torch.int64).sum()) / B,
           "row_visits_per_ray": visits / B,
           "pairs_per_ray": visits * lbvh.TRIS_PER_ROW / B,
           "ms": ms, "mrays_per_s": None if ms is None else B / ms / 1e3,
           "hit_pct": 100.0 * hits / B, "device": str(dev)}
    out(json.dumps(row))
    return row, (o_soa, d_soa, t_init, res, order)


def main(n=708, *, scene=None, rays=RAYS, device=None, out=print):
    """The four populations of `rays` rays each, drawn in turn from one
    RandomState(3) as the tool draws them, on `terrain(n)` (or on `scene`,
    a (PackedScene, SceneInfo) of `terrain(n)` built by the caller).
    Returns [(row, batch)] as `run` does."""
    if scene is None:
        scene = terrain(n, device=resolve_device(device))
    sc, info = scene
    if not info.streamed:
        raise ValueError("diag_streamed needs a streamed scene: more than "
                         "stream_threshold triangles, or stream_threshold=0")
    out(json.dumps({"tris": info.num_tris,
                    "treelets": info.st_n_treelets}))
    rng = np.random.RandomState(3)
    ext = extent(n)
    return [run(sc, info, *make_rays(kind, rays, ext, rng), sort, label,
                out=out)
            for kind, sort, label in POPULATIONS]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=708)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.n, device=args.device)
