"""The benchmark reference's scene query of the terrain181 configuration
(ptbench/configs/terrain181.py `reference_query`: the upstream's dividing
Moller-Trumbore test over a walk of the height field's quads) against the
port's forest walk (kernels/wavefront.trace_forest, its plain version on
CPU tensors) on the configuration's CPU size (configs/terrain181.tiny.json:
n = 34, 2,178 triangles, a forest past the brute-force kernel's leaves).

Rays: the camera's, and rays aimed at the quads' shared diagonals, a
thousandth of an edge from a triangle's corners, and along grazing angles
just above the surface. The two give the same t, u and v bit for bit and
the same triangle, except at an exact tie in t, where each holds one of the
tied triangles (the first in each one's walk). Both let some rays aimed at
a diagonal through, where both triangles round u + v past 1, as the
upstream's test does. A ray aimed at a vertex itself is left out: it meets
the corner of a leaf's box, which the forest's slab test may round away,
and the corner of four cells, of which the reference's walk enters two.

The benchmark's division-free `GridQuery` (configs/terrain1m.py) parts
from the dividing test on rays that graze an edge: `test_division_free_
partings` counts the rays of each family on which it returns another
triangle or other bits, and holds each parting to an edge of a triangle.
"""
import json

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch.kernels import wavefront
from ptbench import bench
from ptbench.reference import core, tracer

MISS = 1e30
N_RAYS = 384


@pytest.fixture(scope="module")
def terrain():
    with open(bench.PKG / "configs" / "terrain181.tiny.json") as f:
        tiny = json.load(f)
    c = bench.cell("terrain181.progressive", {"config": tiny})
    scene, info, _ = bench.build_program_scene(c.config, c.config_module,
                                               torch.device("cpu"))
    mod = c.config_module
    verts, faces, xs = mod.mesh(c.config["mesh"])
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    rows = tracer.triangle_rows(v1, v2, v3, "cpu")
    return {"config": c.config, "scene": scene, "info": info,
            "module": mod, "verts": verts, "faces": faces, "rows": rows,
            "query": mod.reference_query(c.config["mesh"], verts, faces, xs,
                                         rows),
            "grid": mod.GridQuery(xs, v1, v2, v3, rows)}


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _from_above(target, rng):
    """Rays from 2-6 units off, above the surface, that end on `target`
    (float32 points)."""
    d = rng.randn(target.shape[0], 3)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d = _unit(d)
    dist = rng.uniform(2.0, 6.0, (target.shape[0], 1)).astype(np.float32)
    return (target - dist * d).astype(np.float32), d


def _rays(family, t):
    """(o, d) of one family of rays, float32 (R, 3) arrays."""
    rng = np.random.RandomState(["camera", "diagonal", "vertex",
                                 "grazing"].index(family) + 11)
    verts32 = t["verts"].astype(np.float32)
    faces = t["faces"]
    if family == "camera":
        cfg = t["config"]
        pos, rot = bench.camera(cfg, t["module"])
        r = bench.render_fields(cfg)
        w, h = 24, 16
        uv = core.pixel_uv(torch.arange(w * h), w, h)
        rotmat = core.rotation_matrix(torch.tensor(rot, dtype=torch.float32))
        d = core.primary_directions(uv, rotmat, r["cam_size"],
                                    r["focal_length"], h / float(w))
        d = _unit(d.numpy().astype(np.float64))
        o = np.broadcast_to(np.asarray(pos, np.float32), d.shape).copy()
        return o, d
    if family == "vertex":
        # a thousandth of an edge inside a triangle from one of its corners
        k = rng.randint(0, faces.shape[0], N_RAYS)
        v1, e1, e2 = (r.numpy()[k] for r in t["rows"])
        near = np.float32([[1e-3, 1e-3], [1.0 - 2e-3, 1e-3],
                           [1e-3, 1.0 - 2e-3]])[rng.randint(0, 3, N_RAYS)]
        return _from_above(v1 + near[:, :1] * e1 + near[:, 1:] * e2, rng)
    # the quads' shared diagonal: corners 1 and 2 of both triangles
    k = rng.randint(0, faces.shape[0] // 2, N_RAYS)
    b, c = verts32[faces[k, 1]], verts32[faces[k, 2]]
    s = rng.choice(np.float32([0.5, 0.25, 0.75]), (N_RAYS, 1))
    on = (b + s * (c - b)).astype(np.float32)
    if family == "diagonal":
        return _from_above(on, rng)
    # grazing: from just above a diagonal's point, nearly level
    ang = rng.uniform(0.0, 2.0 * np.pi, N_RAYS)
    d = _unit(np.stack([np.cos(ang), rng.uniform(-0.02, 0.0, N_RAYS),
                        np.sin(ang)], 1))
    o = on + np.float32([0.0, 0.03, 0.0]) - np.float32(0.4) * d
    return o.astype(np.float32), d


def _split(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                 for i in range(3))


def _forest(t, o, d):
    """(t, u, v, triangle id) of the port's forest walk."""
    t_init = torch.full((o[0].shape[0],), MISS, dtype=torch.float32)
    tf, uf, vf, row, _, _ = wavefront.trace_forest(o, d, t_init,
                                                   t["scene"], t["info"])
    got = row >= 0
    tri = torch.where(got, t["scene"].wf_perm[row.clamp(min=0).long()]
                      .long(), -1)
    return tf, uf, vf, tri


def _dividing_t(t, o, d, tri):
    """The dividing test's t of triangles `tri` (one a ray)."""
    v1, e1, e2 = (r[tri] for r in t["rows"])
    ok, tt, _, _ = t["module"].tri_divide(o, d, v1.unbind(-1), e1.unbind(-1),
                                          e2.unbind(-1))
    return torch.where(ok, tt, float("nan"))


def test_forest_is_the_configuration_route(terrain):
    info = terrain["info"]
    assert info.num_objects == 1 and not info.streamed
    assert info.num_tris == 2 * 33 ** 2
    assert not wavefront.use_brute(info)


@pytest.mark.parametrize("family", ["camera", "diagonal", "vertex",
                                    "grazing"])
def test_reference_query_equals_the_forest(terrain, family):
    o_np, d_np = _rays(family, terrain)
    o, d = _split(o_np), _split(d_np)
    alive = torch.ones(o_np.shape[0], dtype=torch.bool)
    tf, uf, vf, trif = _forest(terrain, o, d)
    tr, ur, vr, trir = terrain["query"](o, d, alive)
    hit = trif >= 0
    assert 0.15 < float(hit.float().mean())
    assert torch.equal(hit, trir >= 0)
    assert torch.equal(tf, tr)
    same = trif == trir
    assert torch.equal(uf[same], ur[same]) and torch.equal(vf[same],
                                                           vr[same])
    # an exact tie: both triangles give the walk's t under the test
    apart = (~same).nonzero()[:, 0]
    sub = tuple(c[apart] for c in o), tuple(c[apart] for c in d)
    for tri in (trif[apart], trir[apart]):
        assert torch.equal(_dividing_t(terrain, *sub, tri), tf[apart])


@pytest.mark.parametrize("family", ["camera", "diagonal", "vertex",
                                    "grazing"])
def test_division_free_partings(terrain, family):
    o_np, d_np = _rays(family, terrain)
    o, d = _split(o_np), _split(d_np)
    alive = torch.ones(o_np.shape[0], dtype=torch.bool)
    tr, ur, vr, trir = terrain["query"](o, d, alive)
    tg, ug, vg, trig = terrain["grid"](o, d, alive)
    apart = (trig != trir) | (tg != tr) | (ug != ur) | (vg != vr)
    print(f"{family}: the division-free test parts on "
          f"{int(apart.sum())} of {apart.numel()} rays, "
          f"{int(((trig >= 0) != (trir >= 0)).sum())} of them hit or miss")
    # a parting is a knife-edge: each hit of a parting ray lies on an edge
    # of its triangle
    for t, u, v, tri in ((tr, ur, vr, trir), (tg, ug, vg, trig)):
        on = apart & (tri >= 0)
        edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
        assert bool((edge[on] <= 1e-5).all())
    if family == "diagonal":
        assert bool(apart.any())
    else:
        assert not bool(apart.any())
