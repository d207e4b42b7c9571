"""The scene query: closest hit over the SAH forest (or, for a streamed
scene, the two-level LBVH), the implicit surfaces and the ellipsoids
(rayScene, frag.glsl:548-653), and the attributes at the hit.

Counterpart of the JAX package's kernels/traverse.py. Vectors are
(x, y, z) tuples of (R,) tensors, as everywhere in the port.

  walk_triangles  nudge the origins by 1e-4 d (frag.glsl:549), walk the
                  forest (kernels/wavefront.trace_forest) or, where
                  `info.streamed`, the LBVH (wavefront.trace_sorted on
                  the card, whose kernels nudge too): the closest
                  triangle alone, as a `Walk`; CUDA tensors take the
                  kernels, CPU tensors their plain versions. The
                  per-bounce route hands it to the bounce kernel
                  (kernels/bounce.py), which merges and shades
  ray_scene       walk_triangles, then the hit record (`walk_hit`) with
                  the analytic primitives merged (`_merge_analytic_batched`)
  surface_sample  normal, UV, tangent and material at the final hits, once
                  per ray; both routes of the renderer shade from it
  probe_forest_t  closest triangle distance only (the Whitted subsurface
                  thickness probe, frag.glsl:662-676)
  heat_counts     the per-ray traversal counters of the whole scene query
  object_heat_counts  those of one object's walk alone, from no hit (the
                  debug heatmap's, frag.glsl:534, 539-547)
  spatial_sort_key  the JAX package's ray-coherence key. A streamed query
                  is sorted by it, as that package's
                  `_ray_scene_streamed(sort_rays=True)` does
                  (`streamed_order`): rays that miss the LBVH's root box,
                  then switched-off rays, go to the back, in a stable
                  order; the walk takes the sorted rays and its outputs
                  are scattered back. The walk is per ray, so the results
                  are those of the rays as given, bit for bit; the sort
                  makes neighbouring lanes of a warp walk the same part
                  of the tree. On the card `wavefront.trace_sorted` does
                  all of it in three launches (sort_key_kernel, the
                  argsort, the walk); its plain twin `sorted_query` sorts
                  from SORT_MIN_RAYS rays, as the JAX package does.

Reference quirks kept: an implicit surface's hit parameter is measured in
its local frame and compared with world distances as it is, and every hit
location is nudged origin + t d.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import sqrt
from ..shade import bsdf, implicits
from ..utils.trace import span
from . import wavefront
from .intersect import MISS, ellipsoid_soa, safe_inv_dir

NUDGE = float(np.float32(1e-4))       # frag.glsl:549
HIT_T = 1e25                          # t below this is a hit (frag.glsl:634)
# the JAX package sorts a streamed query that fills one block of 1,024 rays
SORT_MIN_RAYS = 1024


class Hit(NamedTuple):
    """rayScene result (raySceneResult, frag.glsl:83-96) over (R,) rays."""

    t: torch.Tensor       # distance; 1e30 = miss, 0 on a switched-off ray
    tri: torch.Tensor     # int64 triangle id, -1 if none
    u: torch.Tensor       # barycentric u, v
    v: torch.Tensor
    obj: torch.Tensor     # int64 root node of the object hit (its ordinal
                          # in a streamed scene), -1 if none
    kind: torch.Tensor    # int64: 0 none, 1 triangle, 2 implicit, 3 ellipsoid
    prim: torch.Tensor    # int64 implicit / ellipsoid index, -1 otherwise

    @property
    def is_hit(self):
        """Also true on a switched-off ray (t = 0): mask with `alive`."""
        return self.t < HIT_T


class Walk(NamedTuple):
    """The closest triangle of each ray from a walk (or the brute-force
    loop), before the analytic primitives."""

    t: torch.Tensor       # float32 distance; t_init where no triangle
    u: torch.Tensor       # barycentric u, v of that triangle
    v: torch.Tensor
    row: torch.Tensor     # int32 row of the walked table, -1 if none
    perm: object          # int32 table row -> triangle id (wf_perm,
                          # st_perm), or None where the row is the id


class SurfaceSample(NamedTuple):
    """Attributes at the closest hit."""

    loc: tuple            # hit location, nudged origin + t d
    norm: tuple           # shading normal before any flip
    tangent: tuple        # UV tangent, orthogonal to norm; 0 without UVs
    uv: tuple             # GL (u, v), v flipped; (-1, -1) without UVs
    mat: torch.Tensor     # int64 material id, -1 on a miss
    has_uv: torch.Tensor  # bool: a triangle hit that carries UVs


def _row(tab, k):
    return [tab[k, i] for i in range(tab.shape[1])]


def _mat3(r, v):
    return (r[0] * v[0] + r[1] * v[1] + r[2] * v[2],
            r[3] * v[0] + r[4] * v[1] + r[5] * v[2],
            r[6] * v[0] + r[7] * v[1] + r[8] * v[2])


def _mat3_t(r, v):
    return (r[0] * v[0] + r[3] * v[1] + r[6] * v[2],
            r[1] * v[0] + r[4] * v[1] + r[7] * v[2],
            r[2] * v[0] + r[5] * v[1] + r[8] * v[2])


def _implicit_frame(scene, info, k, o, d):
    """Ray (o, d) in implicit k's local frame, and its table row."""
    r = _row(scene.imp_tab, k)
    lo = ((o[0] - r[0]) / r[3], (o[1] - r[1]) / r[4], (o[2] - r[2]) / r[5])
    ld = (d[0] / r[3], d[1] / r[4], d[2] / r[5])
    if info.imp_rotated[k]:
        lo, ld = _mat3(r[8:17], lo), _mat3(r[8:17], ld)
    return lo, ld, r


def _ellipsoid_frame(scene, info, e, o, d):
    r = _row(scene.ell_tab, e)
    if info.ell_rotated[e]:
        return _mat3(r[8:17], o), _mat3(r[8:17], d), r
    return o, d, r


def _merge_analytic_batched(o, d, scene, info, hit: Hit) -> Hit:
    """Merge every implicit surface, then every ellipsoid, into `hit`
    (frag.glsl:578-631). One primitive after the other with a strict
    t < closest, so the first of equal distances wins on every device."""
    t, tri, obj, kind, prim = hit.t, hit.tri, hit.obj, hit.kind, hit.prim
    tests = []
    for k in range(info.num_implicits):
        lo, ld, _ = _implicit_frame(scene, info, k, o, d)
        tk, found = implicits.march(info.imp_fn_ids[k], *lo, *ld)
        tests.append((2, k, tk, found))
    for e in range(info.num_ellipsoids):
        ro, rd, r = _ellipsoid_frame(scene, info, e, o, d)
        te, disc = ellipsoid_soa(ro, rd, r[0:3], r[3:6], r[6])
        tests.append((3, e, te, (disc > 0.0) & (te > 0.0)))
    for code, k, tk, valid in tests:
        ok = valid & (tk < t)
        t = torch.where(ok, tk, t)
        kind = torch.where(ok, code, kind)
        prim = torch.where(ok, k, prim)
        tri = torch.where(ok, -1, tri)
        obj = torch.where(ok, -1, obj)
    return Hit(t, tri, hit.u, hit.v, obj, kind, prim)


def _t_init(like, active):
    if active is None:
        return torch.full_like(like, MISS)
    return torch.where(active, MISS, 0.0)


def _query(o, d, scene, info, active):
    """The triangle query of a scene with a tree from the origins o, not
    yet nudged: (nudged origins, (t, u, v, idx, counter, counter)) from
    `_t_init`. A streamed query of CUDA rays is `wavefront.trace_sorted`
    (three launches that nudge, sort and walk); one of CPU rays nudges
    here and `sorted_query`s the plain walk; a forest query walks
    `wavefront.trace_forest`."""
    if info.streamed and o[0].is_cuda:
        return wavefront.trace_sorted(o, d, active, scene, info)
    on = nudged(o, d)
    t_init = _t_init(on[0], active)
    if info.streamed:
        return on, sorted_query(wavefront.trace_streamed, on, d, t_init,
                                scene, info)
    return on, wavefront.trace_forest(on, d, t_init, scene, info)


def has_tree(info) -> bool:
    """Whether the scene's triangles lie under a forest or an LBVH."""
    return info.num_objects > 0 or info.streamed


def nudged(o, d):
    return tuple(o[i] + NUDGE * d[i] for i in range(3))


def walk_triangles(o, d, scene, info, *, active=None):
    """The first half of `ray_scene`: nudge the origins, then walk the
    forest or the LBVH (`_query`), for the closest triangle alone.
    `active` as in `ray_scene`; a scene with no tree walks nothing
    (row -1, t = t_init).

    Returns (Walk, nudged origins)."""
    with span("pt0.query"):
        if has_tree(info):
            on, (t, u, v, idx, _, _) = _query(o, d, scene, info, active)
            perm = scene.st_perm if info.streamed else scene.wf_perm
            return Walk(t, u, v, idx, perm), on
        on = nudged(o, d)
        t_init = _t_init(on[0], active)
        zero = torch.zeros_like(t_init)
        none = torch.full(t_init.shape, -1, dtype=torch.int32,
                          device=t_init.device)
        return Walk(t_init, zero, zero, none, None), on


def walk_hit(walk: Walk, scene) -> Hit:
    """The hit record of a walk's triangle, before the analytic
    primitives: the row mapped to its triangle id and object."""
    got = walk.row >= 0
    row = torch.clamp(walk.row, min=0).to(torch.int64)
    tri = row if walk.perm is None else walk.perm[row].to(torch.int64)
    tri = torch.where(got, tri, -1)
    obj = torch.where(
        got, scene.tri_obj[torch.clamp(tri, min=0)].to(torch.int64), -1)
    return Hit(walk.t, tri, walk.u, walk.v, obj, got.to(torch.int64),
               torch.full_like(tri, -1))


def ray_scene(o, d, scene, info, *, active=None):
    """Closest hit of rays o + t d. `active` (R,) bool switches rays off:
    they cost nothing and come back t = 0, tri = -1. The forest or
    streamed kernels walk CUDA tensors, their plain versions CPU tensors.

    Returns (Hit, nudged origins)."""
    walk, on = walk_triangles(o, d, scene, info, active=active)
    return _merge_analytic_batched(on, d, scene, info,
                                   walk_hit(walk, scene)), on


def probe_forest_t(o, d, scene, info):
    """Distance to the closest triangle of the whole forest, or of the
    streamed LBVH, from the nudged origins (1e30 if none)."""
    return walk_triangles(o, d, scene, info)[0].t


def heat_counts(o, d, scene, info):
    """Per-ray (box tests, leaf visits) of the forest walk; of a streamed
    scene (box tests, row visits)."""
    out = _query(o, d, scene, info, None)[1]
    return out[4], out[5]


def object_heat_counts(o, d, scene, info, k: int):
    """Per-ray (box tests, leaf visits) of object k's walk alone from the
    nudged origins, with no closer hit to prune it (t_init = MISS): on the
    card `traverse_kernel` with that root only, on the CPU
    `traverse_reference` over that root (wavefront.walk_object)."""
    on = nudged(o, d)
    out = wavefront.walk_object(on, d, _t_init(on[0], None), scene, info, k)
    return out[4], out[5]


def _morton_spread(v):
    """Two zero bits between each of the low 10 bits of int32 `v`."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


_KEY_CONSTANTS = {}


def _key_constants(device, o_bits, d_bits):
    """(largest cell per column, shift of each column's spread bits, shift
    of each direction-sign bit) of `spatial_sort_key` on `device`, made
    once: a tensor made from a list on the card is a synchronous copy."""
    k = (device, o_bits, d_bits)
    if k not in _KEY_CONSTANTS:
        _KEY_CONSTANTS[k] = tuple(torch.tensor(v, dtype=torch.int32,
                                               device=device) for v in (
            [2 ** o_bits - 1] * 3 + [2 ** d_bits - 1] * 3,
            [2 + 3 * d_bits, 1 + 3 * d_bits, 3 * d_bits, 2, 1, 0],
            [2, 1, 0]))
    return _KEY_CONSTANTS[k]


def spatial_sort_key(o, d, scene_lo, scene_hi, o_bits: int = 5,
                     d_bits: int = 4):
    """Ray-coherence sort key of rays o, d (R, 3) inside the box scene_lo,
    scene_hi (3,), int32, octant-major: the three direction-sign bits
    lead, then the Morton code of the origin's cell, then that of the unit
    direction's. Bit-equal to the JAX package's `_spatial_sort_key`. The
    six cells are spread in one pass and their bits, which do not overlap,
    summed into place, so a query costs a few dozen small launches."""
    top, shift, sign_shift = _key_constants(o.device, o_bits, d_bits)
    span = torch.clamp(scene_hi - scene_lo, min=1e-6)
    dn = d / torch.clamp(sqrt(torch.sum(d * d, dim=-1, keepdim=True)),
                         min=1e-20)
    x = torch.cat([(o - scene_lo) / span * (2 ** o_bits - 1),
                   (dn * 0.5 + 0.5) * (2 ** d_bits - 1)], dim=-1)
    q = torch.minimum(torch.clamp(x.to(torch.int32), min=0), top)
    pos = (d >= 0).to(torch.int32) << sign_shift
    return (torch.sum(_morton_spread(q) << shift, dim=-1, dtype=torch.int32)
            | (torch.sum(pos, dim=-1, dtype=torch.int32)
               << (3 * (o_bits + d_bits))))


def streamed_keys(o, d, t_init, root):
    """The keys by which the JAX package's `_ray_scene_streamed` sorts the
    rays o, d ((x, y, z) tuples of (R,), o nudged): `spatial_sort_key` in
    the LBVH's root box `root` (6,) (min then max), the rays that miss
    that box keyed 2^30 and the switched-off ones (t_init = 0) 2^30 + 1.
    The plain twin of csrc/sort_key.cuh `key`. Returns (R,) int32."""
    lo, hi = root[0:3], root[3:6]
    o3, d3 = torch.stack(o, -1), torch.stack(d, -1)
    key = spatial_sort_key(o3, d3, lo, hi)
    inv = safe_inv_dir(d3)
    ta, tb = (lo - o3) * inv, (hi - o3) * inv
    near = torch.amax(torch.minimum(ta, tb), dim=-1)
    far = torch.amin(torch.maximum(ta, tb), dim=-1)
    key = torch.where((far >= near) & (far > 0.0), key, 2 ** 30)
    return torch.where(t_init > 0.0, key, 2 ** 30 + 1)


def streamed_order(o, d, t_init, scene):
    """The order in which the JAX package's `_ray_scene_streamed` hands
    the rays o, d (o nudged) to its kernel: a stable argsort of
    `streamed_keys` in the LBVH's root box. Returns (R,) int64."""
    return torch.argsort(streamed_keys(o, d, t_init, scene.st_top[0, 0:6]),
                         stable=True)


def sorted_query(query, o, d, t_init, scene, info):
    """`query` (wavefront.trace_streamed or streamed_reference) over the
    rays in `streamed_order` when there are at least SORT_MIN_RAYS of
    them, its outputs scattered back to the rays' own order; otherwise
    over the rays as given. The rays are gathered, and the outputs
    scattered, as one tensor of each type. The plain twin of
    `wavefront.trace_sorted`, which the route takes on the card."""
    if t_init.shape[0] < SORT_MIN_RAYS:
        return query(o, d, t_init, scene, info)
    order = streamed_order(o, d, t_init, scene)
    rays = torch.stack([*o, *d, t_init])[:, order]
    t, u, v, idx, box, rows = query(tuple(rays[0:3]), tuple(rays[3:6]),
                                    rays[6], scene, info)
    floats, ints = torch.stack([t, u, v]), torch.stack([idx, box, rows])
    back_f, back_i = torch.empty_like(floats), torch.empty_like(ints)
    back_f[:, order] = floats
    back_i[:, order] = ints
    return (*back_f, *back_i)


def surface_sample(hit: Hit, o, d, scene, info) -> SurfaceSample:
    """Normal, UV, tangent and material at the final hits
    (frag.glsl:483-519, 596-600, 622-626). `o` must be the nudged origins
    `ray_scene` returned."""
    loc = tuple(o[i] + hit.t * d[i] for i in range(3))
    is_tri = hit.kind == 1
    zero = torch.zeros_like(hit.t)
    norm = (zero, zero, zero)
    tangent = (zero, zero, zero)
    tu = tv = torch.full_like(hit.t, -1.0)
    mat = torch.full_like(hit.tri, -1)
    has_uv = torch.zeros_like(is_tri)
    if info.num_tris:
        tri = torch.clamp(hit.tri, min=0)
        a = scene.attr[tri]
        half = torch.floor(a[:, 9] * 0.5)
        smooth = (a[:, 9] - 2.0 * half) > 0.5
        u, v = hit.u, hit.v
        w = 1.0 - u - v
        ni = tuple(a[:, i] * w + a[:, 3 + i] * u + a[:, 6 + i] * v
                   for i in range(3))
        mag = sqrt(bsdf.dot3(ni, ni))
        norm = tuple(torch.where(is_tri,
                                 torch.where(smooth, ni[i] / mag, a[:, i]),
                                 0.0) for i in range(3))
        mat = torch.where(is_tri, half.to(torch.int64), mat)
        if info.any_uv:
            uv = scene.uvt[tri]
            has_uv = is_tri & (uv[:, 9] > 0.5)
            tur = uv[:, 0] * w + uv[:, 2] * u + uv[:, 4] * v
            tvr = uv[:, 1] * w + uv[:, 3] * u + uv[:, 5] * v
            tu = torch.where(has_uv, tur, -1.0)
            tv = torch.where(has_uv, 1.0 - tvr, -1.0)   # GL flips v
            # raw UV tangent, Gram-Schmidt against the shading normal
            raw = (uv[:, 6], uv[:, 7], uv[:, 8])
            ndt = bsdf.dot3(raw, norm)
            g = tuple(raw[i] - norm[i] * ndt for i in range(3))
            gm = sqrt(bsdf.dot3(g, g))
            tangent = tuple(torch.where(has_uv, g[i] / gm, 0.0)
                            for i in range(3))
    return _assemble_sample(hit, o, d, scene, info, loc, norm, tangent,
                            (tu, tv), mat, has_uv)


def _assemble_sample(hit, o, d, scene, info, loc, norm, tangent, uv, mat,
                     has_uv) -> SurfaceSample:
    """Normals and materials of the analytic primitives over the triangle
    attributes."""
    for k in range(info.num_implicits):
        here = (hit.kind == 2) & (hit.prim == k)
        lo, ld, r = _implicit_frame(scene, info, k, o, d)
        p = tuple(lo[i] + ld[i] * hit.t for i in range(3))
        g = bsdf.unit3(implicits.gradient_soa(info.imp_fn_ids[k], *p))
        if info.imp_rotated[k]:
            g = _mat3_t(r[8:17], g)
        norm = tuple(torch.where(here, g[i], norm[i]) for i in range(3))
        mat = torch.where(here, r[7].to(torch.int64), mat)
    for e in range(info.num_ellipsoids):
        here = (hit.kind == 3) & (hit.prim == e)
        ro, rd, r = _ellipsoid_frame(scene, info, e, o, d)
        n = bsdf.unit3(tuple(ro[i] + hit.t * rd[i] - r[i] for i in range(3)))
        if info.ell_rotated[e]:
            n = _mat3_t(r[8:17], n)
        norm = tuple(torch.where(here, n[i], norm[i]) for i in range(3))
        mat = torch.where(here, r[7].to(torch.int64), mat)
    return SurfaceSample(loc, norm, tangent, uv, mat, has_uv)
