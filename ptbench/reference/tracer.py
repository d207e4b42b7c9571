"""The plain reference path tracer (frag.glsl:810-933) over a scene of
spheres, rotated ellipsoids, implicit surfaces and flat-shaded triangles,
and the accumulation of frames into the displayed image.

It follows the renderer's semantics draw for draw: each pixel's RNG stream
is seeded pixel index + frame seed and carried across the frame's samples;
a sample is the camera's ray with depth of field (6 draws), then up to
`max_bounces` bounces: the closest hit from the nudged origin, the surface,
the refraction-index stack, chooseRay, the medium, emission, the
throughput cutoff, Beer-Lambert or the lobe's colour; a miss adds the sky
and ends the ray. The arithmetic is a frozen copy of the port's plain
bounce (kernels/bounce.py `bounce_step_plain`, shade/bsdf.py), trimmed to
what these scenes use: no texture maps. The stack is kept top first, one
row per ray.

An ellipsoid and an implicit surface are what the scene description says
(frag.glsl:299-349, 578-631): a ray is taken into the primitive's frame
(an ellipsoid's: the ray turned by the Euler rotation R = Rz Ry Rx; an
implicit's: (o - shift) / scale and d / scale, then turned by R), tested
there (the stretched quadric; the march of reference/implicits.py), and
the normal found there is turned back by R^T. The reference makes its own
rotations and tables from the configuration.

The triangle query is the scene's own (`RefScene.query`): the reference
builds it from the triangles, never from the program's tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import core, implicits
from .core import dot3, sqrt, unit3

MISS = 1e30
HIT_T = 1e25
NUDGE = float(np.float32(1e-4))
EPSILON = float(np.float32(1e-10))
AIR_IOR = float(np.float32(1.0029))
# material record fields the path shade reads
FIELDS = ("Kd", "Ks", "Ke", "Tf", "Tr", "Pm", "Pr", "Pc", "Pcr", "Ni",
          "Density", "illum", "subsurface")
RGB = ("Kd", "Ks", "Ke", "Tf")
# the reference material() defaults (dispatch.java:1514-1550)
DEFAULTS = {"Kd": (0.8, 0.8, 0.8), "Ks": (0.5, 0.5, 0.5), "Ke": (0.0,) * 3,
            "Tf": (0.0,) * 3, "Tr": 0.0, "Pm": 0.0, "Pr": 1.0, "Pc": 0.0,
            "Pcr": 0.0, "Ni": 1.0, "Density": 1.0, "illum": 0,
            "subsurface": 0.0}


@dataclasses.dataclass
class Framed:
    """Primitives that are tested in a frame of their own: ellipsoids
    (rows: centre, stretch, radius, material) or implicit surfaces (rows:
    shift, scale, material; `fn` their function ids)."""

    rows: torch.Tensor          # (N, 8) ellipsoids, (N, 7) implicits
    rot: torch.Tensor           # (N, 9) R = Rz Ry Rx, row-major
    rotated: tuple              # per row: R is not the identity
    fn: tuple = ()

    def __len__(self):
        return len(self.rotated)

    def to(self, dtype):
        return dataclasses.replace(self, rows=self.rows.to(dtype),
                                   rot=self.rot.to(dtype))


def euler_matrix(rot):
    """R = Rz Ry Rx of the Euler angles `rot`, in float32, row-major (9,),
    and whether any angle is not 0. Made on the host with numpy's float32
    sines, as the renderer makes a primitive's rotation when it builds the
    scene (`core.rotation_matrix` is the camera's, made on the device)."""
    rx, ry, rz = (np.float32(v) for v in rot)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    m = np.array([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
                  sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
                  -sy, cy * sx, cy * cx], np.float32)
    return m, bool(rx != 0 or ry != 0 or rz != 0)


def framed_table(rows, rots, width, device, fn=()):
    """A Framed table of `rows` (lists of `width` floats) and their Euler
    angles `rots`."""
    mats = [euler_matrix(r) for r in rots]
    return Framed(
        rows=torch.tensor(np.asarray(rows, np.float32).reshape(-1, width),
                          device=device),
        rot=torch.tensor(np.asarray([m for m, _ in mats],
                                    np.float32).reshape(-1, 9),
                         device=device),
        rotated=tuple(r for _, r in mats), fn=tuple(int(f) for f in fn))


@dataclasses.dataclass
class RefScene:
    """The reference's own tables, made from the configuration's data."""

    mats: dict                  # field -> (M,) or (M, 3) tensor
    sph: torch.Tensor           # (S, 5): centre, radius, material
    tri_n: torch.Tensor         # (T, 3) flat normals
    tri_mat: torch.Tensor       # (T,) int64
    sky: torch.Tensor           # (h, w, 3)
    query: Optional[Callable]   # (on, d, alive) -> (t, u, v, tri)
    ell: Framed                 # ellipsoids, after the spheres
    imp: Framed                 # implicit surfaces

    def to(self, dtype):
        """The same scene with its float tables in `dtype`."""
        return dataclasses.replace(
            self, mats={k: v.to(dtype) for k, v in self.mats.items()},
            sph=self.sph.to(dtype), tri_n=self.tri_n.to(dtype),
            sky=self.sky.to(dtype),
            query=None if self.query is None else self.query.to(dtype),
            ell=self.ell.to(dtype), imp=self.imp.to(dtype))


def material_tables(materials, device):
    """Field tables of a list of {"name", "props"} materials."""
    out = {}
    for f in FIELDS:
        rows = []
        for m in materials:
            v = m["props"].get(f, DEFAULTS[f])
            rows.append(((float(v),) * 3 if np.isscalar(v) else
                         tuple(float(x) for x in v)) if f in RGB
                        else float(v))
        out[f] = torch.tensor(np.asarray(rows, np.float32), device=device)
    return out


def flat_normals(v1, v2, v3):
    """(v3 - v1) x (v2 - v1), normalized in float64, as float32."""
    fn = np.cross(v3 - v1, v2 - v1)
    fn = fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
    return fn.astype(np.float32)


def tri_candidate(o, d, v1, e1, e2):
    """The division-free Moller-Trumbore test: (ok, tc, adet, uc, vc) with
    t = tc / adet; the closest-so-far test is the caller's."""
    p = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
         d[0] * e2[1] - d[1] * e2[0])
    det = dot3(e1, p)
    s = (o[0] - v1[0], o[1] - v1[1], o[2] - v1[2])
    ur = dot3(s, p)
    q = (s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
         s[0] * e1[1] - s[1] * e1[0])
    vr = dot3(d, q)
    tr = dot3(e2, q)
    sg = torch.where(det >= 0.0, 1.0, -1.0).to(det.dtype)
    adet, uc, vc, tc = det * sg, ur * sg, vr * sg, tr * sg
    ok = ((adet >= EPSILON) & (uc >= 0.0) & (vc >= 0.0)
          & (uc + vc <= adet) & (tc > EPSILON * adet))
    return ok, tc, adet, uc, vc


class Closest:
    """The closest triangle so far as numerators over a denominator,
    compared by cross-multiplication, strictly (the first of equal
    distances wins); one reciprocal at the end."""

    def __init__(self, like):
        self.tn = torch.full_like(like, MISS)
        self.td = torch.ones_like(like)
        self.un = torch.zeros_like(like)
        self.vn = torch.zeros_like(like)
        self.tri = torch.full(like.shape, -1, dtype=torch.int64,
                              device=like.device)

    def offer(self, sel, o, d, v1, e1, e2, tri):
        """Test rays `sel` (index tensor, or None for all) against one
        triangle each (rows v1, e1, e2 as (x, y, z) tuples, ids `tri`)."""
        ok, tc, adet, uc, vc = tri_candidate(o, d, v1, e1, e2)
        idx = slice(None) if sel is None else sel
        td, tn = self.td[idx], self.tn[idx]
        ok = ok & (tc * td < tn * adet)
        self.tn[idx] = torch.where(ok, tc, tn)
        self.td[idx] = torch.where(ok, adet, td)
        self.un[idx] = torch.where(ok, uc, self.un[idx])
        self.vn[idx] = torch.where(ok, vc, self.vn[idx])
        self.tri[idx] = torch.where(ok, tri, self.tri[idx])
        return ok

    def current(self, sel):
        return self.tn[sel] / self.td[sel]

    def result(self):
        inv = 1.0 / self.td
        return self.tn * inv, self.un * inv, self.vn * inv, self.tri


class BruteQuery:
    """Every triangle against every ray, in table order."""

    def __init__(self, v1, e1, e2):
        self.rows = (v1, e1, e2)

    def to(self, dtype):
        return BruteQuery(*(r.to(dtype) for r in self.rows))

    def __call__(self, o, d, alive):
        best = Closest(o[0])
        v1, e1, e2 = self.rows
        for k in range(v1.shape[0]):
            best.offer(None, o, d, tuple(v1[k]), tuple(e1[k]), tuple(e2[k]),
                       k)
        return best.result()


def triangle_rows(v1, v2, v3, device):
    """(v1, e1 = v2 - v1, e2 = v3 - v1) in float64, rounded to float32."""
    return tuple(torch.tensor(a.astype(np.float32), device=device)
                 for a in (v1, v2 - v1, v3 - v1))


def _turn(r, v):
    """R v, R the row-major (9,) rotation `r`."""
    return (r[0] * v[0] + r[1] * v[1] + r[2] * v[2],
            r[3] * v[0] + r[4] * v[1] + r[5] * v[2],
            r[6] * v[0] + r[7] * v[1] + r[8] * v[2])


def _turn_back(r, v):
    """R^T v."""
    return (r[0] * v[0] + r[3] * v[1] + r[6] * v[2],
            r[1] * v[0] + r[4] * v[1] + r[7] * v[2],
            r[2] * v[0] + r[5] * v[1] + r[8] * v[2])


def _framed(table):
    """(row, rotation, rotated, fn) of each primitive of a Framed table,
    rows and rotations as lists of scalars."""
    return [([table.rows[k, i] for i in range(table.rows.shape[1])],
             [table.rot[k, i] for i in range(9)], table.rotated[k],
             table.fn[k] if table.fn else None)
            for k in range(len(table))]


def _implicit_frame(row, r, rotated, on, d):
    """A ray in an implicit surface's frame: (o - shift) / scale and
    d / scale, turned by R."""
    lo = tuple((on[i] - row[i]) / row[3 + i] for i in range(3))
    ld = tuple(d[i] / row[3 + i] for i in range(3))
    if rotated:
        return _turn(r, lo), _turn(r, ld)
    return lo, ld


def _ellipsoid_frame(r, rotated, on, d):
    """A ray in an ellipsoid's frame: turned by R."""
    if rotated:
        return _turn(r, on), _turn(r, d)
    return on, d


def closest_hit(scene: RefScene, on, d, alive):
    """(t, kind, prim, u, v) of rays from the nudged origins: the
    triangles first, then each implicit surface, each sphere and each
    ellipsoid, in table order, each with a strict t < closest. kind 0
    none, 1 triangle, 2 implicit, 3 sphere, 4 ellipsoid; prim the
    triangle, implicit, sphere or ellipsoid."""
    like = on[0]
    if scene.query is not None:
        t, u, v, tri = scene.query(on, d, alive)
    else:
        t = torch.full_like(like, MISS)
        u = v = torch.zeros_like(like)
        tri = torch.full(like.shape, -1, dtype=torch.int64,
                         device=like.device)
    kind = torch.where(tri >= 0, 1, 0)
    prim = tri.clone()
    for k, (row, r, rotated, fn) in enumerate(_framed(scene.imp)):
        lo, ld = _implicit_frame(row, r, rotated, on, d)
        tk, found = implicits.march(fn, lo, ld)
        ok = found & (tk < t)
        t = torch.where(ok, tk, t)
        kind = torch.where(ok, 2, kind)
        prim = torch.where(ok, k, prim)
    for e in range(scene.sph.shape[0]):
        c, rad = scene.sph[e, 0:3], scene.sph[e, 3]
        oc = (on[0] - c[0], on[1] - c[1], on[2] - c[2])
        a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        b = 2.0 * (oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2])
        cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rad * rad
        disc = b * b - 4.0 * a * cc
        sq = sqrt(torch.clamp(disc, min=0.0))
        inv_2a = 1.0 / (2.0 * a)
        t0, t1 = (-b - sq) * inv_2a, (-b + sq) * inv_2a
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        te = torch.where(lo > 0.0, lo, hi)
        ok = (disc > 0.0) & (te > 0.0) & (te < t)
        t = torch.where(ok, te, t)
        kind = torch.where(ok, 3, kind)
        prim = torch.where(ok, e, prim)
    for e, (row, r, rotated, _) in enumerate(_framed(scene.ell)):
        ro, rd = _ellipsoid_frame(r, rotated, on, d)
        f, rad = row[3:6], row[6]
        oc = (ro[0] - row[0], ro[1] - row[1], ro[2] - row[2])
        a = f[0] * rd[0] * rd[0] + f[1] * rd[1] * rd[1] + f[2] * rd[2] * rd[2]
        b = 2.0 * (f[0] * oc[0] * rd[0] + f[1] * oc[1] * rd[1]
                   + f[2] * oc[2] * rd[2])
        cc = (f[0] * oc[0] * oc[0] + f[1] * oc[1] * oc[1]
              + f[2] * oc[2] * oc[2] - rad * rad)
        disc = b * b - 4.0 * a * cc
        sq = sqrt(torch.clamp(disc, min=0.0))
        inv_2a = 1.0 / (2.0 * a)
        t0, t1 = (-b - sq) * inv_2a, (-b + sq) * inv_2a
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        te = torch.where(lo > 0.0, lo, hi)
        ok = (disc > 0.0) & (te > 0.0) & (te < t)
        t = torch.where(ok, te, t)
        kind = torch.where(ok, 4, kind)
        prim = torch.where(ok, e, prim)
    return t, kind, prim, u, v


def choose_ray(m, n1, n2, nrm, d, state):
    """chooseRay (frag.glsl:744-809), branchless: (direction, lobe id,
    state). Lobes: 0 diffuse, 1 reflect, 2 clearcoat, 3 transmission,
    4 subsurface."""
    dt = n1.dtype
    Pr, Pm, Pc, Pcr, Tr, Tf = (m["Pr"], m["Pm"], m["Pc"], m["Pcr"], m["Tr"],
                               m["Tf"])
    zero = torch.zeros_like(Pr)
    reflection_w = 1.0 - Pr
    tf_mean = (Tf[0] + Tf[1] + Tf[2]) / 3.0
    transmission_w = torch.where(Tr > 0.0, Tr,
                                 torch.where(Tf[0] > 0.0, tf_mean, zero))
    eta = n1 / n2
    illum = m["illum"]
    do_fresnel = (illum == 5.0) | (illum == 7.0) | (transmission_w > 0.0)
    # Schlick with total internal reflection (frag.glsl:726-743)
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(nrm, d)
    rn = n1 / n2
    sin_t2 = rn * rn * (1.0 - cos_x * cos_x)
    tir_f = (n1 > n2) & (sin_t2 > 1.0)
    cos_x = torch.where(n1 > n2, sqrt(torch.clamp(1.0 - sin_t2, min=0.0)),
                        cos_x)
    x = 1.0 - cos_x
    fr = r0 + (1.0 - r0) * x * x * x * x * x
    fr = torch.where(tir_f, torch.ones_like(fr), fr)
    fresnel = torch.where(do_fresnel, fr, zero)
    reflection_w = reflection_w + fresnel * Pr
    transmission_w = transmission_w * (1.0 - fresnel)
    diffuse_w = (1.0 - Pm) * (1.0 - transmission_w) * (1.0 - fresnel)
    total = diffuse_w + reflection_w + Pc + transmission_w
    rw, cw, tw = reflection_w / total, Pc / total, transmission_w / total

    p = [core.peek_uniform(state, off, dt) for off in range(1, 9)]
    roll, sub_roll = p[0], p[1]
    lp = (core.normal_from(p[1], p[2]), core.normal_from(p[3], p[4]),
          core.normal_from(p[5], p[6]))
    ls = (core.normal_from(p[2], p[3]), core.normal_from(p[4], p[5]),
          core.normal_from(p[6], p[7]))
    dn = dot3(nrm, d)
    refl = tuple(d[i] - 2.0 * dn * nrm[i] for i in range(3))
    cos_plain = unit3(tuple(lp[i] + nrm[i] for i in range(3)))
    cos_sub = unit3(tuple(ls[i] + nrm[i] for i in range(3)))
    coat = tuple(refl[i] * (1.0 - Pcr) + cos_plain[i] * Pcr
                 for i in range(3))
    kk = 1.0 - eta * eta * (1.0 - dn * dn)
    tir = kk < 0.0
    ksq = sqrt(torch.clamp(kk, min=0.0))
    refr = tuple(torch.where(tir, zero, eta * d[i] - (eta * dn + ksq)
                             * nrm[i]) for i in range(3))
    t1 = rw
    t2 = t1 + cw
    t3 = t2 + tw
    is_reflect = roll < t1
    is_coat = (~is_reflect) & (roll < t2)
    is_trans = (~is_reflect) & (~is_coat) & (roll < t3)
    is_else = ~(is_reflect | is_coat | is_trans)
    has_ss = m["subsurface"] > 0.0
    is_sub = is_else & has_ss & (sub_roll < m["subsurface"])
    win = torch.where(is_reflect, 1, torch.where(
        is_coat, 2, torch.where(is_trans, 3, torch.where(is_sub, 4, 0))))
    direction = tuple(
        torch.where(is_reflect, refl[i], torch.where(
            is_coat, coat[i], torch.where(
                is_trans, refr[i],
                torch.where(has_ss, cos_sub[i], cos_plain[i]))))
        for i in range(3))
    new_state = torch.where(is_trans, core.advance(state, 1), torch.where(
        is_else & has_ss, core.advance(state, 8), core.advance(state, 7)))
    return direction, win, new_state


@dataclasses.dataclass
class Paths:
    """R rays between bounces; vectors as (x, y, z) tuples of (R,)."""

    o: tuple
    d: tuple
    alive: torch.Tensor
    col: tuple
    inc: tuple
    skyc: tuple
    enter: tuple
    stack: torch.Tensor     # (R, S), top first, 0 at and past ssize
    ssize: torch.Tensor
    inobj: torch.Tensor
    state: torch.Tensor
    queries: torch.Tensor


def begin(o, d, state, stack_size: int):
    zero = torch.zeros_like(o[0])
    stack = torch.zeros((o[0].shape[0], stack_size), dtype=o[0].dtype,
                        device=o[0].device)
    stack[:, 0] = AIR_IOR
    alive = torch.ones(zero.shape, dtype=torch.bool, device=zero.device)
    return Paths(o=o, d=d, alive=alive, col=(zero + 1.0,) * 3,
                 inc=(zero,) * 3, skyc=(zero,) * 3, enter=(zero,) * 3,
                 stack=stack,
                 ssize=torch.ones(zero.shape, dtype=torch.int32,
                                  device=zero.device),
                 inobj=torch.zeros_like(alive), state=state,
                 queries=torch.zeros(zero.shape, dtype=torch.int64,
                                     device=zero.device))


def bounce(scene: RefScene, p: Paths) -> Paths:
    """One bounce of every ray (frag.glsl:810-882)."""
    o, d, alive = p.o, p.d, p.alive
    on = tuple(o[i] + NUDGE * d[i] for i in range(3))
    t, kind, prim, u, v = closest_hit(scene, on, d, alive)
    hit = alive & (t < HIT_T)
    is_miss = alive & ~(t < HIT_T)
    hx = tuple(on[i] + t * d[i] for i in range(3))
    # surface: the hit primitive's normal and material
    zero = torch.zeros_like(t)
    norm, mat = (zero, zero, zero), torch.zeros_like(prim)
    if scene.tri_n.shape[0]:
        is_tri = kind == 1
        tri = torch.clamp(prim, min=0)
        tn = scene.tri_n[torch.where(is_tri, tri, 0)]
        norm = tuple(torch.where(is_tri, tn[:, i], 0.0) for i in range(3))
        mat = torch.where(is_tri, scene.tri_mat[torch.where(is_tri, tri, 0)],
                          mat)
    for e in range(scene.sph.shape[0]):
        here = (kind == 3) & (prim == e)
        c = scene.sph[e]
        n = unit3(tuple(on[i] + t * d[i] - c[i] for i in range(3)))
        norm = tuple(torch.where(here, n[i], norm[i]) for i in range(3))
        mat = torch.where(here, c[4].to(torch.int64), mat)
    for k, (row, r, rotated, fn) in enumerate(_framed(scene.imp)):
        here = (kind == 2) & (prim == k)
        lo, ld = _implicit_frame(row, r, rotated, on, d)
        g = unit3(implicits.gradient(fn, tuple(lo[i] + ld[i] * t
                                               for i in range(3))))
        if rotated:
            g = _turn_back(r, g)
        norm = tuple(torch.where(here, g[i], norm[i]) for i in range(3))
        mat = torch.where(here, row[6].to(torch.int64), mat)
    for e, (row, r, rotated, _) in enumerate(_framed(scene.ell)):
        here = (kind == 4) & (prim == e)
        ro, rd = _ellipsoid_frame(r, rotated, on, d)
        n = unit3(tuple(ro[i] + t * rd[i] - row[i] for i in range(3)))
        if rotated:
            n = _turn_back(r, n)
        norm = tuple(torch.where(here, n[i], norm[i]) for i in range(3))
        mat = torch.where(here, row[7].to(torch.int64), mat)
    m = {k: (tuple(tab[mat, i] for i in range(3)) if k in RGB else tab[mat])
         for k, tab in scene.mats.items()}

    S = p.stack.shape[1]
    stack, ssize = p.stack, p.ssize
    second = min(1, S - 1)
    queries = p.queries + alive.to(torch.int64)
    nd = dot3(norm, d)
    flip = torch.where(nd > 0.0, -1.0, 1.0).to(nd.dtype)
    n = (norm[0] * flip, norm[1] * flip, norm[2] * flip)
    entering = nd < 0.0
    do_push = entering & (ssize < S)
    pushed = torch.where(do_push[:, None],
                         torch.cat([m["Ni"][:, None], stack[:, :-1]], 1),
                         stack)
    size_push = torch.where(do_push, ssize + 1, ssize)
    n1 = torch.where(entering, pushed[:, second], stack[:, 0])
    n2 = torch.where(entering, pushed[:, 0], stack[:, second])
    do_pop = (~entering) & (ssize > 0)
    popped = torch.where(do_pop[:, None],
                         torch.cat([pushed[:, 1:], zero[:, None]], 1), pushed)
    new_size = torch.where(do_pop, ssize - 1, size_push)

    direction, win, lobe_state = choose_ray(m, n1, n2, n, d, p.state)
    transmitted = win == 3
    dd = tuple(p.enter[i] - hx[i] for i in range(3))
    dist = sqrt(dot3(dd, dd))
    absorb = transmitted & ((~entering) | p.inobj)
    new_inobj = torch.where(transmitted, entering, p.inobj)
    enter_now = transmitted & entering
    col = p.col
    inc = tuple(p.inc[i] + torch.where(hit, m["Ke"][i] * col[i], 0.0)
                for i in range(3))
    cutoff = sqrt(dot3(col, col)) < 0.1
    spec, passthrough = win == 2, win == 4
    new_col = []
    for i in range(3):
        c = col[i] * torch.where(spec, m["Ks"][i], m["Kd"][i])
        c = torch.where(passthrough, col[i], c)
        absorbed = col[i] * torch.exp(-m["Tf"][i] * dist * m["Density"])
        new_col.append(torch.where(absorb, absorbed, c))
    sr = core.sky(scene.sky, d)
    skyc = tuple(p.skyc[i] + torch.where(is_miss & (col[i] > 0.0),
                                         sr[i] * col[i], 0.0)
                 for i in range(3))

    def upd(new, old):
        return torch.where(hit, new, old)

    return Paths(
        o=tuple(upd(hx[i], o[i]) for i in range(3)),
        d=tuple(upd(direction[i], d[i]) for i in range(3)),
        alive=hit & ~cutoff,
        col=tuple(upd(new_col[i], col[i]) for i in range(3)),
        inc=inc, skyc=skyc,
        enter=tuple(torch.where(hit & enter_now, hx[i], p.enter[i])
                    for i in range(3)),
        stack=torch.where(hit[:, None], popped, stack),
        ssize=torch.where(hit, new_size, ssize),
        inobj=torch.where(hit, new_inobj, p.inobj),
        state=torch.where(hit, lobe_state, p.state),
        queries=queries)


def _compact(p: Paths, keep):
    """The rays of `keep` (index tensor) alone."""
    return Paths(**{f.name: (tuple(c[keep] for c in getattr(p, f.name))
                             if isinstance(getattr(p, f.name), tuple)
                             else getattr(p, f.name)[keep])
                    for f in dataclasses.fields(p)})


def trace(scene: RefScene, o, d, state, *, max_bounces: int,
          stack_size: int):
    """One sample of R rays: (radiance without sky (R, 3), sky radiance
    (R, 3), state after, queries (R,)). Rays that end leave the batch, so
    later bounces cost what their live rays do."""
    p = begin(o, d, state, stack_size)
    n = o[0].shape[0]
    rows = torch.arange(n, device=o[0].device)
    inc = torch.zeros((n, 3), dtype=o[0].dtype, device=o[0].device)
    skyc = torch.zeros_like(inc)
    out_state = state.clone()
    queries = torch.zeros(n, dtype=torch.int64, device=o[0].device)

    def retire(p, rows, done):
        inc[rows[done]] = torch.stack(p.inc, -1)[done]
        skyc[rows[done]] = torch.stack(p.skyc, -1)[done]
        out_state[rows[done]] = p.state[done]
        queries[rows[done]] = p.queries[done]

    for _ in range(max_bounces):
        if rows.numel() == 0:
            break
        p = bounce(scene, p)
        done = ~p.alive
        retire(p, rows, done)
        keep = p.alive.nonzero()[:, 0]
        p, rows = _compact(p, keep), rows[keep]
    if rows.numel():
        retire(p, rows, torch.ones_like(rows, dtype=torch.bool))
    return inc, skyc, out_state, queries


def frame_rays(cam_pos, rotmat, ifd, index, state, render):
    """The camera rays of pixels `index` (P,), or (F, P) each frame its
    own, in F frames: cam_pos (F, 3), rotmat (F, 3, 3), state (F, P).
    Returns (o, d) as (x, y, z) tuples of (F*P,) and the state after."""
    uv = core.pixel_uv(index, render["width"], render["height"])
    uv = uv if index.dim() == 2 else uv[None]
    pd = core.primary_directions(uv, rotmat[:, None], render["cam_size"],
                                 render["focal_length"],
                                 render["height"] / float(render["width"]))
    o, d, st = core.dof_ray(cam_pos[:, None], pd.to(rotmat.dtype),
                            rotmat[:, None], render["blur"], ifd, state)
    o = o.expand(d.shape)
    return (tuple(c.reshape(-1) for c in o.unbind(-1)),
            tuple(c.reshape(-1) for c in d.unbind(-1)), st.reshape(-1))


def render_frames(scene: RefScene, render: dict, cam_pos, cam_rot, index,
                  frame_seeds, *, dtype=torch.float32, sum_order="frame",
                  block_rays=1 << 20):
    """The frames of `frame_seeds` (F,) at pixels `index` ((P,) for all
    frames, or (F, P) each frame its own), each from its pose (cam_pos,
    cam_rot: (3,) for all frames or (F, 3)): returns
    ((F, P, 3) each frame's mean over its samples, queries). Frames go
    through in blocks of at most `block_rays` rays. `sum_order` is the
    route's order of the samples' sum: "frame" adds up the radiance and
    the sky radiance apart and then the two (the frame path), "bounce"
    the samples' radiance with sky one after the other (the per-bounce
    route)."""
    dev = index.device
    n = len(frame_seeds)
    pos = np.broadcast_to(np.asarray(cam_pos, np.float32), (n, 3))
    rot = np.broadcast_to(np.asarray(cam_rot, np.float32), (n, 3))
    pos = torch.as_tensor(np.array(pos), device=dev)
    rotmat = core.rotation_matrix(torch.as_tensor(np.array(rot),
                                                  device=dev)).to(dtype)
    ifd = torch.tensor(np.float32(render["focal_distance"]),
                       device=dev).to(dtype)
    spp = render["samples_per_frame"]
    seeds = torch.as_tensor(np.asarray(frame_seeds, np.int64), device=dev)
    index = index.expand(n, -1) if index.dim() == 1 else index
    p = index.shape[1]
    per_block = max(1, block_rays // p)
    out, queries = [], 0
    for s0 in range(0, n, per_block):
        blk = slice(s0, s0 + per_block)
        st = core.seed_many(index[blk], seeds[blk])
        f = st.shape[0]
        inc = torch.zeros((f * p, 3), dtype=dtype, device=dev)
        skyc = torch.zeros_like(inc)
        for _ in range(spp):
            o, d, st = frame_rays(pos[blk].to(dtype), rotmat[blk], ifd,
                                  index[blk], st.reshape(f, p), render)
            i, s, st, q = trace(scene, o, d, st,
                                max_bounces=render["max_bounces"],
                                stack_size=render["refraction_stack_depth"])
            if sum_order == "frame":
                inc, skyc = inc + i, skyc + s
            else:
                inc = inc + (i + s)
            queries += int(q.sum())
        out.append(((inc + skyc) / float(spp)).reshape(f, p, 3))
    return torch.cat(out), queries


def display(frames):
    """The displayed image of frames (F, P, 3) accumulated in order: the
    running sum over the count (frag.glsl:924-933)."""
    total = torch.zeros_like(frames[0])
    for k in range(frames.shape[0]):
        total = total + frames[k]
    return total / float(max(frames.shape[0], 1))
