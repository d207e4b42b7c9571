"""Primitive intersection in plain PyTorch (frag.glsl:351-439).

  ray_tri        Möller-Trumbore, (t, u, v) with t = 1e30 on a miss
  tri_candidate  the division-free form the frame path uses: t, u, v kept
                 as ratios over |det| so candidates compare by
                 cross-multiplication and one reciprocal follows the loop
                 (the JAX package's fused kernel and csrc/pathtrace.cuh
                 `closest_hit` do the same arithmetic)
  tri_divide     the form the forest kernels use (csrc/forest_kernel.cu):
                 inv_det = 1/det, then multiply
  ray_box        slab test with a finite reciprocal direction
  ray_ellipsoid  stretched sphere, smallest positive root (PARITY.md #3)
  compute_tangent  UV-space tangent, Gram-Schmidt against the normal
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import sqrt

MISS = 1e30
EPSILON = float(np.float32(1e-10))  # frag.glsl:228


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _soa(v):
    return (v[..., 0], v[..., 1], v[..., 2])


def ray_tri(o, d, v1, v2, v3):
    """Möller-Trumbore on (..., 3) tensors: |det| >= 1e-10, u, v in
    [0, 1], u + v <= 1, t > EPSILON; misses give t = 1e30."""
    e1 = v2 - v1
    e2 = v3 - v1
    p = torch.cross(d, e2, dim=-1)
    det = torch.sum(e1 * p, dim=-1)
    inv_det = 1.0 / det
    s = o - v1
    u = torch.sum(s * p, dim=-1) * inv_det
    q = torch.cross(s, e1, dim=-1)
    v = torch.sum(d * q, dim=-1) * inv_det
    t = torch.sum(e2 * q, dim=-1) * inv_det
    valid = ((torch.abs(det) >= EPSILON) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0) & (t > EPSILON))
    return torch.where(valid, t, torch.full_like(t, MISS)), u, v


def tri_candidate(o, d, v1, e1, e2):
    """Division-free Möller-Trumbore: returns (ok, tc, adet, uc, vc) with
    t = tc/adet, u = uc/adet, v = vc/adet, adet = |det|. `ok` omits the
    closest-so-far test, which the caller does as tc*td < tn*adet."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    s = (o[0] - v1[0], o[1] - v1[1], o[2] - v1[2])
    ur = _dot(s, p)
    q = _cross(s, e1)
    vr = _dot(d, q)
    tr = _dot(e2, q)
    sg = torch.where(det >= 0.0, 1.0, -1.0)
    adet = det * sg
    uc = ur * sg
    vc = vr * sg
    tc = tr * sg
    ok = ((adet >= EPSILON) & (uc >= 0.0) & (vc >= 0.0)
          & (uc + vc <= adet) & (tc > EPSILON * adet))
    return ok, tc, adet, uc, vc


def tri_divide(o, d, v1, e1, e2):
    """Möller-Trumbore as the forest kernels do it, on (x, y, z) tuples:
    returns (ok, t, u, v) with ok = |det| >= 1e-10, u, v in [0, 1],
    u + v <= 1, t > EPSILON. The caller adds the closest-so-far test."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    inv_det = 1.0 / det
    s = (o[0] - v1[0], o[1] - v1[1], o[2] - v1[2])
    u = _dot(s, p) * inv_det
    q = _cross(s, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    ok = ((torch.abs(det) >= EPSILON) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t > EPSILON))
    return ok, t, u, v


def safe_inv_dir(d):
    """Finite reciprocal of a direction component for slab tests: a zero
    component would give 1/d = inf and, with a box plane on the ray,
    0 * inf = NaN. Clamped to +-1e30, every product stays finite."""
    return torch.clamp(1.0 / torch.where(d == 0.0, 1e-30, d), -1e30, 1e30)


def ray_box(o, inv_d, box_min, box_max):
    """Slab test on (x, y, z) tuples, inv_d from `safe_inv_dir`: the entry
    distance (0 from inside the box), 1e30 on a miss (frag.glsl:408-419)."""
    near = far = None
    for i in range(3):
        ta = (box_min[i] - o[i]) * inv_d[i]
        tb = (box_max[i] - o[i]) * inv_d[i]
        lo, hi = torch.minimum(ta, tb), torch.maximum(ta, tb)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    hit = (far >= near) & (far > 0.0)
    return torch.where(hit, torch.clamp(near, min=0.0), MISS)


def ellipsoid_soa(o, d, c, stretch, rad):
    """Stretched-sphere roots: returns (te, disc); a hit needs disc > 0
    and te > 0. te is the smallest positive root."""
    fx, fy, fz = stretch
    oc = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    a = fx * d[0] * d[0] + fy * d[1] * d[1] + fz * d[2] * d[2]
    b = 2.0 * (fx * oc[0] * d[0] + fy * oc[1] * d[1] + fz * oc[2] * d[2])
    cc = (fx * oc[0] * oc[0] + fy * oc[1] * oc[1] + fz * oc[2] * oc[2]
          - rad * rad)
    disc = b * b - 4.0 * a * cc
    sq = sqrt(torch.clamp(disc, min=0.0))
    inv_2a = 1.0 / (2.0 * a)
    t0 = (-b - sq) * inv_2a
    t1 = (-b + sq) * inv_2a
    t_lo = torch.minimum(t0, t1)
    t_hi = torch.maximum(t0, t1)
    return torch.where(t_lo > 0.0, t_lo, t_hi), disc


def ray_ellipsoid(o, d, c, r, stretch):
    """f x^2 + g y^2 + h z^2 = r^2 around c, stretch = (f, g, h); (..., 3)
    tensors. Smallest strictly positive root, 1e30 on a miss."""
    te, disc = ellipsoid_soa(_soa(o), _soa(d), _soa(c), _soa(stretch), r)
    return torch.where((disc > 0.0) & (te > 0.0), te,
                       torch.full_like(te, MISS))


def compute_tangent(p1, p2, p3, uv1, uv2, uv3, normal):
    """UV-space tangent Gram-Schmidt'ed against the normal and normalized
    (frag.glsl:421-439)."""
    edge1 = p2 - p1
    edge2 = p3 - p1
    duv1 = uv2 - uv1
    duv2 = uv3 - uv1
    f = 1.0 / (duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0])
    tangent = f[..., None] * (duv2[..., 1:2] * edge1 - duv1[..., 1:2] * edge2)
    ndt = torch.sum(normal * tangent, dim=-1, keepdim=True)
    tangent = tangent - normal * ndt
    return tangent / sqrt(torch.sum(tangent * tangent, dim=-1,
                                          keepdim=True))
