"""The 10 implicit surfaces (frag.glsl:299-349), their gradient and the
bracketed ray marcher.

NaN regions mean "no surface here" (the reference takes sqrt(-1)); a NaN
never brackets a sign change. The marcher samples t = k * dt for
k = 0..steps (dt = t_max / steps, exact in float32 for the defaults),
takes the first sign change and refines it by bisection. The CUDA kernel
(csrc/pathtrace.cuh `implicit_f`, `march_implicit`) evaluates the same
lattice, skipping only samples outside the surface's bounding sphere,
where no root can lie.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import sqrt

_GR = 0.5 + 5.0 ** 0.5 / 2.0   # golden ratio (frag.glsl:229)
_GR2 = _GR * _GR
NAN = float("nan")

# The marcher's lattice and refinement (dt = MARCH_TMAX / MARCH_STEPS is
# exact in float32).
MARCH_STEPS = 256
BISECT_ITERS = 24
MARCH_TMAX = 100.0

# Local-frame bounding radii of the bounded surfaces (fn id -> radius):
# no root lies outside, so the kernel's march skips samples there
# (csrc/pathtrace.cuh `bound_radius` holds the same table). 2 (waves),
# 4 (tractor beam) and 5 (golden-ratio surface) are unbounded.
BOUND_RADIUS = {1: 4.0, 3: 2.0, 6: 18.0, 7: 2.6, 8: 8.0, 9: 8.5, 10: 9.5}


def _fx1(x2, y2, z2, x, y, z):
    return x2 + y2 + z2 - 15.0


def _fx2(x2, y2, z2, x, y, z):
    return torch.sin(x / 2.0) + torch.sin(z / 2.0) + y / 2.0 + 10.0


def _fx3(x2, y2, z2, x, y, z):
    return 2.0 * x2 + y2 + 2.0 * z2 - 3.0


def _fx4(x2, y2, z2, x, y, z):
    fx = torch.where(y < -0.63, 0.2 * (y - 5.0), torch.full_like(y, NAN))
    return x2 + z2 - fx * fx


def _fx5(x2, y2, z2, x, y, z):
    w = 1.0
    return 4.0 * (_GR2 * x2 - y2) * (_GR2 * y2 - z2) * (_GR2 * z2 - x2) - (
        1.0 + 2.0 * _GR) * (x2 + y2 + z2 - w) ** 2 * w


def _fx6(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        y > -0.7417,
        torch.where(y > 0.0,
                    torch.where(y < 1.3, y ** 3 - 3.0, nan),
                    torch.where(y > -2.0, 10.0 * torch.sin(y + 4.7) + 7.0,
                                nan)),
        nan)
    return x2 + z2 - fx * fx


def _fx7(x2, y2, z2, x, y, z):
    fx = -1.047 * sqrt(-(y - 1.25) * (y - 1.25) + 1.0)
    return x2 + z2 - fx * fx


def _fx8(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        (y > 7.6) | (y < 0.0), nan,
        torch.where(y < 0.196, 0.5625 * torch.cos(17.0 * y) + 0.6875,
                    0.125 + torch.sin(0.9 * torch.abs(y / 2.5) ** 0.6) ** 10))
    return x2 + z2 - fx * fx


def _fx9(x2, y2, z2, x, y, z):
    yy = -y
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        (yy < 2.0) | (yy > 8.0), nan,
        torch.where(yy > 7.0, -torch.abs(yy - 7.0) ** 10 + 1.0,
        torch.where(yy > 5.0, torch.ones_like(yy),
        torch.where(yy > 4.1, torch.sin(yy - 0.27),
        torch.where(yy > 2.5, (yy + 0.9826) / 8.0,
        torch.where(yy > 2.0, torch.sin(40.0 * yy) / 40.0 + 0.45,
                    torch.zeros_like(yy)))))))
    return x2 + z2 - fx * fx


def _fx10(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        y > 0.0,
        torch.where(y < 5.488, -(10.0 ** (-5.0 * y)) + 1.04,
        torch.where(y < 6.74, 0.34 * torch.sin(2.5 * y + 6.7) + 0.7,
        torch.where(y < 8.43, torch.full_like(y, 0.36),
        torch.where(y < 8.76, -50.0 * (y - 8.6) ** 4 + 0.4,
        torch.where(y < 9.0, torch.full_like(y, 0.36), nan))))),
        nan)
    return x2 + z2 - fx * fx


BUILDERS = [_fx1, _fx2, _fx3, _fx4, _fx5, _fx6, _fx7, _fx8, _fx9, _fx10]


def feval(fn_id: int, x, y, z):
    """Surface `fn_id` (1..10) at the local point (x, y, z)."""
    return BUILDERS[fn_id - 1](x * x, y * y, z * z, x, y, z)


def funcs(p, fn: int):
    """Surface `fn` at points p (..., 3)."""
    return feval(fn, p[..., 0], p[..., 1], p[..., 2])


GRAD_H = float(np.float32(1e-4))


def gradient_soa(fn_id: int, x, y, z):
    """Forward-difference RAW partials (the reference negates twice,
    frag.glsl:440-445 and 597-599, so +normalize(grad) is the normal)."""
    fc = feval(fn_id, x, y, z)
    return ((feval(fn_id, x + GRAD_H, y, z) - fc) / GRAD_H,
            (feval(fn_id, x, y + GRAD_H, z) - fc) / GRAD_H,
            (feval(fn_id, x, y, z + GRAD_H) - fc) / GRAD_H)


def gradient(p, fn: int):
    gx, gy, gz = gradient_soa(fn, p[..., 0], p[..., 1], p[..., 2])
    return torch.stack([gx, gy, gz], dim=-1)


def march(fn_id: int, ox, oy, oz, dx, dy, dz, *, steps: int = MARCH_STEPS,
          bisect_iters: int = BISECT_ITERS, t_max: float = MARCH_TMAX):
    """First root of surface `fn_id` along o + t d in local coordinates.
    Returns (t, found): t = k*dt lattice bracket refined by bisection."""
    dt = float(np.float32(t_max / steps))

    def f_at(t):
        return feval(fn_id, ox + dx * t, oy + dy * t, oz + dz * t)

    f_prev = f_at(torch.zeros_like(ox))
    t_lo = torch.zeros_like(ox)
    t_hi = torch.full_like(ox, float(np.float32(t_max)))
    found = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    for k in range(1, steps + 1):
        tc = dt * float(k)
        f = f_at(tc)
        sc = (~found) & (f_prev * f < 0.0)
        t_lo = torch.where(sc, tc - dt, t_lo)
        t_hi = torch.where(sc, tc, t_hi)
        found = found | sc
        f_prev = f
    f_lo = f_at(t_lo)
    for _ in range(bisect_iters):
        t_mid = 0.5 * (t_lo + t_hi)
        f_mid = f_at(t_mid)
        go_left = f_lo * f_mid < 0.0
        t_hi = torch.where(go_left, t_mid, t_hi)
        t_lo = torch.where(go_left, t_lo, t_mid)
        f_lo = torch.where(go_left, f_lo, f_mid)
    return 0.5 * (t_lo + t_hi), found


def ray_implicit(o, d, fn: int, t_max: float = MARCH_TMAX,
                 coarse_steps: int = MARCH_STEPS,
                 bisect_iters: int = BISECT_ITERS):
    """t of the first root along o + t d (o, d (..., 3)), 1e30 if none."""
    t, found = march(fn, o[..., 0], o[..., 1], o[..., 2], d[..., 0],
                     d[..., 1], d[..., 2], steps=coarse_steps,
                     bisect_iters=bisect_iters, t_max=t_max)
    return torch.where(found, t, torch.full_like(t, 1e30))
