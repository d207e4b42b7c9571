"""The reference's implicit surfaces (frag.glsl:299-349): the 10 functions,
the march along a ray and the surface normal.

A surface is the zero set of f(x, y, z) in its local frame; where f is NaN
(the renderer takes sqrt(-1) there) there is no surface, and a NaN never
brackets a sign change. The march samples the whole lattice t = k * DT,
k = 0..LATTICE_STEPS, takes the first strict sign change between two
neighbouring samples and halves that bracket BISECTIONS times. It skips no
sample: the renderer's kernel may skip samples outside a surface's
bounding sphere, and this march is what that optimisation is held to. The
normal is the forward difference of f at NORMAL_H, normalized.

Every float function takes the tensors' own dtype, so the same code runs
in float32 (the reference) or bfloat16 (the control).
"""
from __future__ import annotations

import numpy as np
import torch

from .core import sqrt

# the march: lattice steps over [0, T_MAX], bisections of the bracket; the
# lattice step T_MAX / LATTICE_STEPS is exact in float32
LATTICE_STEPS = 256
BISECTIONS = 24
T_MAX = 100.0
# the forward difference of the normal
NORMAL_H = float(np.float32(1e-4))
# lattice samples a ray evaluated at once (a bound on the march's memory)
CHUNK = 64

_GR = 0.5 + 5.0 ** 0.5 / 2.0   # the golden ratio (frag.glsl:229)
_GR2 = _GR * _GR
NAN = float("nan")


def _profile(x2, z2, fx):
    """A surface of revolution about y: x^2 + z^2 = fx(y)^2."""
    return x2 + z2 - fx * fx


def _f1(x2, y2, z2, x, y, z):
    return x2 + y2 + z2 - 15.0


def _f2(x2, y2, z2, x, y, z):
    return torch.sin(x / 2.0) + torch.sin(z / 2.0) + y / 2.0 + 10.0


def _f3(x2, y2, z2, x, y, z):
    return 2.0 * x2 + y2 + 2.0 * z2 - 3.0


def _f4(x2, y2, z2, x, y, z):
    fx = torch.where(y < -0.63, 0.2 * (y - 5.0), torch.full_like(y, NAN))
    return _profile(x2, z2, fx)


def _f5(x2, y2, z2, x, y, z):
    w = 1.0
    return 4.0 * (_GR2 * x2 - y2) * (_GR2 * y2 - z2) * (_GR2 * z2 - x2) - (
        1.0 + 2.0 * _GR) * (x2 + y2 + z2 - w) ** 2 * w


def _f6(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        y > -0.7417,
        torch.where(y > 0.0,
                    torch.where(y < 1.3, y ** 3 - 3.0, nan),
                    torch.where(y > -2.0, 10.0 * torch.sin(y + 4.7) + 7.0,
                                nan)),
        nan)
    return _profile(x2, z2, fx)


def _f7(x2, y2, z2, x, y, z):
    fx = -1.047 * sqrt(-(y - 1.25) * (y - 1.25) + 1.0)
    return _profile(x2, z2, fx)


def _f8(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        (y > 7.6) | (y < 0.0), nan,
        torch.where(y < 0.196, 0.5625 * torch.cos(17.0 * y) + 0.6875,
                    0.125 + torch.sin(0.9 * torch.abs(y / 2.5) ** 0.6) ** 10))
    return _profile(x2, z2, fx)


def _f9(x2, y2, z2, x, y, z):
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
    return _profile(x2, z2, fx)


def _f10(x2, y2, z2, x, y, z):
    nan = torch.full_like(y, NAN)
    fx = torch.where(
        y > 0.0,
        torch.where(y < 5.488, -(10.0 ** (-5.0 * y)) + 1.04,
        torch.where(y < 6.74, 0.34 * torch.sin(2.5 * y + 6.7) + 0.7,
        torch.where(y < 8.43, torch.full_like(y, 0.36),
        torch.where(y < 8.76, -50.0 * (y - 8.6) ** 4 + 0.4,
        torch.where(y < 9.0, torch.full_like(y, 0.36), nan))))),
        nan)
    return _profile(x2, z2, fx)


FUNCTIONS = (_f1, _f2, _f3, _f4, _f5, _f6, _f7, _f8, _f9, _f10)


def surface(fn: int, x, y, z):
    """f of surface `fn` (1..10) at local points (x, y, z)."""
    return FUNCTIONS[fn - 1](x * x, y * y, z * z, x, y, z)


def march(fn: int, o, d):
    """(t, found) of the first root of surface `fn` along o + t d, o and d
    local (x, y, z) tuples of (R,): the whole lattice, CHUNK samples a
    ray at once, then the bisections."""
    dt = float(np.float32(T_MAX / LATTICE_STEPS))
    like = o[0]

    def f_at(t):
        return surface(fn, o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)

    f_prev = f_at(torch.zeros_like(like))
    found = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    k_hi = torch.zeros(like.shape, dtype=torch.int64, device=like.device)
    col = tuple(c[:, None] for c in (*o, *d))
    for k0 in range(1, LATTICE_STEPS + 1, CHUNK):
        ks = torch.arange(k0, min(k0 + CHUNK, LATTICE_STEPS + 1),
                          device=like.device)
        t = ks.to(like.dtype)[None, :] * dt
        f = surface(fn, col[0] + col[3] * t, col[1] + col[4] * t,
                    col[2] + col[5] * t)
        # a sign change between each sample and the one before it
        change = torch.cat([f_prev[:, None], f[:, :-1]], 1) * f < 0.0
        first = change.any(1) & ~found
        k_hi = torch.where(first, ks[change.to(torch.int32).argmax(1)], k_hi)
        found = found | first
        f_prev = f[:, -1]
    t_lo = torch.where(found, (k_hi - 1).to(like.dtype) * dt, 0.0)
    t_hi = torch.where(found, k_hi.to(like.dtype) * dt,
                       float(np.float32(T_MAX)))
    f_lo = f_at(t_lo)
    for _ in range(BISECTIONS):
        t_mid = 0.5 * (t_lo + t_hi)
        f_mid = f_at(t_mid)
        left = f_lo * f_mid < 0.0
        t_hi = torch.where(left, t_mid, t_hi)
        t_lo = torch.where(left, t_lo, t_mid)
        f_lo = torch.where(left, f_lo, f_mid)
    return 0.5 * (t_lo + t_hi), found


def gradient(fn: int, p):
    """The forward difference of f at local point p, (x, y, z)."""
    fc = surface(fn, *p)
    return ((surface(fn, p[0] + NORMAL_H, p[1], p[2]) - fc) / NORMAL_H,
            (surface(fn, p[0], p[1] + NORMAL_H, p[2]) - fc) / NORMAL_H,
            (surface(fn, p[0], p[1], p[2] + NORMAL_H) - fc) / NORMAL_H)
