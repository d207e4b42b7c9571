"""The plain reference's arithmetic: the frame RNG, the camera and the
equirect sky, as the renderer draws and computes them (frag.glsl:235-242,
683-723, 884-908).

A frozen copy of the port's plain versions (core/rng.py, core/camera.py,
core/math.py, scene/texture.py), kept here so that the reference imports
nothing of the program. Every float function takes the tensors' own dtype,
so the same code computes in float32 (the reference) or in bfloat16 (the
lower-precision control). On the CPU, float32 square roots and sky angles
are taken in float64 and rounded once, as the card computes them.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
MUL = 747796405
INC = 2891336453
MIX = 277803737
INV32 = float(np.float32(1.0) / np.float32(4294967295.0))
TWO_PI = float(np.float32(2.0 * 3.1415926))
SKY_U_DIV = float(np.float32(2.0 * 3.14159))
SKY_V_DIV = float(np.float32(3.14159))


def sqrt(x):
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def unit3(a):
    m = sqrt(dot3(a, a))
    return (a[0] / m, a[1] / m, a[2] / m)


# ---- the counted RNG (state int64 holding a uint32) -----------------------

def _affine(n: int):
    a, c, mul, inc = 1, 0, MUL, INC
    while n:
        if n & 1:
            a, c = (a * mul) & MASK, (c * mul + inc) & MASK
        inc = ((mul + 1) * inc) & MASK
        mul = (mul * mul) & MASK
        n >>= 1
    return a, c


def _mulmod(s, a: int):
    return ((s & 0xFFFF) * a + ((((s >> 16) * a) & 0xFFFF) << 16)) & MASK


def seed(pixel_index, frame_seed: int):
    return (pixel_index.to(torch.int64) + (int(frame_seed) & MASK)) & MASK


def seed_many(pixel_index, frame_seeds):
    """(F, P) states of pixels `pixel_index` ((P,) for every frame, or
    (F, P)) under F frame seeds ((F,) int64)."""
    return (pixel_index.to(torch.int64)
            + (frame_seeds.to(torch.int64)[:, None] & MASK)) & MASK


def advance(state, n: int = 1):
    a, c = _affine(n)
    return (_mulmod(state, a) + c) & MASK


def _extract(state):
    result = _mulmod((state >> ((state >> 28) + 4)) ^ state, MIX)
    return (result >> 22) ^ result


def peek_uniform(state, offset: int, dtype):
    bits = _extract(advance(state, offset))
    return (bits.to(torch.float32) * INV32).to(dtype)


def normal_from(u1, u2):
    return sqrt(-2.0 * torch.log(u2)) * torch.cos(TWO_PI * u1)


# ---- camera ---------------------------------------------------------------

def rotation_matrix(rot):
    """(..., 3) Euler angles -> (..., 3, 3), R = Rz Ry Rx."""
    rx, ry, rz = rot[..., 0], rot[..., 1], rot[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rows = [[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def apply(m, p):
    """m @ p for p (..., 3), summed left to right."""
    return (m[..., 0] * p[..., 0:1] + m[..., 1] * p[..., 1:2]
            + m[..., 2] * p[..., 2:3])


def pixel_uv(index, width: int, height: int):
    """(P, 2) float32 uv of the centres of pixels `index` (py * W + px),
    as the renderer computes them for the whole image."""
    px, py = index % width, index // width
    u = (px.to(torch.float32) + 0.5) / float(width)
    v = (py.to(torch.float32) + 0.5) / float(height)
    return torch.stack([u, v], dim=-1)


def primary_directions(uv, rotmat, cam_size, focal_length, h_ratio):
    x = (uv[..., 0] * 2.0 - 1.0) * float(np.float32(-cam_size))
    y = (uv[..., 1] * 2.0 - 1.0) * float(np.float32(h_ratio * cam_size))
    z = torch.full_like(x, float(np.float32(focal_length)))
    return apply(rotmat, torch.stack([x, y, z], dim=-1))


def dof_ray(origin, direction, rotmat, blur: float, focal_distance, state):
    """The camera's ray with depth of field (frag.glsl:899-908): 6 draws
    whatever `blur` is. Returns (origin, unit direction, state), (R, 3)."""
    focal_point = origin + direction * focal_distance
    origin_j = origin.expand(direction.shape)
    if blur != 0.0:
        us = [peek_uniform(state, i, direction.dtype) for i in range(1, 7)]
        jitter = torch.stack([normal_from(us[0], us[1]),
                              normal_from(us[2], us[3]),
                              normal_from(us[4], us[5])], dim=-1)
        origin_j = origin + apply(rotmat, jitter * float(np.float32(blur)))
    dd = focal_point - origin_j
    mag = sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
               + dd[..., 2] * dd[..., 2])
    return origin_j, dd / mag[..., None], advance(state, 6)


# ---- sky ------------------------------------------------------------------

def sky_uv(dx, dy, dz):
    if dx.device.type == "cpu" and dx.dtype == torch.float32:
        yaw = torch.atan2(dz.double(), dx.double()).float()
        pitch = torch.asin(torch.clamp(dy, -1.0, 1.0).double()).float()
    else:
        yaw = torch.atan2(dz, dx)
        pitch = torch.asin(torch.clamp(dy, -1.0, 1.0))
    return 0.5 + yaw / SKY_U_DIV, 0.5 - pitch / SKY_V_DIV


def sky(image, d):
    """Bilinear REPEAT sample of the (h, w, 3) equirect `image` in
    directions d = (x, y, z): (r, g, b)."""
    h, w = image.shape[0], image.shape[1]
    flat = image.reshape(h * w, 3)
    u, v = sky_uv(*d)
    x = u * float(w) - 0.5
    y = v * float(h) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0l, y0l = x0.to(torch.int64), y0.to(torch.int64)
    x0i, x1i = torch.remainder(x0l, w), torch.remainder(x0l + 1, w)
    y0i, y1i = torch.remainder(y0l, h), torch.remainder(y0l + 1, h)
    top = flat[y0i * w + x0i] * (1.0 - fx) + flat[y0i * w + x1i] * fx
    bot = flat[y1i * w + x0i] * (1.0 - fx) + flat[y1i * w + x1i] * fx
    c = top * (1.0 - fy) + bot * fy
    return c[:, 0], c[:, 1], c[:, 2]
