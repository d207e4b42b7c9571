"""Counted per-ray PCG-style RNG (frag.glsl:683-714), in PyTorch.

    state   = state * 747796405 + 2891336453            (advance)
    result  = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
    result  = (result >> 22) ^ result                    (extract)
    uniform = result / (2^32 - 1)                        (closed [0, 1])

seeded with `pixelIndex + u_seed` (frag.glsl:896). PyTorch on the CPU has
no uint32 add and no uint32 right shift, so the state is carried as int64
holding a value in [0, 2^32), masked after every step. Products are split
into 16-bit halves so that no intermediate leaves int64's range.

Every function is pure: it takes and returns `state`.
"""
from __future__ import annotations

import numpy as np
import torch

from .math import sqrt

MASK = 0xFFFFFFFF
MUL = 747796405
INC = 2891336453
MIX = 277803737
# 1 / (2^32 - 1) rounded to float32 (frag.glsl:693)
INV32 = float(np.float32(1.0) / np.float32(4294967295.0))
TWO_PI = float(np.float32(2.0 * 3.1415926))


def affine_consts(n: int):
    """(A, C) with advance^n(s) = A*s + C mod 2^32."""
    a, c = 1, 0
    mul, inc = MUL, INC
    k = n
    while k:
        if k & 1:
            a, c = (a * mul) & MASK, (c * mul + inc) & MASK
        inc = ((mul + 1) * inc) & MASK
        mul = (mul * mul) & MASK
        k >>= 1
    return a, c


def mulmod(s: torch.Tensor, a: int) -> torch.Tensor:
    """(s * a) mod 2^32 for s in [0, 2^32) without int64 overflow."""
    lo = s & 0xFFFF
    hi = s >> 16
    return (lo * a + (((hi * a) & 0xFFFF) << 16)) & MASK


def seed(pixel_index: torch.Tensor, frame_seed) -> torch.Tensor:
    """rngState = pixelIndex + u_seed (frag.glsl:896), wrapping uint32.
    `frame_seed` is an int or an int64 tensor of one element on the
    pixels' device (read on the device, never on the host): the same
    bits either way."""
    if isinstance(frame_seed, torch.Tensor):
        frame_seed = frame_seed.to(torch.int64) & MASK
    else:
        frame_seed = int(frame_seed) & MASK
    return (pixel_index.to(torch.int64) + frame_seed) & MASK


def advance(state: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Advance the affine state map n (static) times, in closed form."""
    a, c = affine_consts(n)
    return (mulmod(state, a) + c) & MASK


def advance_select(state, counts, max_count: int):
    """Advance each lane by its own draw count in [0, max_count]."""
    out = state
    for n in range(1, max_count + 1):
        out = torch.where(counts == n, advance(state, n), out)
    return out


def _extract(state):
    """The PCG output permutation of an already advanced state."""
    shift = (state >> 28) + 4
    result = mulmod((state >> shift) ^ state, MIX)
    return (result >> 22) ^ result


def to_unit(bits):
    """uint32 bits -> float32 in [0, 1]: one round-to-nearest convert and
    one multiply by the float32 1/(2^32-1)."""
    return bits.to(torch.float32) * INV32


def next_uint(state):
    state = advance(state)
    return _extract(state), state


def uniform(state):
    """One draw in [0, 1]. Returns (u, new state)."""
    bits, state = next_uint(state)
    return to_unit(bits), state


def peek_uniform(state, offset: int):
    """The uniform `offset` draws ahead, without consuming."""
    return to_unit(_extract(advance(state, offset)))


def normal_from(u1, u2):
    """Box-Muller (frag.glsl:696-701)."""
    theta = TWO_PI * u1
    rho = sqrt(-2.0 * torch.log(u2))
    return rho * torch.cos(theta)


def normal(state):
    u1, state = uniform(state)
    u2, state = uniform(state)
    return normal_from(u1, u2), state


def lambertian_vec(state):
    """3 iid normals from 6 uniforms (frag.glsl:702-708), not normalized."""
    x, state = normal(state)
    y, state = normal(state)
    z, state = normal(state)
    return torch.stack([x, y, z], dim=-1), state


def peek_lambertian_vec(state, offset: int):
    """The lambertian vec a draw `offset` ahead would give (6 peeks)."""
    us = [peek_uniform(state, offset + i) for i in range(1, 7)]
    return torch.stack([normal_from(us[0], us[1]),
                        normal_from(us[2], us[3]),
                        normal_from(us[4], us[5])], dim=-1)


def uniform_cube_vec(state):
    """randUniformDistVec (frag.glsl:709-714): (R, 3) uniform in [-1, 1]^3
    from 3 draws. Returns (vec, new state)."""
    x, state = uniform(state)
    y, state = uniform(state)
    z, state = uniform(state)
    return (torch.stack([x, y, z], dim=-1) - 0.5) * 2.0, state


def disk_sample(state, n):
    """randDiskSamplePoint (frag.glsl:715-723): a point on the unit circle
    in the plane of the (unnormalized) basis n x (0, 1, 0), n x that, for
    n (R, 3); 2 draws. Returns ((R, 3) point, new state)."""
    u, state = uniform(state)
    v, state = uniform(state)
    uv = (torch.stack([u, v], dim=-1) - 0.5) * 2.0
    uv = uv / sqrt(uv[..., 0:1] * uv[..., 0:1] + uv[..., 1:2] * uv[..., 1:2])
    uvec = cross_fms(n, torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype,
                                     device=n.device).expand(n.shape))
    vvec = cross_fms(n, uvec)
    return uvec * uv[..., 0:1] + vvec * uv[..., 1:2], state


def cross_fms(a, b):
    """a x b (..., 3) float32 with each component a fused multiply-add,
    x1 y2 - round(x2 y1), as XLA computes jnp.cross on the CPU: the first
    product and the difference taken in float64 (where the product is
    exact), rounded once to float32."""
    def fms(p, q, r, s):
        return (p.to(torch.float64) * q.to(torch.float64)
                - (r * s).to(torch.float64)).to(torch.float32)

    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fms(a1, b2, a2, b1), fms(a2, b0, a0, b2),
                        fms(a0, b1, a1, b0)], dim=-1)
