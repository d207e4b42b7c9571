"""Fresnel and the branchless lobe choice (frag.glsl:726-809).

The GLSL `chooseRay` branches on a roll and consumes a data-dependent
number of draws. Here every candidate direction is built from draws
PEEKED at the stream offsets its branch would read, the winner is chosen
by masks, and the state advances by the count that branch consumed:

  1      roll
  2..7   lambertian vec (reflect / clearcoat / plain diffuse)
  2      subsurface sub-roll (materials with subsurface > 0)
  3..8   lambertian vec when the sub-roll path is taken
consumed: transmission 1, diffuse with subsurface present 8, else 7.
Lobe ids: 0 diffuse, 1 reflect, 2 clearcoat, 3 transmission, 4 subsurface.

Vectors are (x, y, z) tuples of (B,) tensors and every dot product is
summed x, y, z in that order, the order the CUDA kernel uses
(csrc/pathtrace.cuh `choose_ray`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as vrng
from ..core.math import sqrt


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def unit3(a):
    m = sqrt(dot3(a, a))
    return (a[0] / m, a[1] / m, a[2] / m)


def fresnel_soa(n1, n2, nrm, d):
    """Schlick with total internal reflection (frag.glsl:726-743)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(nrm, d)
    rn = n1 / n2
    sin_t2 = rn * rn * (1.0 - cos_x * cos_x)
    tir = (n1 > n2) & (sin_t2 > 1.0)
    cos_x = torch.where(n1 > n2, sqrt(torch.clamp(1.0 - sin_t2, min=0.0)),
                        cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    return torch.where(tir, torch.ones_like(ret), ret)


class Lobe(NamedTuple):
    direction: tuple   # (x, y, z)
    win: torch.Tensor  # (B,) int64 lobe id
    state: torch.Tensor


def choose_ray_soa(Pr, Pm, Pc, Pcr, Tr, Tf, illum, subsurface, n1, n2,
                   nrm, d, state) -> Lobe:
    """chooseRay for SoA material fields; nrm faces the incoming ray."""
    reflection_w = 1.0 - Pr
    tf_mean = (Tf[0] + Tf[1] + Tf[2]) / 3.0
    zero = torch.zeros_like(Pr)
    transmission_w = torch.where(
        Tr > 0.0, Tr, torch.where(Tf[0] > 0.0, tf_mean, zero))
    eta = n1 / n2
    do_fresnel = (illum == 5.0) | (illum == 7.0) | (transmission_w > 0.0)
    fresnel = torch.where(do_fresnel, fresnel_soa(n1, n2, nrm, d), zero)
    reflection_w = reflection_w + fresnel * Pr
    transmission_w = transmission_w * (1.0 - fresnel)
    diffuse_w = (1.0 - Pm) * (1.0 - transmission_w) * (1.0 - fresnel)
    # GLSL divides unconditionally: total == 0 gives NaN weights and every
    # roll comparison false -> diffuse, as in the shader
    total = diffuse_w + reflection_w + Pc + transmission_w
    rw = reflection_w / total
    cw = Pc / total
    tw = transmission_w / total

    p = [vrng.peek_uniform(state, off) for off in range(1, 9)]
    roll, sub_roll = p[0], p[1]
    lp = (vrng.normal_from(p[1], p[2]), vrng.normal_from(p[3], p[4]),
          vrng.normal_from(p[5], p[6]))
    ls = (vrng.normal_from(p[2], p[3]), vrng.normal_from(p[4], p[5]),
          vrng.normal_from(p[6], p[7]))

    dn = dot3(nrm, d)
    refl = tuple(d[i] - 2.0 * dn * nrm[i] for i in range(3))
    cos_plain = unit3(tuple(lp[i] + nrm[i] for i in range(3)))
    cos_sub = unit3(tuple(ls[i] + nrm[i] for i in range(3)))
    coat = tuple(refl[i] * (1.0 - Pcr) + cos_plain[i] * Pcr
                 for i in range(3))
    kk = 1.0 - eta * eta * (1.0 - dn * dn)
    tir = kk < 0.0
    ksq = sqrt(torch.clamp(kk, min=0.0))
    refr = tuple(torch.where(tir, zero, eta * d[i] - (eta * dn + ksq) * nrm[i])
                 for i in range(3))

    t1 = rw
    t2 = t1 + cw
    t3 = t2 + tw
    is_reflect = roll < t1
    is_coat = (~is_reflect) & (roll < t2)
    is_trans = (~is_reflect) & (~is_coat) & (roll < t3)
    is_else = ~(is_reflect | is_coat | is_trans)
    has_ss = subsurface > 0.0
    is_sub = is_else & has_ss & (sub_roll < subsurface)

    win = torch.where(is_reflect, 1, torch.where(
        is_coat, 2, torch.where(is_trans, 3, torch.where(is_sub, 4, 0))))
    direction = tuple(
        torch.where(is_reflect, refl[i], torch.where(
            is_coat, coat[i], torch.where(
                is_trans, refr[i],
                torch.where(has_ss, cos_sub[i], cos_plain[i]))))
        for i in range(3))
    new_state = torch.where(is_trans, vrng.advance(state, 1), torch.where(
        is_else & has_ss, vrng.advance(state, 8), vrng.advance(state, 7)))
    return Lobe(direction, win, new_state)


def _soa(v):
    return (v[..., 0], v[..., 1], v[..., 2])


def fresnel_reflect_amount(n1, n2, normal, incidence):
    """(B,) Fresnel weight for (B, 3) normal and incidence."""
    return fresnel_soa(n1, n2, _soa(normal), _soa(incidence))


def choose_ray(m, n1, n2, N, D, state) -> Lobe:
    """chooseRay on a decoded `shade.mtl.Mtl`; N, D are (B, 3).
    Returns a Lobe whose direction is (B, 3)."""
    lobe = choose_ray_soa(m.Pr, m.Pm, m.Pc, m.Pcr, m.Tr, _soa(m.Tf),
                          m.illum.to(torch.float32), m.subsurface, n1, n2,
                          _soa(N), _soa(D), state)
    return Lobe(torch.stack(lobe.direction, dim=-1), lobe.win, lobe.state)
