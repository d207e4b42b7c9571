"""Camera: primary rays and depth of field (frag.glsl:894-908).

Pixel (0, 0) is the bottom-left (GL texCoord origin); the PNG writer
flips vertically, like the reference screenshot path.

`primary_directions` and `dof_ray` are the frame path's raygen: they
repeat csrc/frame_kernel.cu's arithmetic in its order (float32 scale
factors, left-to-right sums), so the plain frame and the kernel agree
bit for bit on the primary rays.
"""
from __future__ import annotations

import numpy as np
import torch

from . import math as vm
from . import rng as vrng


def pixel_centers(width: int, height: int, device):
    """((H*W, 2) float32 uv at pixel centres, (H*W,) int64 pixel index
    py * width + px, frag.glsl:885-886)."""
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / float(width)
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / float(height)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
    index = torch.arange(width * height, dtype=torch.int64, device=device)
    return uv, index


def primary_directions(uv, rotmat, cam_size, focal_length,
                       screen_h_ratio):
    """Unnormalized primary directions (frag.glsl:894): R (x, y, f) with
    x = (2u - 1) * -cam_size and y = (2v - 1) * screen_h_ratio * cam_size,
    each scale rounded to float32 once. rotmat is (3, 3)."""
    x = (uv[..., 0] * 2.0 - 1.0) * float(np.float32(-cam_size))
    y = (uv[..., 1] * 2.0 - 1.0) * float(
        np.float32(screen_h_ratio * cam_size))
    z = torch.full_like(x, float(np.float32(focal_length)))
    return vm.apply(rotmat, torch.stack([x, y, z], dim=-1))


def dof_ray(origin, direction, rotmat, blur, focal_distance, state):
    """Jitter the origin by R (lambertian vec * blur) and re-aim at the
    focal point origin + direction * focal_distance (frag.glsl:899-908).
    Consumes 6 draws whatever `blur` is; with blur 0 the origin stays
    put. Returns (origin, normalized direction, state)."""
    focal_point = origin + direction * focal_distance[..., None]
    origin_j = origin.expand(direction.shape)
    if blur != 0.0:
        jitter = vrng.peek_lambertian_vec(state, 0)
        origin_j = origin + vm.apply(rotmat,
                                     jitter * float(np.float32(blur)))
    dd = focal_point - origin_j
    mag = vm.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
                     + dd[..., 2] * dd[..., 2])
    return origin_j, dd / mag[..., None], vrng.advance(state, 6)


def center_probe_direction(rotation):
    """Autofocus probe direction rotate((0, 0, 1), ROTATION)
    (frag.glsl:902)."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                     device=rotation.device)
    return vm.rotate(z, rotation)
