"""Rotation conventions (dispatch.java:1157-1191, frag.glsl:244-297).

`rotation_matrix(rot)` is R = Rz(rz) @ Ry(ry) @ Rx(rx), so p' = R @ p is
both the Java `vec.rotate` and the GLSL `rotate(p, rot)`; `rotate_back`
is its transpose. Vectors keep their 3 components on the last axis.
"""
from __future__ import annotations

import torch


def rotation_matrix(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3) Euler angles -> (..., 3, 3), R = Rz @ Ry @ Rx."""
    rx, ry, rz = rot[..., 0], rot[..., 1], rot[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def apply(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """m @ p per batch element, summed left to right (no fused adds)."""
    return (m[..., 0] * p[..., 0:1] + m[..., 1] * p[..., 1:2]
            + m[..., 2] * p[..., 2:3])


def rotate(p: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """p' = Rz Ry Rx p."""
    return apply(rotation_matrix(rot), p)


def rotate_back(p: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Inverse rotation (GLSL rotateBack): R^T p."""
    return apply(rotation_matrix(rot).transpose(-1, -2), p)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device. PyTorch's
    float32 one on the CPU is not always (its vector code misses by an ulp
    on about 1% of inputs); the card's, the kernels' and XLA's are. The
    CPU takes it in float64 and rounds once, so a chaotic consumer (the
    legacy pathTrace's location hash) sees the card's bits."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """GLSL normalize: no epsilon guard."""
    return a / sqrt(torch.sum(a * a, dim=-1, keepdim=True))
