"""Texture registry and bilinear REPEAT sampling (dispatch.java:331-379).

Texture 0 is the equirectangular sky (dispatch.java:221-222). Row 0 of an
image is its top row; v = 0 addresses it, and mesh UVs are flipped with
v = 1 - v before sampling (frag.glsl:513).

Sampling is GL_LINEAR with GL_REPEAT (dispatch.java:351-354): texel
centres at integer + 0.5, both taps of a pair wrapped, then
top = c00 (1 - fx) + c01 fx, bottom likewise, result top (1 - fy) + bottom
fy. The CUDA frame kernel (csrc/pathtrace.cuh `bilinear`) does the same
four-tap gather in the same order.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

# float32 constants of the equirect mapping (frag.glsl:235-242)
SKY_U_DIV = float(np.float32(2.0 * 3.14159))
SKY_V_DIV = float(np.float32(3.14159))


class TextureRegistry:
    """Dedup-by-name texture store (dispatch.java:95-96, 1368-1375)."""

    def __init__(self):
        self.names: List[str] = []
        self.images: List[np.ndarray] = []  # (H, W, 3) float32 in [0, 1]

    def __len__(self):
        return len(self.images)

    def register(self, path: str, name: Optional[str] = None) -> int:
        name = name if name is not None else path
        if name in self.names:
            return self.names.index(name)
        return self.register_array(_load_image(path), name)

    def register_array(self, img: np.ndarray, name: str) -> int:
        if name in self.names:
            return self.names.index(name)
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] > 3:
            img = img[..., :3]
        self.names.append(name)
        self.images.append(np.ascontiguousarray(img))
        return len(self.images) - 1

    def pack(self) -> Tuple[np.ndarray, np.ndarray]:
        """All textures padded to the largest extent: ((K, Hm, Wm, 3)
        data, (K, 2) int32 sizes). A 1x1 mid-gray texture stands in for a
        missing sky."""
        if not self.images:
            return (np.full((1, 1, 1, 3), 0.5, np.float32),
                    np.ones((1, 2), np.int32))
        hmax = max(im.shape[0] for im in self.images)
        wmax = max(im.shape[1] for im in self.images)
        data = np.zeros((len(self.images), hmax, wmax, 3), np.float32)
        sizes = np.zeros((len(self.images), 2), np.int32)
        for i, im in enumerate(self.images):
            data[i, : im.shape[0], : im.shape[1]] = im
            sizes[i] = (im.shape[0], im.shape[1])
        return data, sizes


def _load_image(path: str) -> np.ndarray:
    from ..utils.image import read_png

    return read_png(path, flip=False)


def bilinear(flat, base, stride, h, w, u, v):
    """Bilinear REPEAT sample of texels stored row-major in `flat`
    ((N, 3) float32): texel (y, x) of an image sits at base + y*stride + x.
    base/stride/h/w are int64 tensors broadcastable against u/v."""
    x = u * w.to(torch.float32) - 0.5
    y = v * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0l = x0.to(torch.int64)
    y0l = y0.to(torch.int64)
    x0i = torch.remainder(x0l, w)
    x1i = torch.remainder(x0l + 1, w)
    y0i = torch.remainder(y0l, h)
    y1i = torch.remainder(y0l + 1, h)
    c00 = flat[base + y0i * stride + x0i]
    c01 = flat[base + y0i * stride + x1i]
    c10 = flat[base + y1i * stride + x0i]
    c11 = flat[base + y1i * stride + x1i]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_bilinear(tex_data, tex_sizes, tex_index, uv):
    """Sample the padded (K, Hm, Wm, 3) texture array: tex_index (...,)
    int, uv (..., 2). Returns (..., 3)."""
    K, Hm, Wm, _ = tex_data.shape
    idx = tex_index.to(torch.int64)
    hw = tex_sizes.to(torch.int64)[idx]
    flat = tex_data.reshape(K * Hm * Wm, 3)
    return bilinear(flat, idx * (Hm * Wm), Wm, hw[..., 0], hw[..., 1],
                    uv[..., 0], uv[..., 1])


def sky_uv(dx, dy, dz):
    """Equirect mapping of a direction (frag.glsl:235-242). On the CPU the
    angles are taken in float64 and rounded once: PyTorch's float32 atan2
    and asin there give another ulp in the vector loop than in its scalar
    tail, so a pixel's sky would depend on its place in the batch (a tile
    of several devices against the whole image)."""
    if dx.device.type == "cpu" and dx.dtype == torch.float32:
        yaw = torch.atan2(dz.double(), dx.double()).float()
        pitch = torch.asin(torch.clamp(dy, -1.0, 1.0).double()).float()
    else:
        yaw = torch.atan2(dz, dx)
        pitch = torch.asin(torch.clamp(dy, -1.0, 1.0))
    return 0.5 + yaw / SKY_U_DIV, 0.5 - pitch / SKY_V_DIV


def sky_color_soa(tex_data, tex_sizes, dx, dy, dz):
    """Component-planar `sky_color`: returns (r, g, b) shaped like dx."""
    u, v = sky_uv(dx, dy, dz)
    idx = torch.zeros(dx.shape, dtype=torch.int64, device=dx.device)
    c = sample_bilinear(tex_data, tex_sizes, idx, torch.stack([u, v], -1))
    return c[..., 0], c[..., 1], c[..., 2]


def sky_color(tex_data, tex_sizes, direction):
    """Equirect environment lookup of texture 0: direction (..., 3) ->
    (..., 3)."""
    r, g, b = sky_color_soa(tex_data, tex_sizes, direction[..., 0],
                            direction[..., 1], direction[..., 2])
    return torch.stack([r, g, b], dim=-1)
