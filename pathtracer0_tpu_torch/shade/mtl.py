"""Material decode and texture-map overrides (frag.glsl:97-225).

`decode` splits (B,) material records into named fields; `decode_legacy`
does the same for the legacy 18-float records (`LegacyMat`). `apply_maps`
(mapMtl) multiplies Ka/Kd by their map sample and replaces Ks, Ke, d, Tr,
Ns, Pm, Pr, Ps, Pc by theirs; `shading_normal` does tangent-space normal
mapping. Both come in two forms: over the padded (K, Hm, Wm, 3) texture
array (the JAX package's interface) and over the packed scene's atlas
(`map_sample`, used by the frame integrator).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import sqrt
from ..scene.material import COL
from ..scene.packing import MAP_CHANNELS
from ..scene.texture import bilinear, sample_bilinear


class Mtl(NamedTuple):
    Ka: torch.Tensor   # (B, 3)
    Kd: torch.Tensor
    Ks: torch.Tensor
    Ns: torch.Tensor   # (B,)
    d: torch.Tensor
    Tr: torch.Tensor
    Tf: torch.Tensor   # (B, 3)
    Ni: torch.Tensor
    Ke: torch.Tensor   # (B, 3)
    Density: torch.Tensor
    illum: torch.Tensor  # (B,) int64
    Pm: torch.Tensor
    Pr: torch.Tensor
    Ps: torch.Tensor
    Pc: torch.Tensor
    Pcr: torch.Tensor
    aniso: torch.Tensor
    anisor: torch.Tensor
    subsurface: torch.Tensor
    subsurfaceColor: torch.Tensor   # (B, 3)
    subsurfaceRadius: torch.Tensor  # (B, 3)
    map_norm: torch.Tensor          # (B,) int64


def decode(materials, mat_idx):
    """newMtl (frag.glsl:170-209): gather records; a negative index (no
    material) decodes material 0. Returns (Mtl, raw records)."""
    rec = materials[torch.clamp(mat_idx.to(torch.int64), min=0)]

    def f(name):
        return rec[..., COL[name]]

    def v3(name):
        c = COL[name]
        return rec[..., c:c + 3]

    return Mtl(
        Ka=v3("Ka"), Kd=v3("Kd"), Ks=v3("Ks"), Ns=f("Ns"), d=f("d"),
        Tr=f("Tr"), Tf=v3("Tf"), Ni=f("Ni"), Ke=v3("Ke"),
        Density=f("Density"), illum=f("illum").to(torch.int64),
        Pm=f("Pm"), Pr=f("Pr"), Ps=f("Ps"), Pc=f("Pc"), Pcr=f("Pcr"),
        aniso=f("aniso"), anisor=f("anisor"), subsurface=f("subsurface"),
        subsurfaceColor=v3("subsurfaceColor"),
        subsurfaceRadius=v3("subsurfaceRadius"),
        map_norm=f("map_norm").to(torch.int64),
    ), rec


class LegacyMat(NamedTuple):
    """The legacy 18-float `mat` record (raytrace.glsl:75-88)."""

    Ka: torch.Tensor            # (B, 3)
    Kd: torch.Tensor
    Ks: torch.Tensor
    alpha: torch.Tensor         # (B,) Phong exponent
    refl: torch.Tensor          # reflectivity 0-1
    trans: torch.Tensor         # transmission 0-1
    refr_index: torch.Tensor
    emission: torch.Tensor      # emission strength
    emissive_radius: torch.Tensor
    solid: torch.Tensor         # bool
    absorption: torch.Tensor
    texture_id: torch.Tensor    # int64


def decode_legacy(legacy_mats, mat_idx):
    """newMat (raytrace.glsl:162-178) over PackedScene.legacy_mats (the
    records of Scene.add_mat, in its argument order); a negative index
    decodes record 0. The texture id is each record's own column 17: the
    reference reads `MatData[17*m + 18]`, another record's float for
    m > 0."""
    rec = legacy_mats[torch.clamp(mat_idx.to(torch.int64), min=0)]
    return LegacyMat(
        Ka=rec[..., 0:3], Kd=rec[..., 3:6], Ks=rec[..., 6:9],
        alpha=rec[..., 9], refl=rec[..., 10], trans=rec[..., 11],
        refr_index=rec[..., 12], emission=rec[..., 13],
        emissive_radius=rec[..., 14], solid=rec[..., 15] != 0.0,
        absorption=rec[..., 16], texture_id=rec[..., 17].to(torch.int64))


_RGB_MAPS = (("Ka", "map_Ka", True), ("Kd", "map_Kd", True),
             ("Ks", "map_Ks", False), ("Ke", "map_Ke", False))
_SCALAR_MAPS = (("d", "map_d"), ("Tr", "map_Tr"), ("Ns", "map_Ns"),
                ("Pm", "map_Pm"), ("Pr", "map_Pr"), ("Ps", "map_Ps"),
                ("Pc", "map_Pc"))


def apply_maps(m: Mtl, rec, uv, tex_data, tex_sizes, enable: bool = True):
    """mapMtl (frag.glsl:210-225) over the padded texture array."""
    if not enable:
        return m
    out = {}
    for field, name, multiply in _RGB_MAPS:
        idx = rec[..., COL[name]].to(torch.int64)
        tex = sample_bilinear(tex_data, tex_sizes, torch.clamp(idx, min=0),
                              uv)
        if multiply:
            tex = tex * getattr(m, field)
        out[field] = torch.where((idx > -1)[..., None], tex,
                                 getattr(m, field))
    for field, name in _SCALAR_MAPS:
        idx = rec[..., COL[name]].to(torch.int64)
        tex = sample_bilinear(tex_data, tex_sizes, torch.clamp(idx, min=0),
                              uv)[..., 0]
        out[field] = torch.where(idx > -1, tex, getattr(m, field))
    return m._replace(**out)


def tbn_map(nrm, tangent, sample):
    """Normal mapping: n_ts = sample*2 - 1 and
    N = normalize(T n_ts.x + (N x T) n_ts.y + N n_ts.z), the magnitude
    floored at 1e-20. nrm, tangent, sample are (x, y, z) tuples."""
    nx, ny, nz = nrm
    gx, gy, gz = tangent
    bx = ny * gz - nz * gy
    by = nz * gx - nx * gz
    bz = nx * gy - ny * gx
    ax, ay, az = (s * 2.0 - 1.0 for s in sample)
    mx = gx * ax + bx * ay + nx * az
    my = gy * ax + by * ay + ny * az
    mz = gz * ax + bz * ay + nz * az
    mm = torch.clamp(sqrt(mx * mx + my * my + mz * mz), min=1e-20)
    return mx / mm, my / mm, mz / mm


def shading_normal(m: Mtl, geom_norm, tangent, uv, tex_data, tex_sizes,
                   enable: bool = True):
    """Tangent-space normal mapping over the padded texture array; (B, 3)
    normal and tangent."""
    if not enable:
        return geom_norm
    tex = sample_bilinear(tex_data, tex_sizes,
                          torch.clamp(m.map_norm, min=0), uv)
    soa = lambda v: (v[..., 0], v[..., 1], v[..., 2])  # noqa: E731
    mapped = torch.stack(tbn_map(soa(geom_norm), soa(tangent), soa(tex)), -1)
    return torch.where((m.map_norm > -1)[..., None], mapped, geom_norm)


def map_sample(scene, mat, channel: str, tu, tv):
    """Sample the map that each lane's material binds to `channel` from
    the packed atlas. Returns (bound (B,) bool, sample (B, 3))."""
    slot = scene.mat_maps[mat, MAP_CHANNELS.index(channel)].to(torch.int64)
    bound = slot >= 0
    shp = scene.slots[torch.clamp(slot, min=0)].to(torch.int64)
    sample = bilinear(scene.atlas, shp[:, 2], shp[:, 1], shp[:, 0],
                      shp[:, 1], tu, tv)
    return bound, sample
