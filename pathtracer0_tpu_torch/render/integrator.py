"""Integrators: the path `trace` (frag.glsl:810-882) and Whitted
`direct_diffuse` (frag.glsl:655-681), as batched PyTorch ops on (R,)
tensors, one tensor per vector component.

Two scene queries feed one bounce loop and one shading helper:

  per-bounce route  kernels/traverse.ray_scene: the SAH forest (the CUDA
                    forest kernels on the card) or, for a streamed scene,
                    the two-level LBVH (the streamed kernel), then the
                    analytic primitives. `trace_bounces`, `direct_diffuse`.
                    The JAX
                    package runs this loop as XLA ops, not as a Pallas
                    kernel, so plain PyTorch is the port of it.
  brute force       `closest_hit`: every triangle with the division-free
                    Möller-Trumbore test, first closest in table order
                    wins. `trace_plain` and `direct_diffuse_plain` follow
                    csrc/integrate.cuh operation for operation and are the
                    plain versions of the frame and block kernels, and the
                    oracle of small scenes.

  per bounce    material decode + maps -> normal flip by sign(N.D) ->
                refraction-index stack push (entering) / pop -> chooseRay
                -> medium bookkeeping -> emission -> throughput cutoff
                |col| < 0.1 -> Beer-Lambert | subsurface passthrough |
                col *= Ks or Kd
  miss          sky(d) * throughput on each channel whose throughput is
                positive; the ray ends

The RNG state advances only for rays that hit in that bounce; a ray's
scene queries (bounces it started alive) are counted per ray. `trace`
sends rays to the block kernel (kernels/fused.trace_fused) where the scene
is eligible and `fused` is not "off", else through `trace_bounces`; a
streamed scene is never eligible, and fused="on" refuses it.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.math import sqrt
from ..kernels import traverse
from ..kernels.intersect import MISS, tri_candidate
from ..kernels.traverse import Hit, SurfaceSample
from ..scene.material import COL
from ..scene.texture import bilinear, sky_uv
from ..shade import bsdf
from ..shade.mtl import map_sample, tbn_map

AIR_IOR = float(np.float32(1.0029))   # frag.glsl:816
NUDGE = traverse.NUDGE


def closest_hit(scene, info, o, d, alive) -> Hit:
    """Brute-force closest hit of rays from the (already nudged) origins o
    along d: (x, y, z) tuples of (R,) tensors; rays not `alive` come back
    t = 0."""
    hit = traverse.empty_hit(torch.where(alive, MISS, 0.0))
    if info.num_tris:
        tn = hit.t
        td = torch.ones_like(tn)
        un = vn = torch.zeros_like(tn)
        hid = hit.tri
        for k in range(info.num_tris):
            row = [scene.tris[k, i] for i in range(9)]
            ok, tc, adet, uc, vc = tri_candidate(o, d, row[0:3], row[3:6],
                                                 row[6:9])
            ok = ok & (tc * td < tn * adet)
            tn = torch.where(ok, tc, tn)
            td = torch.where(ok, adet, td)
            un = torch.where(ok, uc, un)
            vn = torch.where(ok, vc, vn)
            hid = torch.where(ok, k, hid)
        invd = 1.0 / td
        got = hid >= 0
        obj = torch.where(
            got, scene.tri_obj[torch.clamp(hid, min=0)].to(torch.int64), -1)
        hit = Hit(tn * invd, hid, un * invd, vn * invd, obj,
                  got.to(torch.int64), hit.prim)
    return traverse._merge_analytic_batched(o, d, scene, info, hit)


def _brute_query(scene, info):
    def query(o, d, alive):
        on = traverse.nudged(o, d)
        return closest_hit(scene, info, on, d, alive), on
    return query


def _forest_query(scene, info, pallas):
    def query(o, d, alive):
        return traverse.ray_scene(o, d, scene, info, pallas=pallas,
                                  active=alive)
    return query


def shade_setup(scene, info, surf: SurfaceSample, names, channels):
    """Material decode, mapMtl and normal mapping at the hits: the one
    shading helper of both routes and of the legacy modes
    (shade/arealights.py). `names` are the COL fields wanted
    (three-wide ones come back as (r, g, b) tuples); Ka/Kd multiply their
    map sample, the rest are replaced by it. Returns (fields, shading
    normal)."""
    mat = torch.clamp(surf.mat, min=0)     # a miss decodes material 0
    rec = scene.materials[mat]
    fields = {}
    for name in names:
        c = COL[name]
        fields[name] = ((rec[:, c], rec[:, c + 1], rec[:, c + 2])
                        if name in _RGB else rec[:, c])
    n = surf.norm
    if not info.map_bindings:
        return fields, n
    bound_channels = {b[0] for b in info.map_bindings}
    tu, tv = surf.uv
    for ch in channels:
        if ch not in bound_channels:
            continue
        bound, s = map_sample(scene, mat, ch, tu, tv)
        name = ch[4:]
        if ch == "map_norm":
            mapped = tbn_map(n, surf.tangent, (s[:, 0], s[:, 1], s[:, 2]))
            n = tuple(torch.where(bound, mapped[i], n[i]) for i in range(3))
        elif name in ("Ka", "Kd"):
            fields[name] = tuple(torch.where(bound, fields[name][i] * s[:, i],
                                             fields[name][i])
                                 for i in range(3))
        elif name in ("Ks", "Ke"):
            fields[name] = tuple(torch.where(bound, s[:, i], fields[name][i])
                                 for i in range(3))
        else:
            fields[name] = torch.where(bound, s[:, 0], fields[name])
    return fields, n


def sky(scene, info, d):
    """Equirect sky colour (r, g, b) of directions d."""
    u, v = sky_uv(*d)
    h, w = info.sky_shape
    c = bilinear(scene.sky, 0, w, torch.tensor(h, device=u.device),
                 torch.tensor(w, device=u.device), u, v)
    return c[:, 0], c[:, 1], c[:, 2]


_RGB = ("Ka", "Kd", "Ks", "Ke", "Tf", "subsurfaceColor", "subsurfaceRadius")
_PATH_MAPS = ("map_Kd", "map_Pm", "map_Pr", "map_norm", "map_Ks", "map_Pc",
              "map_Tr", "map_Ke")
_PATH_FIELDS = ("Kd", "Ks", "Ke", "Tr", "Pm", "Pr", "Pc", "Tf", "Density",
                "Ni", "Pcr", "illum", "subsurface")
_WHITTED_MAPS = ("map_Ka", "map_Kd", "map_Ke", "map_norm")
_WHITTED_FIELDS = ("Ka", "Kd", "Ke", "subsurface", "subsurfaceColor",
                   "subsurfaceRadius")


def _bounce_loop(query, scene, info, o, d, alive, state, *, max_bounces: int,
                 stack_size: int):
    """The bounce loop over `query(o, d, alive) -> (Hit, nudged origins)`.
    Returns (radiance without sky (r, g, b), sky radiance (r, g, b),
    state, queries (R,) int64). One host sync per bounce (`alive.any()`)."""
    if stack_size < 2:
        raise ValueError("the refraction stack needs at least 2 entries")
    f0 = torch.zeros_like(o[0])
    one = torch.ones_like(f0)
    col = (one, one, one)
    inc = (f0, f0, f0)
    skyc = (f0, f0, f0)
    stack = torch.zeros(f0.shape + (stack_size,), dtype=torch.float32,
                        device=f0.device)
    stack[:, 0] = AIR_IOR
    ssize = torch.ones(f0.shape, dtype=torch.int64, device=f0.device)
    inobj = torch.zeros_like(alive)
    enter = (f0, f0, f0)
    queries = torch.zeros_like(ssize)
    for _ in range(max_bounces):
        if not bool(alive.any()):
            break
        queries = queries + alive.to(torch.int64)
        hit, on = query(o, d, alive)
        surf = traverse.surface_sample(hit, on, d, scene, info)
        hitf = alive & hit.is_hit
        is_miss = alive & ~hit.is_hit
        hx = surf.loc

        m, n = shade_setup(scene, info, surf, _PATH_FIELDS, _PATH_MAPS)
        Kd, Ks, Ke, Tf = m["Kd"], m["Ks"], m["Ke"], m["Tf"]

        # normal flip by sign(N.D) (frag.glsl:829-830)
        nd = bsdf.dot3(n, d)
        flip = torch.where(nd > 0.0, -1.0, 1.0)
        n = (n[0] * flip, n[1] * flip, n[2] * flip)

        # refraction-index stack (frag.glsl:832-841)
        entering = nd < 0.0
        do_push = entering & (ssize < stack_size)
        pushed = torch.where(do_push[:, None],
                             torch.cat([m["Ni"][:, None], stack[:, :-1]], 1),
                             stack)
        size_push = torch.where(do_push, ssize + 1, ssize)
        n1 = torch.where(entering, pushed[:, 1], stack[:, 0])
        n2 = torch.where(entering, pushed[:, 0], stack[:, 1])
        do_pop = (~entering) & (ssize > 0)
        popped = torch.where(do_pop[:, None],
                             torch.cat([pushed[:, 1:], f0[:, None]], 1),
                             pushed)
        new_size = torch.where(do_pop, ssize - 1, size_push)

        lobe = bsdf.choose_ray_soa(
            m["Pr"], m["Pm"], m["Pc"], m["Pcr"], m["Tr"], Tf, m["illum"],
            m["subsurface"], n1, n2, n, d, state)

        # medium bookkeeping (frag.glsl:847-863)
        transmitted = lobe.win == 3
        dd = tuple(enter[i] - hx[i] for i in range(3))
        dist = sqrt(bsdf.dot3(dd, dd))
        apply_absorb = transmitted & ((~entering) | inobj)
        new_inobj = torch.where(transmitted, entering, inobj)
        enter_now = transmitted & entering
        new_enter = tuple(torch.where(enter_now, hx[i], enter[i])
                          for i in range(3))

        # transport (frag.glsl:865-874)
        inc = tuple(inc[i] + torch.where(hitf, Ke[i] * col[i], 0.0)
                    for i in range(3))
        cutoff = sqrt(bsdf.dot3(col, col)) < 0.1
        spec = lobe.win == 2
        passthrough = lobe.win == 4
        new_col = []
        for i in range(3):
            c = col[i] * torch.where(spec, Ks[i], Kd[i])
            c = torch.where(passthrough, col[i], c)
            absorbed = col[i] * torch.exp(-Tf[i] * dist * m["Density"])
            new_col.append(torch.where(apply_absorb, absorbed, c))

        # miss: sky on each channel with positive throughput; the ray ends
        sr = sky(scene, info, d)
        skyc = tuple(skyc[i] + torch.where(is_miss & (col[i] > 0.0),
                                           sr[i] * col[i], 0.0)
                     for i in range(3))

        def upd(new, old):
            return torch.where(hitf, new, old)

        o = tuple(upd(hx[i], o[i]) for i in range(3))
        d = tuple(upd(lobe.direction[i], d[i]) for i in range(3))
        col = tuple(upd(new_col[i], col[i]) for i in range(3))
        stack = torch.where(hitf[:, None], popped, stack)
        ssize = torch.where(hitf, new_size, ssize)
        inobj = torch.where(hitf, new_inobj, inobj)
        enter = tuple(upd(new_enter[i], enter[i]) for i in range(3))
        state = torch.where(hitf, lobe.state, state)
        alive = hitf & ~cutoff
    return inc, skyc, state, queries


def trace_plain(scene, info, o, d, alive, state, *, max_bounces: int,
                stack_size: int = 10):
    """Path integrator over the brute-force `closest_hit`: the plain
    version of the frame and block kernels. o, d (x, y, z) tuples of (R,);
    d normalized. Returns as `_bounce_loop`."""
    return _bounce_loop(_brute_query(scene, info), scene, info, o, d, alive,
                        state, max_bounces=max_bounces,
                        stack_size=stack_size)


def trace_bounces(scene, info, o, d, alive, state, *, max_bounces: int,
                  stack_size: int = 10, pallas: str = "auto"):
    """Path integrator of the per-bounce route: every bounce one
    `ray_scene` over the forest. Returns as `_bounce_loop`."""
    return _bounce_loop(_forest_query(scene, info, pallas), scene, info, o,
                        d, alive, state, max_bounces=max_bounces,
                        stack_size=stack_size)


def check_fused(info, fused: str):
    """Refuse a value of `fused` that is none of "auto", "on", "off", and
    fused="on" on a streamed scene: the block kernel reads the dense
    triangle table of small scenes, and a streamed scene renders through
    the per-bounce route alone."""
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off', not {fused!r}")
    if fused == "on" and info.streamed:
        raise ValueError(
            "fused='on' on a streamed scene: it renders through the "
            "per-bounce route alone")


def trace(scene, info, o, d, alive, state, *, max_bounces: int,
          stack_size: int = 10, fused: str = "auto", pallas: str = "auto"):
    """Path integrator of one sample's rays. fused "auto" / "on": the
    block kernel where the scene is eligible (kernels/fused.trace_fused);
    "off", or a scene it does not take: the per-bounce route.

    Returns (radiance with sky (r, g, b), state, queries (1,) int64)."""
    from ..kernels import fused as fused_mod

    check_fused(info, fused)
    if fused != "off":
        if fused_mod.eligible(info):
            return fused_mod.trace_fused(
                scene, info, o, d, alive, state, max_bounces=max_bounces,
                stack_size=stack_size)
        if fused == "on":
            warnings.warn(
                "fused='on' requested but the scene is outside the block "
                f"kernel ({info.num_tris} triangles, {info.num_materials} "
                "materials); using the per-bounce route", stacklevel=2)
    inc, skyc, state, queries = trace_bounces(
        scene, info, o, d, alive, state, max_bounces=max_bounces,
        stack_size=stack_size, pallas=pallas)
    return (tuple(inc[i] + skyc[i] for i in range(3)), state,
            queries.sum().reshape(1))


def _direct(query, scene, info, o, d, alive, probe):
    hit, on = query(o, d, alive)
    surf = traverse.surface_sample(hit, on, d, scene, info)
    m, n = shade_setup(scene, info, surf, _WHITTED_FIELDS, _WHITTED_MAPS)
    col = [m["Ka"][i] + m["Kd"][i] * (0.2 + n[1]) + m["Ke"][i]
           for i in range(3)]
    if probe is not None and info.mat_gates[0] and traverse.has_tree(info):
        # thickness: the same direction again from the hit point
        # (frag.glsl:662-676), the distance actually travelled
        si = probe(surf.loc, d)
        has_ss = m["subsurface"] > 0.0
        for i in range(3):
            sigma_t = 1.0 / torch.clamp(m["subsurfaceRadius"][i], min=1e-4)
            col[i] = torch.where(
                has_ss, torch.exp(-sigma_t * si) * m["subsurfaceColor"][i],
                col[i])
    sr = sky(scene, info, d)
    return tuple(torch.where(alive & hit.is_hit, col[i], 0.0)
                 + torch.where(alive & ~hit.is_hit, sr[i], 0.0)
                 for i in range(3))


def direct_diffuse(scene, info, o, d, alive, *, pallas: str = "auto"):
    """Whitted shade of the per-bounce route: Ka + Kd (0.2 + N.y) + Ke on
    a hit with the unflipped (possibly normal-mapped) normal, the sky on a
    miss. Subsurface materials shade by the thickness behind the hit,
    probed through the whole forest or the streamed LBVH (the reference
    probes the hit object alone: the two differ only where another object
    cuts the segment)."""
    def probe(loc, direction):
        return traverse.probe_forest_t(loc, direction, scene, info,
                                       pallas=pallas)

    return _direct(_forest_query(scene, info, pallas), scene, info, o, d,
                   alive, probe)


def direct_diffuse_plain(scene, info, o, d, alive):
    """Whitted shade over the brute-force `closest_hit`: the plain version
    of the frame kernel's Whitted mode, which has no thickness probe."""
    if info.mat_gates[0]:
        raise ValueError("Whitted shading of subsurface materials needs "
                         "the thickness probe: use direct_diffuse")
    return _direct(_brute_query(scene, info), scene, info, o, d, alive, None)
