"""Legacy Phong shading with emissive-disk lights and soft shadows, and the
legacy deterministic pathTrace (raytrace.glsl:676-899): counterpart of the
JAX package's shade/arealights.py.

The reference never loads that compute shader (dispatch.java:136-151), so
both are opt-in modes (RenderConfig.legacy_shading, legacy_pathtrace). The
JAX module's semantics are kept, quirks included:

  * a light is a disk (centre, radius) bound to a collection of
    primitives (kind, id range): a shadow ray reaches it when its closest
    hit lands on that collection (raytrace.glsl:700-736);
  * soft shadows: a (S+1)^2 grid over the disk, in the frame
    perpendicular to normalize(hit - centre), of the points within
    radius (1 + 1/S), each shadow direction jittered by half a uniform
    cube draw; S = 1 is one ray at the centre jittered by a whole draw,
    S <= 0 fully lit (raytrace.glsl:705-735). S is SAMPLE_RES, the
    frame's spp;
  * the grid's intensity is the light material's Density (the legacy
    EmissionStrength slot) x the share of points reached; the S = 1 and
    S <= 0 branches give 0 or 1 whatever Density is, so the brightness
    depends on S (raytrace.glsl:708, 729, 738);
  * Phong: illum 0 diffuse, >= 1 adds Ka once, 2 adds
    max(Ks lightKs pow(clamp(R.V, 0, 1), Ns), 0); the pow base is
    clamped first, as a negative base to a fractional Ns is NaN;
  * an emissive surface returns Ke x Density, gated on any Ke > 0 (the
    reference's gate, EmissionStrength > 0, fires on every default
    material, whose Density is 1);
  * path_trace flat-shades each hit, follows the stronger of reflection
    and transmission and samples the weaker once, composited with GLSL
    mix(); the refraction stack is pushed or popped once for the bounce
    and once more for a sampled refraction; glossy refraction perturbs
    the followed direction by the hash fract(sin(.) 47678.786234) of the
    hit location, no draw. With S <= 0 nothing is drawn at all.

The JAX module queries the scene once per grid point. Here the jitters are
drawn in its order (point after point, light after light) and the grid's
shadow rays are stacked into one `ray_scene` per light and shade: one
launch of the forest or streamed kernel instead of up to (S+1)^2. Rays
whose result no pixel uses (misses, emissive hits, finished paths) are
switched off; the draws and the counted queries are the JAX module's all
the same. `_glsl_rand` takes its sine in float64, rounded once to
float32, so the card and the CPU agree on every bit of the hash.

Vectors are (x, y, z) tuples of (R,) tensors, as everywhere in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng as vrng
from ..core.math import sqrt
from ..kernels import traverse
from ..kernels.bounce import AIR_IOR, shade_setup, sky
from ..scene.material import COL
from ..scene.texture import bilinear
from .bsdf import dot3, fresnel_soa, unit3

_FIELDS = ("Ka", "Kd", "Ks", "Ke", "Ns", "Tr", "Tf", "Ni", "Density",
           "illum", "Pm", "Pr")
# mapMtl's channels these fields read; map_Ns is sampled apart (_map_ns)
_MAPS = ("map_Ka", "map_Kd", "map_Ks", "map_Ke", "map_Tr", "map_Pm",
         "map_Pr")
_DISK_TILT = (float(np.float32(0.1)), 31.0, 1.0)   # raytrace.glsl:702
_RAND_X, _RAND_Z = float(np.float32(47.57891)), 425.0
_RAND_SCALE = float(np.float32(47678.786234))


def _add(a, b):
    return tuple(a[i] + b[i] for i in range(3))


def _sub(a, b):
    return tuple(a[i] - b[i] for i in range(3))


def _scale(a, s):
    return tuple(a[i] * s for i in range(3))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _where(c, a, b):
    return tuple(torch.where(c, a[i], b[i]) for i in range(3))


def _mix(a, b, t):
    """GLSL mix, t per channel (a tuple) or per lane."""
    t = t if isinstance(t, tuple) else (t, t, t)
    return tuple(a[i] * (1.0 - t[i]) + b[i] * t[i] for i in range(3))


def _reflect(d, n):
    dn = dot3(n, d)
    return tuple(d[i] - 2.0 * dn * n[i] for i in range(3))


def _refract(d, n, eta):
    """GLSL refract: the zero vector on total internal reflection."""
    cos_i = dot3(n, d)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    root = sqrt(torch.clamp(k, min=0.0))
    return tuple(torch.where(tir, 0.0, eta * d[i] - (eta * cos_i + root)
                             * n[i]) for i in range(3))


def _map_ns(scene, info, mat, uv, ns):
    """Ns replaced by its map_Ns sample where the material binds one (the
    port's per-material map table holds the integrators' channels only)."""
    bound = [(m, slot) for ch, m, slot in info.map_bindings if ch == "map_Ns"]
    if not bound:
        return ns
    table = torch.full((max(info.num_materials, 1),), -1, dtype=torch.int64,
                       device=ns.device)
    for m, slot in bound:
        table[m] = slot
    slot = table[mat]
    shp = scene.slots[torch.clamp(slot, min=0)].to(torch.int64)
    s = bilinear(scene.atlas, shp[:, 2], shp[:, 1], shp[:, 0], shp[:, 1],
                 *uv)
    return torch.where(slot >= 0, s[:, 0], ns)


def _query(o, d, scene, info, active=None):
    """rayScene, the attributes at the hits and the materials with their
    maps (raySceneResult + newMtl + mapMtl): (Hit, SurfaceSample, fields).
    `active` switches rays off (ray_scene)."""
    hit, on = traverse.ray_scene(o, d, scene, info, active=active)
    surf = traverse.surface_sample(hit, on, d, scene, info)
    m, _ = shade_setup(scene, info, surf, _FIELDS, _MAPS)
    if info.map_bindings:
        m["Ns"] = _map_ns(scene, info, torch.clamp(surf.mat, min=0), surf.uv,
                          m["Ns"])
    m["illum"] = m["illum"].to(torch.int64)
    return hit, surf, m


def _collection_hit(hit, kind, id_start, id_end):
    """Whether the closest hit lands on the light's collection."""
    prim = torch.where(hit.kind == 1, hit.tri, hit.prim)
    return (hit.is_hit & (hit.kind == kind) & (prim >= id_start)
            & (prim <= id_end))


def grid_points(sample_res: int):
    """The (l_u, l_v) of the soft-shadow grid inside the disk
    (raytrace.glsl:712-717), in the order their jitters are drawn."""
    pts = []
    for i in range(sample_res + 1):
        l_u = -1.0 + 2.0 * i / sample_res
        for j in range(sample_res + 1):
            l_v = -1.0 + 2.0 * j / sample_res
            if (l_u * l_u + l_v * l_v) ** 0.5 <= 1.0 + 1.0 / sample_res:
                pts.append((l_u, l_v))
    return pts


def draws_per_shade(info, sample_res: int) -> int:
    """RNG draws of one shade_hit, the same for every ray."""
    per_light = (0 if sample_res <= 0 else 3 if sample_res == 1
                 else 3 * len(grid_points(sample_res)))
    return per_light * len(info.lights)


def shade_point(o, d, state, scene, info, sample_res: int):
    """The legacy shadePoint of rays o + t d: ((r, g, b), new state)."""
    hit, surf, m = _query(o, d, scene, info)
    return shade_hit(hit, surf, m, d, state, scene, info, sample_res)


def shade_hit(hit, surf, m, d, state, scene, info, sample_res: int, *,
              live=None):
    """shadePoint over a closest hit already found (raytrace.glsl:676-758):
    Phong from the disk lights, the emissive return, the sky on a miss.
    `live` (R,) bool marks the rays whose colour is used (default: all);
    the others cast no shadow ray, but every ray makes its draws.
    Returns ((r, g, b), new state)."""
    nflip = torch.where(dot3(surf.norm, d) > 0.0, -1.0, 1.0)
    n = _scale(unit3(surf.norm), nflip)
    emissive = (m["Ke"][0] > 0.0) | (m["Ke"][1] > 0.0) | (m["Ke"][2] > 0.0)
    shadowed = hit.is_hit & ~emissive
    if live is not None:
        shadowed = shadowed & live
    loc = surf.loc
    zero = torch.zeros_like(d[0])
    col = (zero, zero, zero)
    did_ambient = torch.zeros_like(shadowed)
    shadow_o = _add(loc, _scale(n, 1e-4))
    for (kind, id_start, id_end, light_mat), center, radius in zip(
            info.lights, info.light_centers, info.light_radii):
        center = tuple(float(np.float32(c)) for c in center)
        radius = float(np.float32(radius))
        lrec = scene.materials[light_mat]
        i_d = tuple(lrec[COL["Ke"] + i] for i in range(3))
        light_ks = tuple(lrec[COL["Ks"] + i] for i in range(3))
        nd = unit3(tuple(loc[i] - center[i] for i in range(3)))
        uvec = unit3(_cross(nd, tuple(nd[i] + _DISK_TILT[i]
                                      for i in range(3))))
        vvec = unit3(_cross(nd, uvec))
        to_center = unit3(tuple(center[i] - loc[i] for i in range(3)))
        if sample_res <= 0:
            intensity = torch.ones_like(zero)
        else:
            if sample_res == 1:
                jitter, state = vrng.uniform_cube_vec(state)
                dirs = [unit3(_add(to_center, jitter.unbind(-1)))]
            else:
                dirs = []
                for l_u, l_v in grid_points(sample_res):
                    point = tuple(
                        center[i] + radius * (l_u * uvec[i] + l_v * vvec[i])
                        for i in range(3))
                    shoot = unit3(_sub(point, loc))
                    jitter, state = vrng.uniform_cube_vec(state)
                    dirs.append(unit3(_add(shoot, _scale(jitter.unbind(-1),
                                                         0.5))))
            # the grid's shadow rays in one query, point-major
            k = len(dirs)
            sh_hit, _ = traverse.ray_scene(
                tuple(c.repeat(k) for c in shadow_o),
                tuple(torch.cat([dd[i] for dd in dirs]) for i in range(3)),
                scene, info, active=shadowed.repeat(k))
            reached = _collection_hit(sh_hit, kind, id_start, id_end)
            reached = reached.reshape(k, -1).to(torch.float32)
            if sample_res == 1:
                intensity = reached[0]
            else:
                hits = zero
                for g in range(k):
                    hits = hits + reached[g]
                intensity = lrec[COL["Density"]] * hits / float(k)
        lam = torch.clamp(dot3(n, to_center), 0.0, 1.0)
        v_dir = unit3(tuple(-c for c in d))
        dl = dot3(to_center, n)
        r_dir = unit3(tuple(2.0 * dl * n[i] - to_center[i] for i in range(3)))
        power = torch.clamp(dot3(r_dir, v_dir), 0.0, 1.0) ** m["Ns"]
        add_amb = ~did_ambient & (m["illum"] >= 1)
        specular = m["illum"] == 2
        col = tuple(
            col[i] + (m["Kd"][i] * i_d[i] * intensity * lam
                      + torch.where(add_amb, m["Ka"][i], 0.0)
                      + torch.where(specular, torch.clamp(
                          m["Ks"][i] * light_ks[i] * power * i_d[i]
                          * intensity, min=0.0), 0.0))
            for i in range(3))
        did_ambient = did_ambient | (m["illum"] >= 1)
    col = _where(emissive, _scale(m["Ke"], m["Density"]), col)
    return _where(hit.is_hit, col, sky(scene, info, d)), state


def _glsl_rand(v):
    """rand(vec3) = fract(sin(47.57891 x + y + 425 z) * 47678.786234)
    (raytrace.glsl:121-123) in float32, the sine rounded once from
    float64."""
    s = _RAND_X * v[0] + v[1] + _RAND_Z * v[2]
    x = torch.sin(s.to(torch.float64)).to(torch.float32) * _RAND_SCALE
    return x - torch.floor(x)


def _latch(result, active, cond, value):
    """A masked GLSL `return value`."""
    fire = active & cond
    return _where(fire, value, result), active & ~fire


def path_trace(o, d, state, scene, info, sample_res: int,
               max_bounces: int, *, stack_size: int = 10, glossy=None):
    """The legacy deterministic pathTrace (raytrace.glsl:781-899, module
    docstring) of rays o + t d, one evaluation: ((r, g, b), new state,
    scene queries (1,) int64 counted as the JAX module counts them: the
    first query, then per bounce the sampled rays and the followed ones
    that are still live). Once no ray is live the remaining bounces only
    advance the state by their draws.

    `glossy`, if given, is an (R,) bool tensor set where a ray followed a
    glossy refraction: where its colour hangs on the location hash, which
    turns an ulp of the hit into another direction."""
    f0 = torch.zeros_like(d[0])
    one = torch.ones_like(f0)
    n_rays = f0.shape[0]
    hit, surf, m = _query(o, d, scene, info)
    stack = torch.zeros((n_rays, stack_size), dtype=torch.float32,
                        device=f0.device)
    stack[:, 0] = AIR_IOR
    empty = torch.zeros((n_rays, 1), dtype=torch.float32, device=f0.device)
    # the second entry; a one-entry stack reads its first, as the
    # reference's index past it clamps
    j = min(1, stack_size - 1)

    def pushed_of(stack, ni):
        return torch.cat([ni[:, None], stack[:, :stack_size - 1]], dim=1)

    inside = hit.is_hit & (dot3(surf.norm, d) > 0.0)
    mat_filter = _where(inside, m["Tf"], (one, one, one))
    stack = torch.where(inside[:, None], pushed_of(stack, m["Ni"]), stack)
    in_obj = was_in = inside
    enter_loc = _where(inside, surf.loc, (f0, f0, f0))
    col = result = (f0, f0, f0)
    thr = (one, one, one)
    active = torch.ones_like(inside)
    rays = torch.full((1,), n_rays, dtype=torch.int64, device=f0.device)
    for bounce in range(max_bounces):
        if not bool(active.any()):
            state = vrng.advance(state, 2 * draws_per_shade(info, sample_res)
                                 * (max_bounces - bounce))
            break
        flat, state = shade_hit(hit, surf, m, d, state, scene, info,
                                sample_res, live=active)
        # a miss ends the path: mix(col, flatShadeHit, throughput)
        result, active = _latch(result, active, ~hit.is_hit,
                                _mix(col, flat, thr))
        d = unit3(d)
        loc = surf.loc
        nd = dot3(surf.norm, d)
        nvec = _scale(surf.norm, torch.where(nd > 0.0, -1.0, 1.0))
        entering = nd < 0.0
        upd = active

        # eta and Fresnel with the first stack mutation (:817-830)
        pushed = pushed_of(stack, m["Ni"])
        popped = torch.cat([stack[:, 1:], empty], dim=1)
        eta = torch.where(entering, pushed[:, j] / pushed[:, 0],
                          stack[:, 0] / stack[:, j])
        n1 = torch.where(entering, pushed[:, j], stack[:, 0])
        n2 = torch.where(entering, pushed[:, 0], stack[:, j])
        pm = m["Pm"]
        fres = torch.where((pm > 0.0) | (m["Tr"] > 0.0),
                           pm + (1.0 - pm) * fresnel_soa(n1, n2, nvec, d),
                           0.0)
        stack = torch.where((upd & entering)[:, None], pushed,
                            torch.where((upd & ~entering)[:, None], popped,
                                        stack))
        mat_filter = _where(upd & entering, m["Tf"], mat_filter)
        enter_loc = _where(upd & entering, loc, enter_loc)
        new_in_obj = torch.where(upd, entering, in_obj)

        # absorption on leaving an object (:833-838)
        gap = _sub(enter_loc, loc)
        dist = sqrt(dot3(gap, gap))
        absorb = tuple(torch.exp(-dist / torch.clamp(mat_filter[i],
                                                     min=1e-30))
                       for i in range(3))
        thr = _where(upd & was_in & ~new_in_obj,
                     tuple(thr[i] * absorb[i] for i in range(3)), thr)
        in_obj = new_in_obj

        # branch weights; both zero ends the path (:840-844)
        refl_co = fres
        trans_co = m["Tr"] * (1.0 - fres)
        result, active = _latch(result, active, (refl_co + trans_co) == 0.0,
                                _mix(col, flat, thr))
        upd = active
        stronger_refl = refl_co > trans_co

        # the weaker branch, sampled once (:845-878): a refraction with
        # the second stack mutation's eta, or a reflection at 1e-6
        pushed2 = pushed_of(stack, m["Ni"])
        eta2 = torch.where(entering, pushed2[:, j] / pushed2[:, 0],
                           stack[:, 0] / stack[:, j])
        mut2 = upd & stronger_refl & (trans_co > 0.0)
        stack = torch.where((mut2 & entering)[:, None], pushed2,
                            torch.where((mut2 & ~entering)[:, None],
                                        torch.cat([stack[:, 1:], empty], 1),
                                        stack))
        refl_dir = _reflect(d, nvec)
        weak_dir = _where(stronger_refl, _refract(d, nvec, eta2), refl_dir)
        weak_o = _where(stronger_refl, _sub(loc, _scale(nvec, 1e-4)),
                        _add(loc, _scale(nvec, 1e-6)))
        # a refraction lost to total internal reflection traces the zero
        # vector in the reference: it shades as a miss, the zero
        # direction's sky (raytrace.glsl:879, 678)
        weak_bad = dot3(weak_dir, weak_dir) < 1e-12
        weak_dir = _where(active & ~weak_bad, weak_dir, d)
        weak_co = torch.where(stronger_refl, trans_co, refl_co)
        sampled = upd & ~weak_bad & (weak_co > 0.0)
        w_hit, w_surf, w_m = _query(weak_o, weak_dir, scene, info,
                                    active=sampled)
        w_flat, state = shade_hit(w_hit, w_surf, w_m, weak_dir, state, scene,
                                  info, sample_res, live=sampled)
        w_flat = _where(weak_bad, sky(scene, info, (f0, f0, f0)), w_flat)
        inner = _where(weak_co > 0.0, _mix(flat, w_flat, weak_co), flat)
        col = _where(upd, _mix(col, inner, thr), col)
        rays = rays + upd.sum()

        # follow the stronger branch (:881-895), glossy refraction
        # perturbed by the location's hash
        prim = torch.where(hit.kind == 1, hit.tri, hit.prim).to(torch.float32)
        keys = (loc, _add(loc, d),
                tuple(loc[i] + 2.0 * d[i] + prim for i in range(3)))
        perturbed = m["Pr"] > 0.0
        perturb = tuple(torch.where(perturbed, m["Pr"] * (_glsl_rand(k)
                                                          * 2.0 - 1.0), 0.0)
                        for k in keys)
        if glossy is not None:
            glossy |= active & ~stronger_refl & perturbed
        follow = _add(_refract(d, nvec, eta), perturb)
        follow = _where(dot3(follow, follow) < 1e-12, d, unit3(follow))
        next_d = _where(stronger_refl, refl_dir, follow)
        next_o = _where(stronger_refl, _add(loc, _scale(nvec, 1e-4)),
                        _sub(loc, _scale(nvec, 1e-4)))
        next_d = _where(active, next_d, d)
        next_o = _where(active, next_o, loc)
        weight = torch.where(stronger_refl, refl_co, trans_co)
        thr = _where(upd, _scale(thr, weight), thr)
        was_in = torch.where(upd, in_obj, was_in)
        d = next_d
        hit, surf, m = _query(next_o, next_d, scene, info, active=active)
        rays = rays + active.sum()
    # the loop ran out without a return: pathTrace returns col (:898)
    return _where(active, col, result), state, rays
