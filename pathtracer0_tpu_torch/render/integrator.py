"""Integrators: the path `trace` (frag.glsl:810-882) and Whitted
`direct_diffuse` (frag.glsl:655-681) over (R,) rays, one tensor per
vector component.

Two triangle queries feed one bounce loop and one bounce step
(kernels/bounce.py):

  per-bounce route  kernels/traverse.walk_triangles: the SAH forest (the
                    CUDA forest kernels on the card) or, for a streamed
                    scene, the two-level LBVH (the streamed kernel), then
                    one `bounce.bounce_step` (csrc/bounce_kernel.cu: the
                    analytic merge, the surface, the shade), all
                    max_bounces of them, nothing read back: the kernels
                    skip rays no longer alive, where the JAX package's
                    `while_loop` tests for one. CPU tensors take the plain
                    versions of both. `trace_bounces`, `direct_diffuse`;
                    `trace_bounces_reference`: the plain route anywhere.
  brute force       `closest_hit`: every triangle with the division-free
                    Möller-Trumbore test, first closest in table order
                    wins, then the plain bounce step. `trace_plain` and
                    `direct_diffuse_plain` follow csrc/integrate.cuh
                    operation for operation and are the plain versions of
                    the frame and block kernels, and the oracle of small
                    scenes.

  per bounce    analytic merge + surface -> material decode + maps ->
                normal flip by sign(N.D) -> refraction-index stack push
                (entering) / pop -> chooseRay -> medium bookkeeping ->
                emission -> throughput cutoff |col| < 0.1 -> Beer-Lambert
                | subsurface passthrough | col *= Ks or Kd
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

import torch

from ..kernels import bounce, traverse, wavefront
from ..kernels.intersect import MISS, tri_candidate
from ..kernels.traverse import Hit, Walk
from ..utils.trace import span

NUDGE = traverse.NUDGE


def _brute_triangles(scene, info, o, d, alive) -> Walk:
    """The closest of every triangle from the (already nudged) origins o
    along d, (x, y, z) tuples of (R,) tensors; rays not `alive` come back
    t = 0."""
    tn = torch.where(alive, MISS, 0.0)
    hid = torch.full(tn.shape, -1, dtype=torch.int32, device=tn.device)
    zero = torch.zeros_like(tn)
    if not info.num_tris:
        return Walk(tn, zero, zero, hid, None)
    td = torch.ones_like(tn)
    un = vn = zero
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
    return Walk(tn * invd, un * invd, vn * invd, hid, None)


def closest_hit(scene, info, o, d, alive) -> Hit:
    """Brute-force closest hit of rays from the (already nudged) origins o
    along d: (x, y, z) tuples of (R,) tensors; rays not `alive` come back
    t = 0."""
    walk = _brute_triangles(scene, info, o, d, alive)
    return traverse._merge_analytic_batched(o, d, scene, info,
                                            traverse.walk_hit(walk, scene))


def _brute_walk(scene, info):
    def walk(o, d, alive):
        on = traverse.nudged(o, d)
        return _brute_triangles(scene, info, on, d, alive), on
    return walk


def _forest_walk(scene, info):
    def walk(o, d, alive):
        return traverse.walk_triangles(o, d, scene, info, active=alive)
    return walk


def _reference_walk(scene, info):
    """`walk_triangles` through the plain versions of the forest and
    streamed kernels, on any device."""
    def walk(o, d, alive):
        if not traverse.has_tree(info):
            return traverse.walk_triangles(o, d, scene, info, active=alive)
        on = traverse.nudged(o, d)
        args = (on, d, traverse._t_init(on[0], alive), scene, info)
        if info.streamed:
            out = traverse.sorted_query(wavefront.streamed_reference, *args)
            return traverse.Walk(*out[:4], scene.st_perm), on
        out = wavefront.trace_forest_reference(*args)
        return traverse.Walk(*out[:4], scene.wf_perm), on
    return walk


def _step(device):
    """The bounce step of the per-bounce route: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if device.type == "cuda":
        return bounce.bounce_step
    return bounce.bounce_step_plain


def _run_bounces(walk, step, scene, info, st, *, max_bounces: int):
    """The bounce loop on a begun path state `st`: `max_bounces` times
    `walk(o, d, alive) -> (Walk, nudged origins)`, then `step`
    (kernels/bounce.py) on the rays' state in place. Nothing is read
    back: the walk and the step skip the rays no longer alive, so the
    bounces past the last live ray change nothing."""
    for _ in range(max_bounces):
        w, _ = walk(tuple(st.o), tuple(st.d), st.alive)
        with span("pt0.bounce"):
            step(scene, info, st, w)


def _bounce_loop(walk, step, scene, info, o, d, alive, state, *,
                 max_bounces: int, stack_size: int):
    """The bounce loop from rays o, d that are `alive`: `_run_bounces` on
    their state begun by `bounce.begin`. Returns (radiance without sky
    (r, g, b), sky radiance (r, g, b), state, queries (R,) int64)."""
    st = bounce.begin(o, d, alive, state, stack_size=stack_size)
    _run_bounces(walk, step, scene, info, st, max_bounces=max_bounces)
    return tuple(st.inc), tuple(st.skyc), st.state, st.queries


def trace_plain(scene, info, o, d, alive, state, *, max_bounces: int,
                stack_size: int = 10):
    """Path integrator over the brute-force `closest_hit`: the plain
    version of the frame and block kernels. o, d (x, y, z) tuples of (R,);
    d normalized. Returns as `_bounce_loop`."""
    return _bounce_loop(_brute_walk(scene, info), bounce.bounce_step_plain,
                        scene, info, o, d, alive, state,
                        max_bounces=max_bounces, stack_size=stack_size)


def trace_bounces(scene, info, o, d, alive, state, *, max_bounces: int,
                  stack_size: int = 10):
    """Path integrator of the per-bounce route: every bounce one walk of
    the forest or LBVH and one bounce step (the kernels on CUDA tensors).
    Returns as `_bounce_loop`."""
    return _bounce_loop(_forest_walk(scene, info), _step(alive.device),
                        scene, info, o, d, alive, state,
                        max_bounces=max_bounces, stack_size=stack_size)


def trace_bounces_reference(scene, info, o, d, alive, state, *,
                            max_bounces: int, stack_size: int = 10):
    """`trace_bounces` through the plain versions of the walks and of the
    bounce step on any device: the yardstick of the route's kernels on
    the card. Returns as `_bounce_loop`."""
    return _bounce_loop(_reference_walk(scene, info),
                        bounce.bounce_step_plain, scene, info, o, d, alive,
                        state, max_bounces=max_bounces,
                        stack_size=stack_size)


def trace_state(scene, info, st, *, max_bounces: int, stack_size: int):
    """One sample of a state `sample_state` made and the camera form
    (kernels/bounce.py `camera_step`) has begun, every ray alive, on `st`
    in place: a state with no stack, the block kernel's, through
    `fused.trace_fused`, its radiance with sky into st.inc and its queries
    added into st.queries; a path state, the per-bounce route's bounces."""
    if st.stack is None:
        from ..kernels import fused as fused_mod

        col, st.state, q = fused_mod.trace_fused(
            scene, info, tuple(st.o), tuple(st.d), st.alive, st.state,
            max_bounces=max_bounces, stack_size=stack_size)
        st.inc.copy_(torch.stack(col))
        st.queries = q if st.queries is None else st.queries + q
        return
    _run_bounces(_forest_walk(scene, info), _step(st.alive.device), scene,
                 info, st, max_bounces=max_bounces)


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


def takes_block(info, fused: str, stack_size: int) -> bool:
    """Whether `trace` sends a sample's rays to the block kernel: fused
    "auto" / "on" and a scene and stack depth it takes
    (kernels/fused.eligible); fused="on" on one it does not take warns
    and takes the per-bounce route."""
    from ..kernels import fused as fused_mod

    check_fused(info, fused)
    if fused == "off":
        return False
    if fused_mod.eligible(info, stack_size=stack_size):
        return True
    if fused == "on":
        warnings.warn(
            "fused='on' requested but the scene is outside the block "
            f"kernel ({info.num_tris} triangles, {info.num_materials} "
            f"materials, a stack of {stack_size}); using the per-bounce "
            "route", stacklevel=3)
    return False


def sample_state(info, state, *, raytracing: bool, stack_size: int,
                 fused: str, totals: bool = True):
    """The state of one sample's rays with RNG `state` that the camera form
    begins, of the route that takes them: with `raytracing`, the path state
    of the per-bounce route or, where `takes_block`, the block kernel's
    (the rays and the radiance out); else the Whitted forms' (with room for
    the hit locations where the scene `probes`). `totals`: with the
    running sum of the samples."""
    block = raytracing and takes_block(info, fused, stack_size)
    return bounce.state_for(
        state, path=raytracing and not block, stack_size=stack_size,
        probe=not raytracing and probes(info), totals=totals)


def trace(scene, info, o, d, alive, state, *, max_bounces: int,
          stack_size: int = 10, fused: str = "auto"):
    """Path integrator of one sample's rays. fused "auto" / "on": the
    block kernel where the scene is eligible (kernels/fused.trace_fused);
    "off", or a scene or stack depth it does not take: the per-bounce
    route.

    Returns (radiance with sky (r, g, b), state, queries (1,) int64)."""
    from ..kernels import fused as fused_mod

    if takes_block(info, fused, stack_size):
        return fused_mod.trace_fused(
            scene, info, o, d, alive, state, max_bounces=max_bounces,
            stack_size=stack_size)
    inc, skyc, state, queries = trace_bounces(
        scene, info, o, d, alive, state, max_bounces=max_bounces,
        stack_size=stack_size)
    return (tuple(inc[i] + skyc[i] for i in range(3)), state,
            queries.sum().reshape(1))


def probes(info) -> bool:
    """Whether the Whitted route probes the thickness behind a hit: a
    scene with subsurface materials and a tree."""
    return bool(info.mat_gates[0]) and traverse.has_tree(info)


def _direct_state(walk, step, scene, info, st, probe):
    """The Whitted shade of one walk of st's rays through `step` into
    st.inc; with `probe` where the scene has subsurface materials and a
    tree (st then holds `loc`), the hit locations first (the locate form),
    then the thickness probe from them."""
    o, d = tuple(st.o), tuple(st.d)
    w, _ = walk(o, d, st.alive)
    probe_t = None
    if probe is not None and probes(info):
        step(scene, info, st, w, form="locate")
        probe_t = probe(tuple(st.loc), d)
    step(scene, info, st, w, form="whitted", probe_t=probe_t)


def _direct(walk, step, scene, info, o, d, alive, probe):
    st = bounce.begin_whitted(o, d, alive,
                              probe=probe is not None and probes(info))
    _direct_state(walk, step, scene, info, st, probe)
    return tuple(st.inc)


def _probe(scene, info):
    def probe(loc, direction):
        return traverse.probe_forest_t(loc, direction, scene, info)
    return probe


def direct_state(scene, info, st):
    """`direct_diffuse` of the rays of a Whitted state the camera form has
    begun (with `loc` where the scene `probes`), into st.inc."""
    _direct_state(_forest_walk(scene, info), _step(st.alive.device), scene,
                  info, st, _probe(scene, info))


def direct_diffuse(scene, info, o, d, alive):
    """Whitted shade of the per-bounce route: Ka + Kd (0.2 + N.y) + Ke on
    a hit with the unflipped (possibly normal-mapped) normal, the sky on a
    miss. Subsurface materials shade by the thickness behind the hit,
    probed through the whole forest or the streamed LBVH (the reference
    probes the hit object alone: the two differ only where another object
    cuts the segment)."""
    return _direct(_forest_walk(scene, info), _step(alive.device), scene,
                   info, o, d, alive, _probe(scene, info))


def direct_diffuse_plain(scene, info, o, d, alive):
    """Whitted shade over the brute-force `closest_hit`: the plain version
    of the frame kernel's Whitted mode, which has no thickness probe."""
    if info.mat_gates[0]:
        raise ValueError("Whitted shading of subsurface materials needs "
                         "the thickness probe: use direct_diffuse")
    return _direct(_brute_walk(scene, info), bounce.bounce_step_plain, scene,
                   info, o, d, alive, None)
