"""One bounce of the per-bounce route: the shading of the rays a walk has
queried, on their state in place.

Counterpart of the body of the JAX package's bounce loop, which XLA
compiles around its Pallas walk: the `lax.while_loop` of
pathtracer0_tpu/render/integrator.py `trace` (:177-287) and its Whitted
`direct_diffuse` (:295). It has no Pallas counterpart. Three functions with
one interface, `(scene, info, st, walk, *, form, probe_t)`:

  bounce_step        csrc/bounce_kernel.cu, one launch, on CUDA tensors;
                     it reads nothing back, so a CUDA graph captures it
                     (render/graph.py). It raises on CPU tensors.
  bounce_step_plain  the same body as PyTorch ops on (R,) tensors, one
                     tensor per vector component: the plain version, on any
                     device (the CPU route runs it).
  bounce_step_host   the kernel's per-ray body built by g++
                     (csrc/bounce_host.cpp), over CPU tensors: for the
                     tests, which hold its arithmetic against the plain
                     version.

The camera form begins each sample of `render_rays` on the same state:
`camera_step` (one launch of the kernel's FORM_CAMERA), `camera_step_plain`
(core/camera.py `dof_ray` and what `begin` / `begin_whitted` write) and
`camera_step_host` (the g++ build), all `(st, pd, cam, blur, *,
accumulate)`: the camera's ray with depth of field from each ray's primary
direction and RNG state (6 draws), the path state begun, and with a running
`total` the sample before added into it first.

Forms: "path" (frag.glsl:810-882) merges the analytic primitives over the
walk's triangle, shades, and writes the next bounce's rays where the ray
hit; a miss adds the sky and ends the ray; a ray no longer alive is left
as it is. "whitted" (frag.glsl:655-681)
writes Ka + Kd (0.2 + N.y) + Ke or the sky into `inc`, a subsurface
material shaded by the thickness behind the hit where `probe_t` is given.
"locate" writes the hit locations into `loc`, from which the Whitted
thickness probe walks.

The refraction stack is held bottom first, one column per ray, (S, R), as
the kernel reads it; entries at and past `ssize` read as 0. The plain
version shifts it top first, as the JAX package does, and turns it back.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core import camera
from ..core.math import sqrt
from ..scene.material import COL
from ..scene.texture import bilinear, sky_uv
from ..shade import bsdf
from ..shade.mtl import map_sample, tbn_map
from . import build, traverse
from .build import ptr
from .fused import SceneArgs, scene_args

AIR_IOR = float(np.float32(1.0029))   # frag.glsl:816
FORMS = {"path": 0, "whitted": 1, "locate": 2}   # integrate.cuh FORM_*
FORM_CAMERA = 3


@dataclasses.dataclass
class BounceState:
    """The state of R rays between bounces (csrc/integrate.cuh
    `BounceArgs`). Path form: every field; Whitted forms: o, d, alive,
    inc (the radiance out) and, with the thickness probe, loc."""

    o: torch.Tensor                  # (3, R) float32 origins, not nudged
    d: torch.Tensor                  # (3, R)
    alive: torch.Tensor              # (R,) bool
    inc: torch.Tensor = None         # (3, R) radiance without sky
    col: torch.Tensor = None         # (3, R) throughput
    skyc: torch.Tensor = None        # (3, R) sky radiance
    enter: torch.Tensor = None       # (3, R) where the medium was entered
    stack: torch.Tensor = None       # (S, R) refraction indices
    ssize: torch.Tensor = None       # (R,) int32
    inobj: torch.Tensor = None       # (R,) bool
    state: torch.Tensor = None       # (R,) int64 RNG state
    queries: torch.Tensor = None     # (R,) int64 scene queries
    loc: torch.Tensor = None         # (3, R) hit locations
    total: torch.Tensor = None       # (3, R) radiance summed over the
                                     # samples before (the camera form's)
    bounce: int = 0                  # bounces taken

    def clone(self) -> "BounceState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _check_stack(stack_size):
    if stack_size < 1:
        raise ValueError("the refraction stack takes 1 entry or more, not "
                         f"{stack_size}")


def begin(o, d, alive, state, *, stack_size: int):
    """The path state of rays o, d ((x, y, z) tuples of (R,) float32) that
    are `alive`, with RNG `state` (R,) int64: throughput 1, the stack
    holding the air's index, nothing counted. The caller's tensors are
    copied, not changed. The stack takes any depth of 1 or more, as the
    reference's."""
    _check_stack(stack_size)
    o, d = torch.stack(o), torch.stack(d)
    zero = torch.zeros_like(o)
    stack = torch.zeros((stack_size,) + alive.shape, dtype=torch.float32,
                        device=o.device)
    stack[0] = AIR_IOR
    return BounceState(
        o=o, d=d, alive=alive.clone(), inc=zero, col=torch.ones_like(o),
        skyc=zero.clone(), enter=zero.clone(), stack=stack,
        ssize=torch.ones(alive.shape, dtype=torch.int32, device=o.device),
        inobj=torch.zeros_like(alive), state=state.clone(),
        queries=torch.zeros(alive.shape, dtype=torch.int64, device=o.device))


def begin_whitted(o, d, alive, *, probe: bool = False):
    """The state of the Whitted forms: rays o, d that are `alive`; `probe`
    makes room for the hit locations of the thickness probe."""
    o, d = torch.stack(o), torch.stack(d)
    return BounceState(o=o, d=d, alive=alive, inc=torch.empty_like(o),
                       loc=torch.empty_like(o) if probe else None)


def state_for(state, *, path: bool, stack_size: int = 10,
              probe: bool = False, totals: bool = False,
              rays_only: bool = False):
    """The state of R rays with RNG `state` (R,) int64 (taken, not copied)
    for the camera form to begin, sample after sample: the path state
    (`path`), or the Whitted forms' (`probe`: with room for the hit
    locations); `totals`: with a running sum of the samples' radiance;
    `rays_only`: the rays and the alive flag alone (for the legacy modes).
    The sums (radiance, sky radiance, total, queries) and the stack start
    at 0, so a state no sample has begun sums to nothing; the rest is
    written by the camera form."""
    n, dev = state.shape[0], state.device
    if path:
        _check_stack(stack_size)

    def f3(fill=torch.empty):
        return fill((3, n), dtype=torch.float32, device=dev)

    st = BounceState(o=f3(), d=f3(),
                     alive=torch.empty(n, dtype=torch.bool, device=dev),
                     state=state)
    if rays_only:
        return st
    st.inc = f3(torch.zeros)
    st.total = f3(torch.zeros) if totals else None
    if path:
        st.col, st.skyc, st.enter = f3(), f3(torch.zeros), f3()
        st.stack = torch.zeros((stack_size, n), dtype=torch.float32,
                               device=dev)
        st.ssize = torch.empty(n, dtype=torch.int32, device=dev)
        st.inobj = torch.empty(n, dtype=torch.bool, device=dev)
        st.queries = torch.zeros(n, dtype=torch.int64, device=dev)
    elif probe:
        st.loc = f3()
    return st


def camera_scalars(cam_pos, rotmat, ifd):
    """The camera form's (13,) float32 scalars: the camera position, the
    rotation matrix row-major, the focal distance."""
    return torch.cat([cam_pos.to(torch.float32).reshape(3),
                      rotmat.to(torch.float32).reshape(9),
                      ifd.to(torch.float32).reshape(1)]).contiguous()


def _check_camera(st, pd, cam):
    n = st.alive.shape[0]
    if pd.shape != (3, n) or cam.shape != (13,):
        raise ValueError("the camera form takes (3, R) primary directions "
                         "and the (13,) camera_scalars")


def camera_step_plain(st: BounceState, pd, cam, blur: float, *,
                      accumulate: bool = False):
    """The camera form as PyTorch ops, on `st` in place: core/camera.py
    `dof_ray` from the primary directions pd (3, R) and the RNG state, then
    what `begin` (path state) or `begin_whitted` writes; with `total`, the
    sample before added into it first (accumulate) or total set to 0."""
    _check_camera(st, pd, cam)
    o, d, state = camera.dof_ray(cam[:3], pd.T, cam[3:12].reshape(3, 3),
                                 blur, cam[12], st.state)
    if st.total is not None:
        if accumulate:
            col = st.inc if st.skyc is None else st.inc + st.skyc
            st.total.copy_(st.total + col)
        else:
            st.total.zero_()
    st.o.copy_(o.T)
    st.d.copy_(d.T)
    st.state.copy_(state)
    st.alive.fill_(True)
    if st.stack is not None:
        st.col.fill_(1.0)
        for t in (st.inc, st.skyc, st.enter, st.inobj):
            t.zero_()
        st.stack[0] = AIR_IOR
        st.ssize.fill_(1)
        if not accumulate:
            st.queries.zero_()
    st.bounce = 0


def _check(st, walk, form, probe_t):
    if form not in FORMS:
        raise ValueError(f"form must be one of {tuple(FORMS)}, not {form!r}")
    if form == "path" and st.stack is None:
        raise ValueError("the path form needs the state of `begin`")
    if form == "locate" and st.loc is None:
        raise ValueError("the locate form needs begin_whitted(probe=True)")
    if probe_t is not None and form != "whitted":
        raise ValueError("probe_t is the Whitted form's")
    n = st.alive.shape[0]
    if any(x.shape != (n,) for x in (walk.t, walk.u, walk.v, walk.row)):
        raise ValueError("the walk must hold one entry per ray")


# ---- the plain version ---------------------------------------------------

def shade_setup(scene, info, surf, names, channels):
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


def _flip(stack, ssize):
    """(S, R) stack entries in the other order below each ray's `ssize`,
    0 at and past it: bottom first to top first and back."""
    k = torch.arange(stack.shape[0], device=stack.device)[:, None]
    j = ssize[None, :].to(torch.int64) - 1 - k
    return torch.where(j >= 0, torch.gather(stack, 0, torch.clamp(j, min=0)),
                       0.0)


def bounce_step_plain(scene, info, st: BounceState, walk, *,
                      form: str = "path", probe_t=None):
    """One bounce as PyTorch ops, on `st` in place."""
    _check(st, walk, form, probe_t)
    o, d, alive = tuple(st.o), tuple(st.d), st.alive
    on = traverse.nudged(o, d)
    hit = traverse._merge_analytic_batched(on, d, scene, info,
                                           traverse.walk_hit(walk, scene))
    surf = traverse.surface_sample(hit, on, d, scene, info)
    if form == "locate":
        st.loc.copy_(torch.stack(surf.loc))
        return
    if form == "whitted":
        m, n = shade_setup(scene, info, surf, _WHITTED_FIELDS, _WHITTED_MAPS)
        col = [m["Ka"][i] + m["Kd"][i] * (0.2 + n[1]) + m["Ke"][i]
               for i in range(3)]
        if probe_t is not None:
            # thickness: the same direction again from the hit point
            # (frag.glsl:662-676), the distance actually travelled
            has_ss = m["subsurface"] > 0.0
            for i in range(3):
                sigma_t = 1.0 / torch.clamp(m["subsurfaceRadius"][i],
                                            min=1e-4)
                col[i] = torch.where(
                    has_ss,
                    torch.exp(-sigma_t * probe_t) * m["subsurfaceColor"][i],
                    col[i])
        sr = sky(scene, info, d)
        st.inc.copy_(torch.stack([
            torch.where(alive & hit.is_hit, col[i], 0.0)
            + torch.where(alive & ~hit.is_hit, sr[i], 0.0)
            for i in range(3)]))
        return

    stack_size = st.stack.shape[0]
    col, inc, skyc = tuple(st.col), tuple(st.inc), tuple(st.skyc)
    enter, ssize, inobj, state = tuple(st.enter), st.ssize, st.inobj, st.state
    stack = _flip(st.stack, ssize).T                 # (R, S), top first
    # the second entry; a one-entry stack reads its first, as the
    # reference's index past it clamps (integrate.cuh `path_shade`)
    second = min(1, stack_size - 1)
    f0 = torch.zeros_like(o[0])
    st.queries += alive.to(torch.int64)
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
    n1 = torch.where(entering, pushed[:, second], stack[:, 0])
    n2 = torch.where(entering, pushed[:, 0], stack[:, second])
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

    st.o.copy_(torch.stack([upd(hx[i], o[i]) for i in range(3)]))
    st.d.copy_(torch.stack([upd(lobe.direction[i], d[i]) for i in range(3)]))
    st.col.copy_(torch.stack([upd(new_col[i], col[i]) for i in range(3)]))
    st.inc.copy_(torch.stack(inc))
    st.skyc.copy_(torch.stack(skyc))
    st.enter.copy_(torch.stack([upd(new_enter[i], enter[i])
                                for i in range(3)]))
    stack = torch.where(hitf[:, None], popped, stack)
    st.ssize.copy_(torch.where(hitf, new_size, ssize))
    st.stack.copy_(_flip(stack.T, st.ssize))
    st.inobj.copy_(torch.where(hitf, new_inobj, inobj))
    st.state.copy_(torch.where(hitf, lobe.state, state))
    st.alive.copy_(hitf & ~cutoff)
    st.bounce += 1


# ---- the kernel and its host build ---------------------------------------

_STATE = ("o", "d", "col", "inc", "skyc", "enter", "stack", "ssize", "inobj",
          "state", "alive", "queries")
_TYPES = {"ssize": torch.int32, "inobj": torch.bool, "state": torch.int64,
          "alive": torch.bool, "queries": torch.int64}


class _BounceArgs(ctypes.Structure):
    """csrc/integrate.cuh `BounceArgs`, field for field."""

    _fields_ = [("scene", SceneArgs)] + [(n, ctypes.c_void_p) for n in (
        "walk_t", "walk_u", "walk_v", "walk_row", "perm", *_STATE, "probe_t",
        "loc", "pd", "cam", "total")] + [(n, ctypes.c_int) for n in (
            "n_rays", "stack_size", "form", "accumulate")] + [
        ("blur", ctypes.c_float)]


def _state_ptrs(st, dev):
    return {n: None if getattr(st, n) is None
            else ptr(getattr(st, n), _TYPES.get(n, torch.float32), dev)
            for n in _STATE}


def _args(scene, info, st: BounceState, walk, form, probe_t):
    """(BounceArgs of one bounce, the tensors its pointers point into:
    keep them alive past the launch)."""
    dev = st.alive.device
    f32, i32 = torch.float32, torch.int32
    keep = [walk.t.contiguous(), walk.u.contiguous(), walk.v.contiguous(),
            walk.row.to(i32).contiguous()]
    if walk.perm is not None:
        keep.append(walk.perm)
    if probe_t is not None:
        keep.append(probe_t.contiguous())
    args = _BounceArgs(
        scene_args(scene, info, dev),
        walk_t=ptr(keep[0], f32, dev), walk_u=ptr(keep[1], f32, dev),
        walk_v=ptr(keep[2], f32, dev), walk_row=ptr(keep[3], i32, dev),
        perm=None if walk.perm is None else ptr(walk.perm, i32, dev),
        **_state_ptrs(st, dev),
        probe_t=None if probe_t is None else ptr(keep[-1], f32, dev),
        loc=None if st.loc is None else ptr(st.loc, f32, dev),
        n_rays=st.alive.shape[0],
        stack_size=0 if st.stack is None else st.stack.shape[0],
        form=FORMS[form])
    return args, keep


def camera_args(st, pd, cam, blur, accumulate):
    """BounceArgs of the camera form (the pointers into pd and cam: keep
    them alive past the launch)."""
    dev = st.alive.device
    return _BounceArgs(
        **_state_ptrs(st, dev),
        pd=ptr(pd, torch.float32, dev), cam=ptr(cam, torch.float32, dev),
        total=None if st.total is None else ptr(st.total, torch.float32, dev),
        n_rays=st.alive.shape[0],
        stack_size=0 if st.stack is None else st.stack.shape[0],
        form=FORM_CAMERA, accumulate=int(bool(accumulate)), blur=float(blur))


def launch(args, dev):
    """Launch bounce_kernel on `args` on the current stream; raises on a
    CUDA error of the launch."""
    lib = build.load("bounce_kernel")
    lib.pt_launch_bounce.argtypes = [ctypes.POINTER(_BounceArgs),
                                     ctypes.c_void_p]
    lib.pt_launch_bounce.restype = ctypes.c_int
    err = lib.pt_launch_bounce(
        ctypes.byref(args),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"bounce_kernel launch failed: CUDA error {err}")


def bounce_step(scene, info, st: BounceState, walk, *, form: str = "path",
                probe_t=None):
    """One bounce through csrc/bounce_kernel.cu, on `st` in place (CUDA
    tensors only), as `bounce_step_plain`."""
    dev = st.alive.device
    if dev.type != "cuda":
        raise ValueError(f"bounce_kernel runs on CUDA tensors, not {dev}: "
                         "bounce_step_plain is the plain version")
    _check(st, walk, form, probe_t)
    args, _keep = _args(scene, info, st, walk, form, probe_t)  # to the end
    launch(args, dev)
    bounce_step.launches += 1
    if form == "path":
        st.bounce += 1


bounce_step.launches = 0


def camera_step(st: BounceState, pd, cam, blur: float, *,
                accumulate: bool = False):
    """The camera form through csrc/bounce_kernel.cu, one launch, on `st`
    in place (CUDA tensors only): as `camera_step_plain`."""
    dev = st.alive.device
    if dev.type != "cuda":
        raise ValueError(f"bounce_kernel runs on CUDA tensors, not {dev}: "
                         "camera_step_plain is the plain version")
    _check_camera(st, pd, cam)
    launch(camera_args(st, pd, cam, blur, accumulate), dev)
    camera_step.launches += 1
    st.bounce = 0


camera_step.launches = 0


def camera_step_host(st: BounceState, pd, cam, blur: float, *,
                     accumulate: bool = False):
    """The camera form through the kernel's body built by g++
    (csrc/bounce_host.cpp), on `st` in place (CPU tensors only)."""
    if st.alive.device.type != "cpu":
        raise ValueError("camera_step_host runs on CPU tensors")
    _check_camera(st, pd, cam)
    _host(camera_args(st, pd, cam, blur, accumulate))
    st.bounce = 0


def _host(args):
    lib = build.load("bounce")
    lib.pt_bounce_host.argtypes = [ctypes.POINTER(_BounceArgs)]
    lib.pt_bounce_host.restype = None
    lib.pt_bounce_host(ctypes.byref(args))


def bounce_step_host(scene, info, st: BounceState, walk, *,
                     form: str = "path", probe_t=None):
    """One bounce through the kernel's per-ray body built by g++
    (csrc/bounce_host.cpp), on `st` in place (CPU tensors only), as
    `bounce_step_plain`."""
    if st.alive.device.type != "cpu":
        raise ValueError("bounce_step_host runs on CPU tensors")
    _check(st, walk, form, probe_t)
    args, _keep = _args(scene, info, st, walk, form, probe_t)  # to the end
    _host(args)
    if form == "path":
        st.bounce += 1
