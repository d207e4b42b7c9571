"""The whole-frame path: raygen, depth of field, every sample and the
bounce loop of every pixel in one launch.

Counterpart of the JAX package's kernels/fused.py frame path
(`trace_frame`, whose Pallas kernel is `_frame_kernel`, and
`render_fused_frame`). On the card `trace_frame` launches
csrc/frame_kernel.cu; on the CPU it runs `trace_frame_reference`, the
plain PyTorch version built on render/integrator.py's brute-force
`trace_plain` and `direct_diffuse_plain`. Both return the
radiance summed over the samples WITH the sky (the TPU kernel deferred the
sky to a second pass because Mosaic cannot gather), the RNG state carried
across the samples, and the count of scene queries.

`trace_frame(refill=True)` takes the refill schedule of the kernel (path
mode, spp >= 2): one flat loop per thread over (sample, bounce) that draws
a lane's next primary ray as soon as its path ends, the counterpart of the
TPU kernel's run-ahead refill (PT0_FUSED_REFILL, read by
`render_fused_frame` as the JAX package reads it). The result is the same
bits either way, so its plain version is `trace_frame_reference` too.
`lane_use` runs a check-only instantiation that counts how many of a
warp's 32 lanes each bounce step keeps busy, `phase_cycles` one that counts
the cycles each part of a scene query takes.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..core import camera
from ..core import math as vm
from ..core import rng as vrng
from ..render import integrator
from ..utils.trace import span
from . import build, fused
from .build import ptr
from .fused import CHECKS, MAX_STACK, PHASES, SceneArgs, scene_args


class _FrameArgs(ctypes.Structure):
    """csrc/frame_kernel.cu `FrameArgs`, field for field."""

    _fields_ = [("scene", SceneArgs)] + [(n, ctypes.c_void_p) for n in (
        "scal", "state_in", "state_out", "rad_out", "rays_out",
        "check_out")] + [
        (n, ctypes.c_int) for n in (
            "width", "height", "spp", "max_bounces", "stack_size")] + [
        (n, ctypes.c_float) for n in (
            "xs_scale", "ys_scale", "focal_length", "blur")] + [
        ("whitted", ctypes.c_int), ("refill", ctypes.c_int),
        ("check", ctypes.c_int)]


def eligible(info, *, whitted: bool = False, stack_size=None) -> bool:
    """Whether the frame path takes this scene: one the brute-force
    kernels take (kernels/fused.eligible, with the stack depth where
    given); Whitted mode also needs no subsurface material (the thickness
    probe needs the forest)."""
    return (fused.eligible(info, stack_size=stack_size)
            and not (whitted and info.mat_gates[0]))


def _raygen(cam_pos, rotmat, ifd, state, width, height, *, cam_size,
            focal_length, blur):
    """Primary ray + DOF for every pixel (frag.glsl:894-908), as
    component tuples: 6 draws consumed per sample whatever `blur` is."""
    uv, _ = camera.pixel_centers(width, height, state.device)
    d = camera.primary_directions(uv, rotmat, cam_size, focal_length,
                                  height / float(width))
    o, d, state = camera.dof_ray(cam_pos, d, rotmat, blur, ifd, state)
    return o.unbind(-1), d.unbind(-1), state


def trace_frame_reference(scene, info, cam_pos, cam_rot, ifd, state, *,
                          width: int, height: int, spp: int,
                          max_bounces: int, stack_size: int = 10,
                          cam_size: float = 1.5, focal_length: float = 1.0,
                          blur: float = 0.0, whitted: bool = False):
    """Plain PyTorch frame. cam_pos, cam_rot (3,) f32, ifd 0-dim f32 and
    state (H*W,) int64 lie on the scene's device. Returns (radiance
    (H*W, 3) summed over spp, state, queries (1,) int64)."""
    rotmat = vm.rotation_matrix(cam_rot.to(torch.float32))
    alive = torch.ones(state.shape, dtype=torch.bool, device=state.device)
    zero = torch.zeros(state.shape, dtype=torch.float32, device=state.device)
    inc = [zero, zero, zero]
    skyc = [zero, zero, zero]
    rays = torch.zeros(1, dtype=torch.int64, device=state.device)
    for _ in range(spp):
        o, d, state = _raygen(cam_pos, rotmat, ifd, state, width, height,
                              cam_size=cam_size, focal_length=focal_length,
                              blur=blur)
        if whitted:
            col = integrator.direct_diffuse_plain(scene, info, o, d, alive)
            inc = [inc[i] + col[i] for i in range(3)]
            rays = rays + state.numel()
        else:
            c, s, state, q = integrator.trace_plain(
                scene, info, o, d, alive, state, max_bounces=max_bounces,
                stack_size=stack_size)
            inc = [inc[i] + c[i] for i in range(3)]
            skyc = [skyc[i] + s[i] for i in range(3)]
            rays = rays + q.sum()
    rad = torch.stack([inc[i] + skyc[i] for i in range(3)], dim=-1)
    return rad, state, rays


def use_refill(refill: bool, whitted: bool, spp: int) -> bool:
    """The schedule `trace_frame` takes: refill only in path mode and with
    two samples or more to overlap (fused.py:1772-1774)."""
    return bool(refill) and not whitted and spp >= 2


def trace_frame(scene, info, cam_pos, cam_rot, ifd, state, *, width: int,
                height: int, spp: int, max_bounces: int,
                stack_size: int = 10, cam_size: float = 1.5,
                focal_length: float = 1.0, blur: float = 0.0,
                whitted: bool = False, refill: bool = False):
    """The frame on the card (csrc/frame_kernel.cu) for CUDA tensors, the
    plain version for CPU tensors. Same arguments and results as
    `trace_frame_reference`; `refill` selects the kernel's refill schedule
    where `use_refill` allows it (`trace_frame.refill_launches` counts
    those launches, `trace_frame.launches` the others). Raises on what the
    kernel does not take."""
    return _launch_frame(scene, info, cam_pos, cam_rot, ifd, state,
                         width=width, height=height, spp=spp,
                         max_bounces=max_bounces, stack_size=stack_size,
                         cam_size=cam_size, focal_length=focal_length,
                         blur=blur, whitted=whitted, refill=refill)


def lane_use(scene, info, cam_pos, cam_rot, ifd, state, *, refill: bool,
             **kw):
    """The path-mode frame on the card through the check-only counting
    instantiation of either schedule: (radiance, state, queries, lanes)
    where lanes = (lanes summed over the bounce steps, warp steps), both
    int64 on the card. lanes[0] equals the queries; lanes[0] / (32
    lanes[1]) is the share of a warp's lanes a bounce step keeps busy. A
    measurement of the card: there is no plain version, and the launch is
    counted in neither launch count."""
    if state.device.type != "cuda":
        raise ValueError("lane_use measures the card: it needs CUDA tensors")
    if kw.get("whitted"):
        raise ValueError("lane_use counts the bounce steps of path mode")
    return _launch_frame(scene, info, cam_pos, cam_rot, ifd, state,
                         refill=refill, check="lanes", **kw)


def phase_cycles(scene, info, cam_pos, cam_rot, ifd, state, *,
                 refill: bool = False, **kw):
    """The frame on the card through the check-only instantiation that
    reads clock64() around the parts of every scene query: (radiance,
    state, queries, cycles) where cycles maps each of PHASES to the cycles
    summed over the warps (each part counted once for the lanes that run
    it together; "warp": each warp's cycles from start to end, so
    part / warp is the share of a warp's time the part takes). A
    measurement of the card, counted in neither launch count."""
    if state.device.type != "cuda":
        raise ValueError("phase_cycles measures the card: it needs CUDA "
                         "tensors")
    *out, cyc = _launch_frame(scene, info, cam_pos, cam_rot, ifd, state,
                              refill=refill, check="phases", **kw)
    return (*out, dict(zip(PHASES, cyc.tolist())))


def _launch_frame(scene, info, cam_pos, cam_rot, ifd, state, *, width,
                  height, spp, max_bounces, stack_size=10, cam_size=1.5,
                  focal_length=1.0, blur=0.0, whitted=False, refill=False,
                  check=None):
    dev = state.device
    kw = dict(width=width, height=height, spp=spp, max_bounces=max_bounces,
              stack_size=stack_size, cam_size=cam_size,
              focal_length=focal_length, blur=blur, whitted=whitted)
    if dev.type == "cpu":
        return trace_frame_reference(scene, info, cam_pos, cam_rot, ifd,
                                     state, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no frame kernel for device {dev}")
    if not eligible(info, whitted=whitted):
        raise ValueError("scene is not eligible for the frame kernel "
                         f"({info.num_tris} triangles, "
                         f"{info.num_materials} materials)")
    if not 2 <= stack_size <= MAX_STACK:
        raise ValueError(f"stack_size {stack_size} not in [2, {MAX_STACK}]")
    if state.shape != (width * height,) or spp < 1 or max_bounces < 0:
        raise ValueError("state must hold one entry per pixel; spp >= 1")
    refill = use_refill(refill, whitted, spp)
    lib = build.load("frame_kernel")
    lib.pt_launch_frame.argtypes = [ctypes.POINTER(_FrameArgs),
                                    ctypes.c_void_p]
    lib.pt_launch_frame.restype = ctypes.c_int
    rotmat = vm.rotation_matrix(cam_rot.to(torch.float32))
    scal = torch.cat([cam_pos.to(torch.float32).reshape(3),
                      rotmat.reshape(9),
                      ifd.to(torch.float32).reshape(1)]).contiguous()
    rad = torch.empty((width * height, 3), dtype=torch.float32, device=dev)
    state_out = torch.empty_like(state)
    rays = torch.zeros(1, dtype=torch.int64, device=dev)
    mode, n_out = CHECKS[check] if check else (0, 0)
    checked = torch.zeros(n_out, dtype=torch.int64, device=dev)
    args = _FrameArgs(
        scene_args(scene, info, dev), scal=ptr(scal, torch.float32, dev),
        state_in=ptr(state, torch.int64, dev),
        state_out=state_out.data_ptr(), rad_out=rad.data_ptr(),
        rays_out=rays.data_ptr(),
        check_out=checked.data_ptr() if check else None,
        width=width, height=height, spp=spp,
        max_bounces=max_bounces, stack_size=stack_size,
        xs_scale=float(np.float32(-cam_size)),
        ys_scale=float(np.float32(height / float(width) * cam_size)),
        focal_length=focal_length, blur=blur, whitted=int(whitted),
        refill=int(refill), check=mode)
    err = lib.pt_launch_frame(
        ctypes.byref(args),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"frame kernel launch failed: CUDA error {err}")
    if check:
        return rad, state_out, rays, checked
    if refill:
        trace_frame.refill_launches += 1
    else:
        trace_frame.launches += 1
    return rad, state_out, rays


trace_frame.launches = 0
trace_frame.refill_launches = 0


def render_fused_frame(scene, info, cam_pos, cam_rot, frame_seed: int, ifd,
                       *, width: int, height: int, spp: int,
                       max_bounces: int, stack_size: int = 10,
                       cam_size: float = 1.5, focal_length: float = 1.0,
                       blur: float = 0.0, whitted: bool = False):
    """One frame through `trace_frame`: per-pixel streams seeded
    index + frame_seed and carried across the samples (frag.glsl:896-913).
    PT0_FUSED_REFILL=1 in the environment selects the refill schedule
    (fused.py:1965; off by default). Returns ((H*W, 3) mean over spp,
    queries (1,) int64)."""
    with span("pt0.frame"):
        dev = scene.device
        index = torch.arange(width * height, dtype=torch.int64, device=dev)
        state = vrng.seed(index, frame_seed)
        rad, _, rays = trace_frame(
            scene, info, cam_pos, cam_rot, ifd, state, width=width,
            height=height, spp=spp, max_bounces=max_bounces,
            stack_size=stack_size, cam_size=cam_size,
            focal_length=focal_length, blur=blur, whitted=whitted,
            refill=os.environ.get("PT0_FUSED_REFILL", "0") == "1")
        return rad / float(spp), rays
