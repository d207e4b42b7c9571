"""The block path: the whole bounce loop of one sample's rays in one
launch.

Counterpart of the JAX package's kernels/fused.py `trace_block` (whose
Pallas kernel is `_fused_kernel`) and `trace_fused`. On the card
`trace_block` launches csrc/block_kernel.cu, one thread per ray; on CPU
tensors it runs the plain bounce loop render/integrator.trace_plain. Both
take rays, an alive mask and the per-ray RNG state, and return the
radiance WITH the sky (the TPU kernel deferred the sky to a second pass
because Mosaic cannot gather), the advanced state and the count of scene
queries.

The scene arguments of this kernel and of the frame kernel
(kernels/frame.py) are one struct, `SceneArgs`.
"""
from __future__ import annotations

import ctypes

import torch

from ..scene.packing import MAX_MATERIALS, MAX_TRIS
from ..shade import implicits
from . import build
from .build import ptr

MAX_STACK = 16  # csrc/pathtrace.cuh MAX_STACK
# From this many triangles on, block_kernel stages the scene's rows in
# shared memory and tests them with the early exit (csrc/block_kernel.cu
# STAGE); below it, the plain loop. chip_smoke.py times both forms at 4 to
# 144 triangles (phase `block_stage_min`): staging was 7% slower at 4 and
# 2% slower at 9 triangles, 4% faster at 16, the next size measured (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md).
STAGE_MIN = 16
# the check-only instantiations of the frame and block kernels
# (csrc/integrate.cuh CHECK): name -> (its `check` argument, int64 outputs)
CHECKS = {"lanes": (1, 2), "phases": (2, 7)}
# csrc/pathtrace.cuh PH_*: the parts of a scene query, then the warps' own
# cycles from start to end
PHASES = ("triangles", "implicits", "ellipsoids", "decode", "sky", "choose",
          "warp")


class SceneArgs(ctypes.Structure):
    """csrc/integrate.cuh `SceneArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "mats", "ell", "imp", "ell_flags", "imp_info", "tris", "attr", "uvt",
        "atlas", "slots", "mat_maps", "sky")] + [(n, ctypes.c_int) for n in (
        "n_mats", "n_ell", "n_imp", "n_tris", "sky_h", "sky_w",
        "march_steps", "bisect_iters")] + [
        ("march_tmax", ctypes.c_float), ("gate_ss", ctypes.c_int)]


class _BlockArgs(ctypes.Structure):
    """csrc/block_kernel.cu `BlockArgs`, field for field."""

    _fields_ = [("scene", SceneArgs)] + [(n, ctypes.c_void_p) for n in (
        "ox", "oy", "oz", "dx", "dy", "dz", "alive", "state_in", "state_out",
        "rad_out", "rays_out", "check_out")] + [(n, ctypes.c_int) for n in (
        "n_rays", "max_bounces", "stack_size", "check", "stage_min")]


def scene_args(scene, info, dev) -> SceneArgs:
    f32, i32 = torch.float32, torch.int32
    s = scene
    return SceneArgs(
        mats=ptr(s.materials, f32, dev), ell=ptr(s.ell_tab, f32, dev),
        imp=ptr(s.imp_tab, f32, dev), ell_flags=ptr(s.ell_flags, i32, dev),
        imp_info=ptr(s.imp_info, i32, dev), tris=ptr(s.tris, f32, dev),
        attr=ptr(s.attr, f32, dev), uvt=ptr(s.uvt, f32, dev),
        atlas=ptr(s.atlas, f32, dev), slots=ptr(s.slots, i32, dev),
        mat_maps=ptr(s.mat_maps, i32, dev), sky=ptr(s.sky, f32, dev),
        n_mats=info.num_materials, n_ell=info.num_ellipsoids,
        n_imp=info.num_implicits, n_tris=info.num_tris,
        sky_h=info.sky_shape[0], sky_w=info.sky_shape[1],
        march_steps=implicits.MARCH_STEPS,
        bisect_iters=implicits.BISECT_ITERS,
        march_tmax=implicits.MARCH_TMAX, gate_ss=int(info.mat_gates[0]))


def eligible(info, *, stack_size=None) -> bool:
    """Whether the brute-force kernels (block and frame) take this scene:
    at most MAX_TRIS triangles, 1..MAX_MATERIALS materials, not a streamed
    scene (one built past `stream_threshold`, however small), and where
    given a refraction stack of 2..MAX_STACK entries (their stacks live in
    shared memory; any other depth takes the per-bounce route)."""
    return (not info.streamed and info.num_tris <= MAX_TRIS
            and 1 <= info.num_materials <= MAX_MATERIALS
            and (stack_size is None or 2 <= stack_size <= MAX_STACK))


def trace_block(scene, info, o, d, alive, state, *, max_bounces: int,
                stack_size: int = 10, check=None):
    """The bounce loop of rays o, d ((x, y, z) tuples of (R,) float32, d
    normalized) that are `alive` (R,) bool, with RNG `state` (R,) int64.
    CUDA tensors go through csrc/block_kernel.cu, CPU tensors through the
    plain version.

    Returns (radiance with sky (r, g, b), state, queries (1,) int64).

    `check` ("lanes" or "phases", card only) runs a check-only
    instantiation instead, which gives the same outputs and one more,
    counted in no launch count: "lanes", (lanes summed over the bounce
    steps, warp steps) int64, whose first equals the queries and whose
    ratio over 32 is the share of a warp's lanes a bounce step keeps busy;
    "phases", {part of PHASES: clock64() cycles summed over the warps}, each
    part counted once for the lanes that run it together and "warp" each
    warp's cycles from start to end."""
    dev = state.device
    if check is not None and check not in CHECKS:
        raise ValueError(f"check must be one of {tuple(CHECKS)}, not "
                         f"{check!r}")
    if check is not None and dev.type != "cuda":
        raise ValueError(f"check={check!r} measures the card: it needs CUDA "
                         "tensors")
    if dev.type == "cpu":
        from ..render import integrator

        inc, skyc, state, queries = integrator.trace_plain(
            scene, info, o, d, alive, state, max_bounces=max_bounces,
            stack_size=stack_size)
        return (tuple(inc[i] + skyc[i] for i in range(3)), state,
                queries.sum().reshape(1))
    if dev.type != "cuda":
        raise ValueError(f"no block kernel for device {dev}")
    if not eligible(info):
        raise ValueError("scene is not eligible for the block kernel "
                         f"({info.num_tris} triangles, "
                         f"{info.num_materials} materials)")
    if not 2 <= stack_size <= MAX_STACK:
        raise ValueError(f"stack_size {stack_size} not in [2, {MAX_STACK}]")
    n_rays = state.shape[0]
    f32 = torch.float32
    rays = [c.contiguous() for c in (*o, *d)]   # kept alive past the launch
    if any(c.shape != (n_rays,) for c in (*rays, alive)) or max_bounces < 0:
        raise ValueError("o, d, alive and state must hold one entry per ray")
    rad = torch.empty((3, n_rays), dtype=f32, device=dev)
    state_out = torch.empty_like(state)
    queries = torch.zeros(1, dtype=torch.int64, device=dev)
    mode, n_out = CHECKS[check] if check else (0, 0)
    checked = torch.zeros(n_out, dtype=torch.int64, device=dev)
    args = _BlockArgs(
        scene_args(scene, info, dev), *(ptr(c, f32, dev) for c in rays),
        alive=ptr(alive, torch.bool, dev),
        state_in=ptr(state, torch.int64, dev),
        state_out=state_out.data_ptr(), rad_out=rad.data_ptr(),
        rays_out=queries.data_ptr(),
        check_out=checked.data_ptr() if check else None, n_rays=n_rays,
        max_bounces=max_bounces, stack_size=stack_size, check=mode,
        stage_min=STAGE_MIN)
    lib = build.load("block_kernel")
    lib.pt_launch_block.argtypes = [ctypes.POINTER(_BlockArgs),
                                    ctypes.c_void_p]
    lib.pt_launch_block.restype = ctypes.c_int
    err = lib.pt_launch_block(
        ctypes.byref(args),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"block kernel launch failed: CUDA error {err}")
    out = (rad[0], rad[1], rad[2]), state_out, queries
    if check == "phases":
        return (*out, dict(zip(PHASES, checked.tolist())))
    if check:
        return (*out, checked)
    trace_block.launches += 1
    return out


trace_block.launches = 0


def trace_fused(scene, info, o, d, alive, state, *, max_bounces: int,
                stack_size: int = 10):
    """`integrator.trace` of an eligible scene in one launch: same
    arguments, same RNG streams, same results."""
    if not eligible(info):
        raise ValueError("scene is not eligible for the block kernel")
    return trace_block(scene, info, o, d, alive, state,
                       max_bounces=max_bounces, stack_size=stack_size)
