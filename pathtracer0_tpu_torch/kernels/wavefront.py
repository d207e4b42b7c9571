"""Closest triangle hit of a batch of rays against the SAH forest.

Counterpart of the JAX package's kernels/wavefront.py `trace_forest` and
its two Pallas kernels: `_brute_kernel` (every triangle against every
ray, for forests of at most BRUTE_MAX_ROWS leaves) and `_traverse_kernel`
(the stack walk). On the card `trace_forest` launches
csrc/forest_kernel.cu `brute_kernel` or `traverse_kernel`, one thread per
ray; on CPU tensors it runs the plain PyTorch versions below, which are
batched over the rays and follow the kernels' arithmetic operation for
operation.

Both kernels start from a per-ray `t_init` (0 switches a lane off: it
comes back t = 0, idx = -1, both counters 0) and use the dividing
Möller-Trumbore test (kernels/intersect.tri_divide) with a strict
t < closest, so the first triangle in leaf order wins a tie.

The stack walk visits the objects in order, each pruned by the closest
hit so far (frag.glsl:563-577), and inside an object pushes the far child
first (frag.glsl:523-531). Its counters are per ray: 2 box tests for each
internal node visited, 1 leaf visit for each leaf (the TPU kernel counted
per block of rays). A walk never holds more than forest depth + 1 nodes:
the plain version sizes its stack tensor from `info.forest_depth`, the
kernel has scene/packing.TRAVERSE_MAX_STACK entries per ray, and a deeper
forest is refused when the scene is packed.
"""
from __future__ import annotations

import ctypes

import torch

from ..scene.packing import TRAVERSE_MAX_STACK
from . import build
from .intersect import ray_box, safe_inv_dir, tri_divide

# forests of at most this many leaves skip the stack walk
BRUTE_MAX_ROWS = 192

launches = {"brute_kernel": 0, "traverse_kernel": 0}


class _ForestArgs(ctypes.Structure):
    """csrc/forest_kernel.cu `ForestArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ox", "oy", "oz", "dx", "dy", "dz", "t_init", "nodes_f", "nodes_i",
        "tris", "roots", "t", "u", "v", "idx", "box", "leaf")] + [
        (n, ctypes.c_int) for n in ("n_rays", "n_roots", "n_tris",
                                    "n_leaves")]


def _rows(table, k):
    return [table[:, i] for i in range(k)]


def _leaf_test(o, d, row, valid, slot, best):
    """Test one triangle row per ray (rows (R, 9)) where `valid`; `slot`
    is its wf_tris index. best = (t, u, v, idx) is updated in place."""
    ok, t, u, v = tri_divide(o, d, row[0:3], row[3:6], row[6:9])
    ok = valid & ok & (t < best[0])
    best[0] = torch.where(ok, t, best[0])
    best[1] = torch.where(ok, u, best[1])
    best[2] = torch.where(ok, v, best[2])
    best[3] = torch.where(ok, slot, best[3])


def _start(t_init):
    zero = torch.zeros_like(t_init)
    idx = torch.full(t_init.shape, -1, dtype=torch.int32,
                     device=t_init.device)
    return [t_init, zero, zero, idx], torch.zeros_like(idx)


def brute_reference(o, d, t_init, scene, info):
    """Plain version of `brute_kernel`: every wf_tris row in order against
    every ray. Box tests 0, leaf visits = the number of leaves."""
    best, count = _start(t_init)
    live = t_init > 0.0
    for k in range(info.num_tris):
        row = [scene.wf_tris[k, i] for i in range(9)]
        _leaf_test(o, d, row, live, k, best)
    return (*best, count, torch.where(live, info.num_leaves, count))


def traverse_reference(o, d, t_init, scene, info):
    """Plain version of `traverse_kernel`: one (R, depth + 1) stack tensor,
    every ray popping one node per step until all stacks are empty."""
    best, box = _start(t_init)
    leaf = box
    n_rays = t_init.shape[0]
    dev = t_init.device
    rays = torch.arange(n_rays, device=dev)
    inv_d = tuple(safe_inv_dir(c) for c in d)
    live = t_init > 0.0
    cap = info.forest_depth + 1
    last_row = scene.wf_tris.shape[0] - 1
    nodes_i = scene.nodes_i.to(torch.int64)

    def entry(node):
        b = scene.nodes_f[node]
        return ray_box(o, inv_d, (b[..., 0], b[..., 1], b[..., 2]),
                       (b[..., 3], b[..., 4], b[..., 5]))

    def push(stack, sp, want, node):
        at = torch.clamp(sp, max=cap - 1)
        stack[rays, at] = torch.where(want, node, stack[rays, at])
        return sp + want.to(torch.int64)

    for k in range(info.num_objects):
        root = nodes_i.new_full((n_rays,), int(scene.roots[k]))
        stack = torch.zeros((n_rays, cap), dtype=torch.int64, device=dev)
        stack[:, 0] = root
        # the root's own box prunes the object (frag.glsl:563-565)
        sp = (live & ~(entry(root) > best[0])).to(torch.int64)
        while bool((sp > 0).any()):
            active = sp > 0
            sp = sp - active.to(torch.int64)
            node = stack[rays, sp]
            left, right, start, count = nodes_i[node].unbind(-1)
            is_leaf = active & (left < 0)
            for j in range(info.max_leaf_size):
                slot = start + j
                row = _rows(scene.wf_tris[torch.clamp(slot, 0, last_row)], 9)
                _leaf_test(o, d, row, is_leaf & (j < count),
                           slot.to(torch.int32), best)
            inner = active & ~is_leaf
            lsafe, rsafe = torch.clamp(left, min=0), torch.clamp(right, min=0)
            dl, dr = entry(lsafe), entry(rsafe)
            swap = dl > dr
            far = torch.where(swap, left, right)
            near = torch.where(swap, right, left)
            far_d = torch.where(swap, dl, dr)
            near_d = torch.where(swap, dr, dl)
            sp = push(stack, sp, inner & (far_d < best[0]), far)
            sp = push(stack, sp, inner & (near_d < best[0]), near)
            box = box + 2 * inner.to(torch.int32)
            leaf = leaf + is_leaf.to(torch.int32)
    return (*best, box, leaf)


def use_brute(info) -> bool:
    return info.num_leaves <= BRUTE_MAX_ROWS


def trace_forest_reference(o, d, t_init, scene, info):
    """The plain version of whichever kernel `trace_forest` would launch."""
    fn = brute_reference if use_brute(info) else traverse_reference
    return fn(o, d, t_init, scene, info)


def trace_forest(o, d, t_init, scene, info):
    """Closest triangle hit of rays o + t d, o and d (x, y, z) tuples of
    (R,) float32, from the per-ray closest-so-far `t_init` (R,).

    Returns (t, u, v, idx, box tests, leaf visits): idx (R,) int32 is the
    row of scene.wf_tris that was hit (-1 for none; scene.wf_perm gives
    the triangle id), the counters are (R,) int32. CUDA tensors go through
    csrc/forest_kernel.cu, CPU tensors through the plain versions."""
    dev = t_init.device
    if dev.type == "cpu":
        return trace_forest_reference(o, d, t_init, scene, info)
    if dev.type != "cuda":
        raise ValueError(f"no forest kernel for device {dev}")
    if info.num_objects < 1:
        raise ValueError("the scene has no forest to trace")
    n_rays = t_init.shape[0]
    f32, i32 = torch.float32, torch.int32
    rays = [c.contiguous() for c in (*o, *d, t_init)]
    if any(c.shape != (n_rays,) for c in rays):
        raise ValueError("o, d and t_init must hold one entry per ray")
    t, u, v = (torch.empty(n_rays, dtype=f32, device=dev) for _ in range(3))
    idx, box, leaf = (torch.empty(n_rays, dtype=i32, device=dev)
                      for _ in range(3))
    args = _ForestArgs(
        *(build.ptr(c, f32, dev) for c in rays),
        nodes_f=build.ptr(scene.nodes_f, f32, dev),
        nodes_i=build.ptr(scene.nodes_i, i32, dev),
        tris=build.ptr(scene.wf_tris, f32, dev),
        roots=build.ptr(scene.roots, i32, dev),
        t=t.data_ptr(), u=u.data_ptr(), v=v.data_ptr(), idx=idx.data_ptr(),
        box=box.data_ptr(), leaf=leaf.data_ptr(), n_rays=n_rays,
        n_roots=info.num_objects, n_tris=info.num_tris,
        n_leaves=info.num_leaves)
    brute = use_brute(info)
    name = "brute_kernel" if brute else "traverse_kernel"
    if not brute and info.forest_depth + 1 > TRAVERSE_MAX_STACK:
        raise ValueError(f"forest depth {info.forest_depth} needs a stack "
                         f"of {info.forest_depth + 1}; the kernel has "
                         f"{TRAVERSE_MAX_STACK}")
    lib = build.load("forest_kernel")
    launch = lib.pt_launch_brute if brute else lib.pt_launch_traverse
    launch.argtypes = [ctypes.POINTER(_ForestArgs), ctypes.c_void_p]
    launch.restype = ctypes.c_int
    err = launch(ctypes.byref(args),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return t, u, v, idx, box, leaf
