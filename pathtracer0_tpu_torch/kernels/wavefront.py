"""Closest triangle hit of a batch of rays against the SAH forest, or
against the streamed LBVH of a large scene.

Counterpart of the JAX package's kernels/wavefront.py `trace_forest` and
its two Pallas kernels: `_brute_kernel` (every triangle against every
ray, for forests of at most BRUTE_MAX_ROWS leaves) and `_traverse_kernel`
(the stack walk). On the card `trace_forest` launches
csrc/forest_kernel.cu `brute_kernel` (the table staged in shared memory,
a division-free pre-reject that changes no result: csrc/tri_divide.cuh)
or `traverse_kernel`, one thread per ray; on CPU tensors it runs the
plain PyTorch versions below, which are
batched over the rays and follow the kernels' arithmetic operation for
operation.

Both kernels start from a per-ray `t_init` (0 switches a lane off: it
comes back t = 0, idx = -1, both counters 0) and use the dividing
Möller-Trumbore test (kernels/intersect.tri_divide) with a strict
t < closest, so the first row tested wins a tie: the first in wf_tris
order for brute_kernel, the first in the walk's order of visits for the
stack walk.

The stack walk visits the objects in order, each pruned by the closest
hit so far (frag.glsl:563-577), and inside an object pushes the far child
first (frag.glsl:523-531). Its counters are per ray: 2 box tests for each
internal node visited, 1 leaf visit for each leaf (the TPU kernel counted
per block of rays). The plain version walks nodes_f and nodes_i; the
kernel walks scene.nodes_w, one 64-byte record per inner node with both
children's boxes and links (scene/packing.walk_records), which it must
find on a 64-byte boundary: the same boxes and the same visits.
`walk_object` walks one object alone, as the debug heatmap counts it
(traverse_kernel with that object's root as its only one). A walk never
holds more than forest depth + 1 nodes:
the plain version sizes its stack tensor from `info.forest_depth`, the
kernel has scene/packing.TRAVERSE_MAX_STACK entries per ray, and a deeper
forest is refused when the scene is packed.

`trace_streamed` is the counterpart of that package's `trace_streamed` and
its `_streamed_kernel`: on the card csrc/streamed_kernel.cu, one thread
per ray, on CPU tensors `streamed_reference`. One walk covers both levels
of the LBVH (accel/lbvh.py): the top tree, whose leaves are the treelets,
and on into the treelet's own 63-box subtree heap down to a group of 4
rows (the TPU kernel loops over a treelet's 32 group boxes instead; the
builder stores the whole heap, and a per-ray walk visits fewer boxes
through it). At a group the row cull (`group_rows`, csrc/row_cull.cuh)
takes the entry distances of its 4 row boxes (scene.st_rows) and tests
only the rows whose entry is below the pruning distance, nearest first,
each row's 14 slots in order. A node code below 2n - 1 is a top node,
2n - 1 + 64 * treelet + k node k of that treelet's subtree. The triangle
test is the division-free one (kernels/intersect.tri_candidate): the
closest hit is carried as numerators over the denominator td and compared
by cross-multiplication, strictly, so the first slot in walk order wins a
tie, except that inside a group a slot before the closest hit's takes an
exact tie, as the group's slots in order would decide it; one reciprocal
follows the walk. Children are ordered by the ray's own entry distances,
far pushed first, each pushed only if its distance is below the pruning
distance t / td, which is refreshed by one division after every row that
took a hit; a popped node is dropped if the pruning distance has since come
below its entry distance. A box whose min exceeds its max (an empty row,
group or treelet: +inf, -inf) is refused before the slab test, which an
infinite inverted box would pass. Counters per ray: 2 box tests for each
internal node visited, 4 row visits for each group entered. idx is
row * 14 + slot; scene.st_perm gives the triangle id. On the card the
walk is while-while (a lane descends to its next group, then the lanes
that have one test their groups together), reads a row 8 bytes and a box
16 bytes at a time, so st_tris must start on an 8-byte boundary and
st_rows on a 16-byte one; a lane's order of visits, and so its bits, are
the stack walk's. `streamed_phase_cycles`
runs the kernel's check-only instantiation that says where a warp's
cycles go. The route (kernels/traverse.py) sorts a query's rays first.
"""
from __future__ import annotations

import ctypes

import torch

from ..accel import lbvh
from ..scene.packing import (STREAM_MAX_STACK, TRAVERSE_MAX_STACK,
                             stream_stack_need)
from . import build
from .intersect import (MISS, ray_box, safe_inv_dir, tri_candidate,
                        tri_divide)

# forests of at most this many leaves skip the stack walk
BRUTE_MAX_ROWS = 192

# sort_key_kernel counts the streamed queries that took `trace_sorted`
launches = {"brute_kernel": 0, "traverse_kernel": 0, "streamed_kernel": 0,
            "sort_key_kernel": 0}

# the treelet's shape (csrc/streamed_kernel.cu has the same constants)
_GROUPS = lbvh.TREELET_ROWS // lbvh.SUB_GROUP_ROWS
_SUB_STRIDE = 2 * _GROUPS
_GROUP_TRIS = lbvh.SUB_GROUP_ROWS * lbvh.TRIS_PER_ROW


class _ForestArgs(ctypes.Structure):
    """csrc/forest_kernel.cu `ForestArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ox", "oy", "oz", "dx", "dy", "dz", "t_init", "nodes_f", "nodes_w",
        "root_links", "tris", "roots", "t", "u", "v", "idx", "box",
        "leaf")] + [
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


def traverse_reference(o, d, t_init, scene, info, objects=None):
    """Plain version of `traverse_kernel`: one (R, depth + 1) stack tensor,
    every ray popping one node per step until all stacks are empty.
    `objects` (default: all, in order) are the indices of the roots to
    walk."""
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

    for k in range(info.num_objects) if objects is None else objects:
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
    return _launch_forest(o, d, t_init, scene, info, use_brute(info),
                          slice(0, info.num_objects))


def walk_object(o, d, t_init, scene, info, k: int):
    """The stack walk of object k alone (root scene.roots[k]) from the
    per-ray `t_init`: `traverse_kernel` with that one root, whatever the
    forest's size (brute_kernel counts no walk), on CUDA tensors;
    `traverse_reference(objects=(k,))` on CPU tensors. Returns as
    `trace_forest`; its counters are the walk's of that object."""
    if not 0 <= k < info.num_objects:
        raise ValueError(f"object {k} of {info.num_objects}")
    if t_init.device.type == "cpu":
        return traverse_reference(o, d, t_init, scene, info, objects=(k,))
    return _launch_forest(o, d, t_init, scene, info, False,
                          slice(k, k + 1))


def _launch_forest(o, d, t_init, scene, info, brute, objects):
    """Launch brute_kernel (`brute`) or traverse_kernel over the objects
    of the slice `objects` of the scene's roots."""
    dev = t_init.device
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
    roots, root_links = scene.roots[objects], scene.root_links[objects]
    args = _ForestArgs(
        *(build.ptr(c, f32, dev) for c in rays),
        nodes_f=build.ptr(scene.nodes_f, f32, dev),
        nodes_w=build.ptr(scene.nodes_w, i32, dev),
        root_links=build.ptr(root_links, i32, dev),
        tris=build.ptr(scene.wf_tris, f32, dev),
        roots=build.ptr(roots, i32, dev),
        t=t.data_ptr(), u=u.data_ptr(), v=v.data_ptr(), idx=idx.data_ptr(),
        box=box.data_ptr(), leaf=leaf.data_ptr(), n_rays=n_rays,
        n_roots=roots.shape[0], n_tris=info.num_tris,
        n_leaves=info.num_leaves)
    name = "brute_kernel" if brute else "traverse_kernel"
    if not brute and info.forest_depth + 1 > TRAVERSE_MAX_STACK:
        raise ValueError(f"forest depth {info.forest_depth} needs a stack "
                         f"of {info.forest_depth + 1}; the kernel has "
                         f"{TRAVERSE_MAX_STACK}")
    if scene.nodes_w.data_ptr() % 64:
        raise ValueError("nodes_w must start on a 64-byte boundary: the "
                         "kernel reads a record as one 64-byte fetch")
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


class _StreamArgs(ctypes.Structure):
    """csrc/streamed_kernel.cu `StreamArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ox", "oy", "oz", "dx", "dy", "dz", "t_init", "top", "sub", "tris",
        "rows_box", "t", "u", "v", "idx", "box", "rows", "check_out",
        "active", "key", "order", "onx", "ony", "onz")] + [
        (n, ctypes.c_int) for n in ("n_rays", "n_treelets", "form")]


# csrc/streamed_kernel.cu's forms
_NO_CHECK, _PHASES, _ORDERED = 0, 1, 2


# the sums of csrc/streamed_kernel.cu's check-only PHASES instantiation, in
# its order: cycles of the top-tree box tests, the subtree box tests, the
# group tests (row boxes and rows), the stack's pushes and pops, and each
# warp from start to end; then the group tests of a warp (lanes that test
# groups together), the lanes in them and the distinct groups among those
# lanes; then the rows tested and the row boxes tested, over the rays
STREAMED_PHASES = ("top_box", "sub_box", "group", "stack", "warp",
                   "group_tests", "group_lanes", "group_distinct",
                   "rows_tested", "row_boxes")


def _check_streamed(scene, info):
    n = info.st_n_treelets
    if not info.streamed or n < 1:
        raise ValueError("the scene has no streamed LBVH to trace")
    if (info.st_treelet_rows, info.st_leaf_cap) != (lbvh.TREELET_ROWS,
                                                    lbvh.TRIS_PER_ROW):
        raise ValueError("the streamed tables were built with other row or "
                         "treelet sizes than accel/lbvh.py's")
    want = {"st_top": (2 * n - 1, 8), "st_sub": (_SUB_STRIDE * n, 8),
            "st_tris": (lbvh.TREELET_ROWS * lbvh.TRIS_PER_ROW * n, 9),
            "st_rows": (lbvh.TREELET_ROWS * n, 8)}
    for name, shape in want.items():
        if tuple(getattr(scene, name).shape) != shape:
            raise ValueError(f"{name} must be {shape} for {n} treelets, "
                             f"not {tuple(getattr(scene, name).shape)}")
    need = stream_stack_need(n)
    if need > STREAM_MAX_STACK:
        raise ValueError(f"{n} treelets need a stack of {need}; the kernel "
                         f"has {STREAM_MAX_STACK}")


def box_entry(o, inv_d, b):
    """The entry distances of rays o (reciprocal directions `inv_d`, from
    `safe_inv_dir`) into boxes b (..., 8) of the streamed tables, as
    csrc/streamed_kernel.cu `entry`: MISS past a box, and for an empty one
    (min > max), which the bare slab test would pass."""
    dist = ray_box(o, inv_d, (b[..., 0], b[..., 1], b[..., 2]),
                   (b[..., 3], b[..., 4], b[..., 5]))
    return torch.where(b[..., 0] <= b[..., 3], dist, MISS)


def group_rows(o, d, tri, rd, slot0, best):
    """The row cull of one group per ray (csrc/row_cull.cuh): the rows
    whose entry distance `rd` is below the pruning distance, nearest first
    (the lower row on equal entries), each checked again as that distance
    falls; a row's 14 slots in order through the division-free slot test,
    a slot before the closest hit's in the same group taking an exact tie.
    o, d: (x, y, z) tuples of (L,) tensors; `tri` (L, 56, 9) the group's
    slots; `rd` (L, 4) the entry distances of its row boxes; `slot0` (L,)
    int32 the idx of its first slot; best = [t, td, u, v, idx, tcur] as in
    `group_accept`. Returns (best, order): `order` (L, 4) int64 holds the
    rows tested, in the order tested, then -1."""
    n, per = lbvh.SUB_GROUP_ROWS, lbvh.TRIS_PER_ROW
    ok, tc, adet, uc, vc = tri_candidate(
        tuple(c[:, None] for c in o), tuple(c[:, None] for c in d),
        tuple(tri[..., i] for i in (0, 1, 2)),
        tuple(tri[..., i] for i in (3, 4, 5)),
        tuple(tri[..., i] for i in (6, 7, 8)))
    left = torch.ones(rd.shape, dtype=torch.bool, device=rd.device)
    order = torch.full(rd.shape, -1, dtype=torch.int64, device=rd.device)
    lanes = torch.arange(n, device=rd.device)
    for step in range(n):
        cand = left & (rd < best[5][:, None])
        go = cand.any(1)
        # argmin takes the first of equal minima: the lower row
        row = torch.where(cand, rd, float("inf")).argmin(1)
        order[:, step] = torch.where(go, row, -1)
        left = left & ~(go[:, None] & (lanes == row[:, None]))
        took = torch.zeros_like(go)
        for s in range(per):
            j = (row * per + s)[:, None]
            tcj, adj, ucj, vcj = (x.gather(1, j)[:, 0]
                                  for x in (tc, adet, uc, vc))
            slot = slot0 + j[:, 0].to(torch.int32)
            tie = ((best[4] >= slot0) & (best[4] < slot0 + _GROUP_TRIS)
                   & (slot < best[4]))
            mine, cur = tcj * best[1], best[0] * adj
            okj = go & ok.gather(1, j)[:, 0] & (
                (mine < cur) | (tie & (mine == cur)))
            new = (tcj, adj, ucj, vcj, slot)
            best[:5] = [torch.where(okj, a, b) for a, b in zip(new, best)]
            took = took | okj
        best[5] = torch.where(took, best[0] / best[1], best[5])
    return best, order


def group_accept(o, d, tri, slots, best):
    """The division-free slot test of one group of 56 triangles per ray,
    the slots in order (csrc/tri_free.cuh `accept`). o, d: (x, y, z) tuples
    of (L,) tensors; `tri` (L, 56, 9) or, one group for all rays, (56, 9);
    `slots` their idx values, (L, 56) or (56,) int32; best = [t, td, u, v,
    idx, tcur] of (L,) tensors, the closest hit as numerators over td and
    the pruning distance t / td. Returns the new `best`."""
    ok, tc, adet, uc, vc = tri_candidate(
        tuple(c[:, None] for c in o), tuple(c[:, None] for c in d),
        tuple(tri[..., i] for i in (0, 1, 2)),
        tuple(tri[..., i] for i in (3, 4, 5)),
        tuple(tri[..., i] for i in (6, 7, 8)))
    for j in range(_GROUP_TRIS):
        okj = ok[:, j] & (tc[:, j] * best[1] < best[0] * adet[:, j])
        new = (tc[:, j], adet[:, j], uc[:, j], vc[:, j], slots[..., j],
               tc[:, j] / adet[:, j])
        best = [torch.where(okj, a, b) for a, b in zip(new, best)]
    return best


def streamed_reference(o, d, t_init, scene, info, visited=None,
                       rows_tested=None):
    """Plain version of `streamed_kernel` (module docstring): one (R, cap)
    stack of (node, entry distance), every ray popping one node per step
    until all stacks are empty. Returns as `trace_streamed`.

    `visited`, if given, is a pair of bool tensors that the walk marks:
    (2n - 1 + 64n,) the boxes some ray tested (rows of st_top, then of
    st_sub) and (32n,) the groups some ray entered. They say what the
    batch has to read of the tables. `rows_tested`, if given, is an (R,)
    int32 tensor to which the walk adds the rows each ray tests (the row
    cull's count; `rows` counts 4 for each group entered)."""
    _check_streamed(scene, info)
    n = info.st_n_treelets
    n_top, sub0 = n - 1, 2 * n - 1
    dev = t_init.device
    n_rays = t_init.shape[0]
    rays = torch.arange(n_rays, device=dev)
    # the box of top node c at row c, of subtree node code c at row c too
    boxes = torch.cat([scene.st_top, scene.st_sub])
    last_box = boxes.shape[0] - 2
    inv_d = tuple(safe_inv_dir(c) for c in d)
    cap = stream_stack_need(n)
    t, td = t_init.clone(), torch.ones_like(t_init)
    u, v = torch.zeros_like(t_init), torch.zeros_like(t_init)
    idx = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    tcur = t_init.clone()
    box, rows = torch.zeros_like(idx), torch.zeros_like(idx)
    stack_n = torch.zeros((n_rays, cap), dtype=torch.int64, device=dev)
    stack_d = torch.zeros((n_rays, cap), dtype=torch.float32, device=dev)
    stack_n[:, 0] = 0 if n_top > 0 else sub0
    sp = (t_init > 0.0).to(torch.int64)
    lanes = torch.arange(_GROUP_TRIS, device=dev)
    row_lanes = torch.arange(lbvh.SUB_GROUP_ROWS, device=dev)

    def entry(at):
        return box_entry(o, inv_d, boxes[at])

    def push(sp, want, node, dist):
        at = torch.clamp(sp, max=cap - 1)
        stack_n[rays, at] = torch.where(want, node, stack_n[rays, at])
        stack_d[rays, at] = torch.where(want, dist, stack_d[rays, at])
        return sp + want.to(torch.int64)

    while bool((sp > 0).any()):
        active = sp > 0
        sp = sp - active.to(torch.int64)
        node, dist = stack_n[rays, sp], stack_d[rays, sp]
        go = active & (dist < tcur)
        in_sub = node >= sub0
        k = (node - sub0) & (_SUB_STRIDE - 1)
        at_group = go & in_sub & (k >= _GROUPS - 1)
        inner = go & ~at_group

        # a group of a treelet, for the rays there: the entry distances of
        # its 4 row boxes, then its rows by the row cull (`group_rows`)
        at = at_group.nonzero()[:, 0]
        if at.numel():
            treelet = (node[at] - sub0) // _SUB_STRIDE
            row0 = (treelet * lbvh.TREELET_ROWS
                    + (k[at] - (_GROUPS - 1)) * lbvh.SUB_GROUP_ROWS)
            slot0 = row0 * lbvh.TRIS_PER_ROW
            if visited is not None:
                visited[1][slot0 // _GROUP_TRIS] = True
            oa, da = tuple(c[at] for c in o), tuple(c[at] for c in d)
            rd = box_entry(tuple(c[:, None] for c in oa),
                           tuple(c[at, None] for c in inv_d),
                           scene.st_rows[row0[:, None] + row_lanes])
            best, order = group_rows(
                oa, da, scene.st_tris[slot0[:, None] + lanes], rd,
                slot0.to(torch.int32),
                [x[at] for x in (t, td, u, v, idx, tcur)])
            for x, b in zip((t, td, u, v, idx, tcur), best):
                x[at] = b
            if rows_tested is not None:
                rows_tested[at] += (order >= 0).sum(1, dtype=torch.int32)

        # an internal node: both children by the ray's entry distances.
        # Of top node i they are top nodes 2i+1, 2i+2, a top leaf pushed as
        # its treelet's subtree root; of subtree node k the subtree nodes
        # 2k+1, 2k+2, whose code is node + k + 1
        b0 = torch.clamp(torch.where(in_sub, node + k + 1, 2 * node + 1),
                         max=last_box)
        d0, d1 = entry(b0), entry(b0 + 1)
        if visited is not None:
            visited[0][b0[inner]] = True
            visited[0][b0[inner] + 1] = True
        to_leaf = ~in_sub & (b0 >= n_top)
        c0 = torch.where(to_leaf, sub0 + (b0 - n_top) * _SUB_STRIDE, b0)
        c1 = torch.where(to_leaf, c0 + _SUB_STRIDE, c0 + 1)
        swap = d0 > d1
        far_d, near_d = torch.where(swap, d0, d1), torch.where(swap, d1, d0)
        sp = push(sp, inner & (far_d < tcur), torch.where(swap, c0, c1),
                  far_d)
        sp = push(sp, inner & (near_d < tcur), torch.where(swap, c1, c0),
                  near_d)
        box = box + 2 * inner.to(torch.int32)
        rows = rows + lbvh.SUB_GROUP_ROWS * at_group.to(torch.int32)
    inv = 1.0 / td
    return t * inv, u * inv, v * inv, idx, box, rows


def trace_streamed(o, d, t_init, scene, info):
    """Closest triangle hit of rays o + t d over the streamed LBVH, o and
    d (x, y, z) tuples of (R,) float32, from the per-ray closest-so-far
    `t_init` (R,), 0 switching a ray off.

    Returns (t, u, v, idx, box tests, row visits): idx (R,) int32 is the
    slot of scene.st_tris that was hit (-1 for none; scene.st_perm gives
    the triangle id), the counters are (R,) int32. CUDA tensors go through
    csrc/streamed_kernel.cu, CPU tensors through `streamed_reference`."""
    dev = t_init.device
    if dev.type == "cpu":
        return streamed_reference(o, d, t_init, scene, info)
    if dev.type != "cuda":
        raise ValueError(f"no streamed kernel for device {dev}")
    out = _launch_streamed(o, d, t_init, scene, info)
    launches["streamed_kernel"] += 1
    return out


def streamed_phase_cycles(o, d, t_init, scene, info):
    """`trace_streamed` on the card through the kernel's check-only PHASES
    instantiation: (t, u, v, idx, box tests, row visits, sums), sums
    mapping each of STREAMED_PHASES to its sum over the warps. A
    measurement of the card, counted in no launch count."""
    if t_init.device.type != "cuda":
        raise ValueError("streamed_phase_cycles measures the card: it needs "
                         "CUDA tensors")
    sums = torch.zeros(len(STREAMED_PHASES), dtype=torch.int64,
                       device=t_init.device)
    out = _launch_streamed(o, d, t_init, scene, info, sums)
    return (*out, dict(zip(STREAMED_PHASES, sums.tolist())))


def sort_keys(o, d, active, scene, info):
    """`sort_key_kernel` (csrc/streamed_kernel.cu): the origins o nudged
    by 1e-4 d, bit for bit kernels/traverse.py `nudged`, and the key of
    each ray, (R,) int32, bit for bit `streamed_keys` on the nudged rays.
    o, d: (x, y, z) tuples of (R,) float32 CUDA tensors; `active` (R,)
    bool, None for every ray on. Returns (nudged origins, keys)."""
    n_rays, dev = o[0].shape[0], o[0].device
    on = torch.empty((3, n_rays), dtype=torch.float32, device=dev)
    key = torch.empty(n_rays, dtype=torch.int32, device=dev)
    args, held = _key_args(o, d, active, scene, info, on, key)
    _launch_sort_key(args, _stream(dev))
    return tuple(on.unbind(0)), key


def trace_sorted(o, d, active, scene, info):
    """The route's sorted streamed query on the card in three launches
    (csrc/streamed_kernel.cu): `sort_keys`, a stable argsort of the keys,
    and streamed_kernel's ORDERED form, which walks the rays in that order
    from the nudged origins and t_init = MISS, or 0 where `active` is
    false, and writes each ray's outputs to its own slot. o, d, active as
    in `sort_keys`.

    Returns (nudged origins, (t, u, v, idx, box tests, row visits)), bit
    for bit `sorted_query(trace_streamed, ...)` (kernels/traverse.py) on
    the nudged rays."""
    dev, n_rays = o[0].device, o[0].shape[0]
    # t, u, v, the nudged origins, idx, box, rows and the keys: one block
    out = torch.empty((10, n_rays), dtype=torch.float32, device=dev)
    t, u, v, *on = out[0:6].unbind(0)
    idx, box, rows, key = out[6:10].view(torch.int32).unbind(0)
    # `held`: the rays the kernels read, alive until both are launched
    args, held = _key_args(o, d, active, scene, info, on, key)
    stream = _stream(dev)
    _launch_sort_key(args, stream)
    order = torch.argsort(key, stable=True)
    _set_outputs(args, (t, u, v, idx, box, rows))
    args.ox, args.oy, args.oz = args.onx, args.ony, args.onz
    args.order, args.form = order.data_ptr(), _ORDERED
    _launch("pt_launch_streamed", args, stream)
    launches["streamed_kernel"] += 1
    return tuple(on), (t, u, v, idx, box, rows)


def _key_args(o, d, active, scene, info, on, key):
    """The `StreamArgs` of sort_key_kernel, writing the nudged origins to
    `on` ((3, R), or three (R,)) and the keys to `key`, and the rays they
    point at (as `_stream_args`)."""
    dev = o[0].device
    if dev.type != "cuda":
        raise ValueError(f"no sort-key kernel for device {dev}")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (o[0].shape[0],)):
        raise ValueError("active must be one bool per ray")
    args, held = _stream_args(o, d, None, scene, info)
    args.active = (None if active is None
                   else build.ptr(active, torch.bool, dev))
    args.onx, args.ony, args.onz = (build.ptr(c, torch.float32, dev)
                                    for c in on)
    args.key = build.ptr(key, torch.int32, dev)
    return args, held


def _launch_sort_key(args, stream):
    _launch("pt_launch_sort_key", args, stream)
    launches["sort_key_kernel"] += 1


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch(symbol, args, stream):
    """Call csrc/streamed_kernel.cu's launch function `symbol` on `args`."""
    fn = getattr(build.load("streamed_kernel"), symbol)
    fn.argtypes = [ctypes.POINTER(_StreamArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _set_outputs(args, outs):
    """Point t, u, v (float32) and idx, box, rows (int32) at `outs`."""
    for name, x in zip(("t", "u", "v", "idx", "box", "rows"), outs):
        setattr(args, name, x.data_ptr())


def _stream_args(o, d, t_init, scene, info):
    """The kernels' `StreamArgs` over the rays o, d (and `t_init`, unless
    None), with no outputs yet, the tables checked; and the contiguous
    rays they point at, which the caller holds until its launches are
    enqueued (a copy freed before then could be handed to the next
    allocation, whose kernels would overwrite it first)."""
    dev = o[0].device
    _check_streamed(scene, info)
    if scene.st_tris.data_ptr() % 8 or scene.st_rows.data_ptr() % 16:
        raise ValueError("st_tris must start on an 8-byte boundary and "
                         "st_rows on a 16-byte one: the kernel reads a "
                         "row's slots 8 bytes and a box 16 bytes at a time")
    n_rays = o[0].shape[0]
    f32 = torch.float32
    rays = [c.contiguous() for c in (*o, *d)]
    if t_init is not None:
        rays.append(t_init.contiguous())
    if n_rays < 1 or any(c.shape != (n_rays,) for c in rays):
        raise ValueError("o, d and t_init must hold one entry per ray, and "
                         "at least one ray")
    return _StreamArgs(
        *(build.ptr(c, f32, dev) for c in rays[:6]),
        t_init=None if t_init is None else build.ptr(rays[6], f32, dev),
        top=build.ptr(scene.st_top, f32, dev),
        sub=build.ptr(scene.st_sub, f32, dev),
        tris=build.ptr(scene.st_tris, f32, dev),
        rows_box=build.ptr(scene.st_rows, f32, dev),
        n_rays=n_rays, n_treelets=info.st_n_treelets, form=_NO_CHECK), rays


def _launch_streamed(o, d, t_init, scene, info, check_out=None):
    dev = t_init.device
    n_rays = t_init.shape[0]
    floats = torch.empty((3, n_rays), dtype=torch.float32, device=dev)
    ints = torch.empty((3, n_rays), dtype=torch.int32, device=dev)
    args, held = _stream_args(o, d, t_init, scene, info)
    outs = (*floats.unbind(0), *ints.unbind(0))
    _set_outputs(args, outs)
    if check_out is not None:
        args.check_out, args.form = check_out.data_ptr(), _PHASES
    _launch("pt_launch_streamed", args, _stream(dev))
    return outs
