"""The packed scene the renderer reads, in layouts chosen for the GPU.

One row per primitive, so a thread reads a triangle, an attribute record,
a node or a material with one base address (the JAX package's 128-lane
rows exist only because Mosaic needs static lane offsets):

  tris      (T, 9)  f32  v1, e1 = v2 - v1, e2 = v3 - v1, by triangle id
  attr      (T, 10) f32  n1, n2, n3, 2*mat + smooth, by triangle id
  uvt       (T, 10) f32  uv1, uv2, uv3, raw UV-space tangent, has_uv
  materials (M, 48) f32  scene/material.COL layout
  ell_tab   (E, 17) f32  centre, stretch, radius, mat, R (row-major)
  imp_tab   (I, 17) f32  shift, scale, pad, mat, R (row-major)
  ell_flags (E,)    i32  1 where the ellipsoid is rotated
  imp_info  (I, 2)  i32  function id (1..10), rotated flag
  atlas     (N, 3)  f32  every material-map texel, one image after another
  slots     (S, 3)  i32  per atlas image: h, w, texel offset
  mat_maps  (M, 9)  i32  atlas slot of each MAP_CHANNELS map, -1 if none
  sky       (h*w, 3) f32 texture 0, the equirect sky
  legacy_mats (max(Ml, 1), 18) f32  Scene.add_mat's legacy records, one
                         zero row when there are none

and the SAH forest (accel/bvh.py), one BVH per object:

  nodes_f   (N, 8)  f32  AABB min xyz, max xyz, two pads
  nodes_i   (N, 4)  i32  left, right (-1 at a leaf), first row of the
                         leaf in wf_tris, triangles in the leaf
  wf_tris   (T, 9)  f32  the rows of `tris` in leaf order, so a leaf is
                         a contiguous run
  wf_perm   (T,)    i32  wf_tris row -> triangle id
  tri_obj   (T,)    i32  triangle id -> root node of its object
  roots     (O,)    i32  root node of each object
  nodes_w   (I, 16) i32  the walk's table (`walk_records`): one 64-byte
                         record per inner node, in node order, holding
                         both children's boxes (float bits, as nodes_f
                         has them) and their links
  root_links (O, 2) i32  each object's root as a link

A link is (record, 0) for an inner node and (-1 - first wf_tris row,
triangles) for a leaf, so a leaf needs no record of its own.

or, for a scene of more than `config.stream_threshold` triangles, no SAH
forest (`info.num_objects` is 0 and `tri_obj` holds the object's ordinal)
but the streamed two-level LBVH (accel/lbvh.py), `info.streamed`:

  st_top    (2n-1, 8)    f32  top-tree boxes in heap order, n treelets
  st_sub    (64 n, 8)    f32  each treelet's 63 subtree boxes in heap
                              order and one pad
  st_tris   (1792 n, 9)  f32  v1, e1, e2 by slot: 128 rows of 14 to a
                              treelet, empty slots zero
  st_perm   (1792 n,)    i32  slot -> triangle id, -1 where empty
  st_rows   (128 n, 8)   f32  each row's box as st_top's (`row_boxes`), the
                              walk's cull inside a group; empty rows
                              inverted (+inf, -inf)

One box or triangle per row, as above: the JAX package's 128-lane rows and
its ways of rebuilding these tables on the device spare its narrow host
link and are not carried over. Only its size policy is: a scene streams
when it has more than `stream_threshold` triangles (so `stream_threshold =
0` streams any mesh). Its other reasons to stream (forests its packet
kernel cannot hold) gate limits the forest kernels here do not have.

Empty tables keep one zero row so every pointer handed to a kernel is
valid; the real counts live in SceneInfo.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..accel import bvh as bvh_mod
from ..accel import lbvh
from ..core.device import resolve_device
from .material import COL, pack_materials

# Largest triangle count of the brute-force frame path (the JAX package's
# FUSED_MAX_TRIS).
MAX_TRIS = 2048
MAX_MATERIALS = 32
# The per-ray traversal stack csrc/forest_kernel.cu is built with (its
# STACK); a forest whose leaves lie deeper than this less one is refused at
# pack time.
TRAVERSE_MAX_STACK = 264
# The per-ray stack csrc/streamed_kernel.cu is built with (its STACK): the
# walk of the top tree and of one treelet's subtree holds at most one node
# per level and one more; a deeper tree is refused at pack time.
STREAM_MAX_STACK = 32
# Map channels the integrators read, in the column order of `mat_maps`
# (csrc/pathtrace.cuh MAP_* indices follow it).
MAP_CHANNELS = ("map_Ka", "map_Kd", "map_Ks", "map_Ke", "map_Tr",
                "map_Pm", "map_Pr", "map_Pc", "map_norm")
# Channels a material can bind (the JAX package's order, which fixes the
# order in which atlas slots are assigned).
_MAP_NAMES = ("map_Ka", "map_Kd", "map_Ks", "map_Ke", "map_d", "map_Tr",
              "map_Ns", "map_Pm", "map_Pr", "map_Ps", "map_Pc")
_BIND_CHANNELS = _MAP_NAMES + ("map_norm",)


class SceneInfo(NamedTuple):
    """Static facts about a packed scene (counts and gates)."""

    num_tris: int
    num_ellipsoids: int
    num_implicits: int
    num_materials: int
    mat_gates: tuple        # subsurface, clearcoat, Tr/Tf, illum 5/7, Ke
    ell_rotated: tuple
    imp_rotated: tuple
    imp_fn_ids: tuple
    map_bindings: tuple     # (channel, material, atlas slot)
    map_shapes: tuple       # per atlas slot: (h, w, texel offset)
    sky_shape: tuple        # (h, w)
    num_objects: int = 0    # roots of the forest
    num_leaves: int = 0
    max_leaf_size: int = 0  # most triangles in one leaf
    forest_depth: int = 0   # deepest leaf, a root being at depth 0
    any_uv: bool = False
    any_smooth: bool = False
    streamed: bool = False  # the streamed LBVH instead of the forest
    st_n_treelets: int = 0
    st_treelet_rows: int = 0
    st_leaf_cap: int = 0    # triangle slots in a row
    num_tri_objects: int = 0  # objects of triangles (streamed or not)
    n_legacy_mats: int = 0  # records of Scene.add_mat
    # the legacy disk lights (Scene.add_disk_light): (kind, id_start,
    # id_end, material) of each, its centre and its radius
    lights: tuple = ()
    light_centers: tuple = ()
    light_radii: tuple = ()


@dataclasses.dataclass
class PackedScene:
    """Tensors of one scene on one device (see the module docstring)."""

    tris: torch.Tensor
    attr: torch.Tensor
    uvt: torch.Tensor
    materials: torch.Tensor
    ell_tab: torch.Tensor
    imp_tab: torch.Tensor
    ell_flags: torch.Tensor
    imp_info: torch.Tensor
    atlas: torch.Tensor
    slots: torch.Tensor
    mat_maps: torch.Tensor
    sky: torch.Tensor
    nodes_f: torch.Tensor
    nodes_i: torch.Tensor
    wf_tris: torch.Tensor
    wf_perm: torch.Tensor
    tri_obj: torch.Tensor
    roots: torch.Tensor
    nodes_w: torch.Tensor
    root_links: torch.Tensor
    st_top: torch.Tensor
    st_sub: torch.Tensor
    st_tris: torch.Tensor
    st_perm: torch.Tensor
    st_rows: torch.Tensor
    legacy_mats: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.materials.device


def rotmat_np(rot) -> np.ndarray:
    """float32 R = Rz @ Ry @ Rx, computed as the JAX package's packer does
    so the primitive tables agree bit for bit."""
    rx, ry, rz = [np.float32(v) for v in rot]
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return np.array([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ], np.float32)


def mat_gates(mats: np.ndarray, maps_present) -> tuple:
    """Which lobe families any material can reach (the kernel skips the
    others; results do not depend on it)."""
    m = mats if mats.shape[0] else np.zeros((1, 48), np.float32)
    return (
        bool((m[:, 41] > 0).any()),
        bool((m[:, 27] > 0).any() or "map_Pc" in maps_present),
        bool((m[:, 11] > 0).any() or (m[:, 12:15] > 0).any()
             or "map_Tr" in maps_present),
        bool(np.isin(m[:, 20], (5.0, 7.0)).any()),
        bool((m[:, 16:19] != 0).any() or "map_Ke" in maps_present),
    )


# the empty implicit table's row keeps a unit scale (the JAX package's)
_IMP_PLACEHOLDER = np.zeros((1, 17), np.float32)
_IMP_PLACEHOLDER[:, 3:6] = 1.0


def _pad1(a: np.ndarray) -> np.ndarray:
    return a if a.shape[0] else np.zeros((1,) + a.shape[1:], a.dtype)


def _mat_maps(bindings, n_mats: int) -> np.ndarray:
    out = np.full((max(n_mats, 1), len(MAP_CHANNELS)), -1, np.int32)
    for ch, mid, slot in bindings:
        if ch in MAP_CHANNELS:
            out[mid, MAP_CHANNELS.index(ch)] = slot
    return out


def _check_material_ids(n_mats, attr, ell_tab, imp_tab):
    """Every primitive must name a material of the table: the kernel
    reads the record without a bounds check."""
    ids = np.concatenate([np.floor(np.asarray(attr)[:, 9] * 0.5),
                          np.asarray(ell_tab)[:, 7], np.asarray(imp_tab)[:, 7]])
    if ids.size and (ids.min() < 0 or ids.max() >= n_mats):
        raise ValueError(f"material id out of range [0, {n_mats}): "
                         f"{sorted(set(ids.astype(int).tolist()))}")


def forest_depth(left, right, roots) -> int:
    """Depth of the deepest leaf, a root being at depth 0."""
    deepest, todo = 0, [(int(r), 0) for r in roots]
    while todo:
        node, depth = todo.pop()
        if left[node] < 0:
            deepest = max(deepest, depth)
        else:
            todo += [(int(left[node]), depth + 1),
                     (int(right[node]), depth + 1)]
    return deepest


_NO_FOREST = bvh_mod.BVHArrays(
    node_min=np.zeros((0, 3), np.float32),
    node_max=np.zeros((0, 3), np.float32),
    leaf_start=np.zeros(0, np.int32), leaf_end=np.zeros(0, np.int32),
    left=np.zeros(0, np.int32), right=np.zeros(0, np.int32),
    leaf_tri_indices=np.zeros(0, np.int32), roots=np.zeros(0, np.int32))


def stream_stack_need(n_treelets: int) -> int:
    """Most nodes the streamed walk holds at once: one per level of the
    top tree and of a treelet's subtree, and one more."""
    n_groups = lbvh.TREELET_ROWS // lbvh.SUB_GROUP_ROWS
    return (n_treelets.bit_length() - 1) + (n_groups.bit_length() - 1) + 1


def row_boxes(tris: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """(R, 8) float32: the box of each row of 14 slots of `tris` (R * 14,
    9), min xyz, max xyz, two zero pads, over the vertices of its slots as
    the slot test sees them, v1, v1 + e1 and v1 + e2, widened by one ulp
    outward (the test's vertex v1 + e1 lies within half an ulp of the
    rounded sum). A slot whose `perm` is -1 is empty and left out; a row
    with no slot has the inverted box (+inf, -inf), which the walk
    refuses."""
    per = lbvh.TRIS_PER_ROW
    t = np.asarray(tris, np.float32).reshape(-1, per, 9)
    live = (np.asarray(perm).reshape(-1, per) >= 0)[..., None]
    v1 = t[..., 0:3]
    lo = np.full((t.shape[0], 3), np.inf, np.float32)
    hi = np.full((t.shape[0], 3), -np.inf, np.float32)
    for v in (v1, v1 + t[..., 3:6], v1 + t[..., 6:9]):
        lo = np.minimum(lo, np.where(live, v, np.inf).min(1))
        hi = np.maximum(hi, np.where(live, v, -np.inf).max(1))
    full = live.any(1)
    out = np.zeros((t.shape[0], 8), np.float32)
    out[:, 0:3] = np.where(full, np.nextafter(lo, np.float32(-np.inf)), lo)
    out[:, 3:6] = np.where(full, np.nextafter(hi, np.float32(np.inf)), hi)
    return out


def _streamed_tables(sf, n_tri, object_ranges):
    """The streamed LBVH's device tables from a StreamedForest, or their
    one-row placeholders from None; `tri_obj` then is not theirs."""
    if sf is None:
        return dict(st_top=np.zeros((1, 8), np.float32),
                    st_sub=np.zeros((1, 8), np.float32),
                    st_tris=np.zeros((1, 9), np.float32),
                    st_perm=np.full(1, -1, np.int32),
                    st_rows=np.zeros((1, 8), np.float32))
    need = stream_stack_need(sf.n_treelets)
    if need > STREAM_MAX_STACK:
        raise ValueError(
            f"the streamed tree of {sf.n_treelets} treelets needs a stack "
            f"of {need}; the kernel has {STREAM_MAX_STACK}")
    tri_obj = np.full(max(n_tri, 1), -1, np.int32)
    for k, (start, end) in enumerate(object_ranges):
        tri_obj[start:end] = k
    return dict(st_top=sf.ctree_f, st_sub=sf.sub_f, st_tris=sf.tris,
                st_perm=sf.row_perm, st_rows=row_boxes(sf.tris, sf.row_perm),
                tri_obj=tri_obj)


def _forest_tables(forest, tris, object_ranges):
    """The forest's device tables (module docstring) from BVHArrays."""
    n = forest.num_nodes
    nodes_f = np.zeros((max(n, 1), 8), np.float32)
    nodes_i = np.full((max(n, 1), 4), -1, np.int32)
    nodes_f[:n, 0:3] = forest.node_min
    nodes_f[:n, 3:6] = forest.node_max
    nodes_i[:n, 0] = forest.left
    nodes_i[:n, 1] = forest.right
    nodes_i[:n, 2] = forest.leaf_start
    nodes_i[:n, 3] = forest.leaf_end - forest.leaf_start
    perm = np.asarray(forest.leaf_tri_indices, np.int32)
    tri_obj = np.full(max(tris.shape[0], 1), -1, np.int32)
    for (start, end), root in zip(object_ranges, forest.roots):
        tri_obj[start:end] = root
    nodes_w, root_links = walk_records(nodes_f, nodes_i, forest.roots)
    return dict(nodes_f=nodes_f, nodes_i=nodes_i, wf_tris=_pad1(tris[perm]),
                wf_perm=_pad1(perm), tri_obj=tri_obj,
                roots=_pad1(np.asarray(forest.roots, np.int32)),
                nodes_w=nodes_w, root_links=root_links)


def walk_records(nodes_f, nodes_i, roots):
    """(nodes_w, root_links) from the forest's nodes_f and nodes_i (module
    docstring): record k is the k-th inner node in node order; its words
    0-5 are the left child's nodes_f row 0-5 and 6-11 the right child's,
    bit for bit, 12-13 the left child's link and 14-15 the right child's.
    One zero record and one zero link where there is no forest."""
    left, right, start, count = (nodes_i[:, k] for k in range(4))
    inner = np.flatnonzero(left >= 0)
    record = np.zeros(nodes_i.shape[0], np.int64)
    record[inner] = np.arange(inner.size)

    def links(node):
        leaf = left[node] < 0
        return np.stack([np.where(leaf, -1 - start[node], record[node]),
                         np.where(leaf, count[node], 0)], 1).astype(np.int32)

    boxes = nodes_f[:, 0:6].view(np.int32)
    kids = (left[inner], right[inner])
    nodes_w = np.concatenate([boxes[kids[0]], boxes[kids[1]],
                              links(kids[0]), links(kids[1])], 1)
    return _pad1(nodes_w), _pad1(links(np.asarray(roots, np.int64)))


def _finish(*, tris, attr, uvt, mats, ell_tab, ell_rotated, imp_tab,
            imp_rotated, imp_fn_ids, map_images, bindings, sky_img,
            maps_present, forest, object_ranges, device, streamed=None,
            legacy_mats=(), disk_lights=()):
    """Assemble (PackedScene, SceneInfo) from host arrays: over the SAH
    `forest`, or over the StreamedForest `streamed` with `forest` empty;
    `legacy_mats` the add_mat records, `disk_lights` Scene.disk_lights."""
    n_tri = tris.shape[0]
    _check_material_ids(mats.shape[0], attr, ell_tab[:len(ell_rotated)],
                        imp_tab[:len(imp_rotated)])
    depth = forest_depth(forest.left, forest.right, forest.roots)
    if depth + 1 > TRAVERSE_MAX_STACK:
        raise ValueError(
            f"the forest is {depth} levels deep; the traversal kernel's "
            f"stack serves {TRAVERSE_MAX_STACK - 1} (lower max_bvh_depth)")
    shapes, offset = [], 0
    for img in map_images:
        shapes.append((img.shape[0], img.shape[1], offset))
        offset += img.shape[0] * img.shape[1]
    atlas = (np.concatenate([np.asarray(i, np.float32).reshape(-1, 3)
                             for i in map_images])
             if map_images else np.zeros((1, 3), np.float32))
    n_ell, n_imp = len(ell_rotated), len(imp_rotated)
    imp_info = np.zeros((max(n_imp, 1), 2), np.int32)
    imp_info[:n_imp, 0] = imp_fn_ids
    imp_info[:n_imp, 1] = imp_rotated
    ell_flags = np.zeros(max(n_ell, 1), np.int32)
    ell_flags[:n_ell] = ell_rotated
    tris = np.asarray(tris, np.float32)
    attr = np.asarray(attr, np.float32)
    uvt = np.asarray(uvt, np.float32)
    host = dict(
        tris=_pad1(tris), attr=_pad1(attr), uvt=_pad1(uvt),
        materials=np.asarray(mats, np.float32),
        ell_tab=_pad1(np.asarray(ell_tab, np.float32)[:n_ell]),
        imp_tab=(np.asarray(imp_tab, np.float32)[:n_imp] if n_imp
                 else _IMP_PLACEHOLDER),
        ell_flags=ell_flags,
        imp_info=imp_info,
        atlas=atlas,
        slots=_pad1(np.asarray(shapes, np.int32).reshape(-1, 3)),
        mat_maps=_mat_maps(bindings, mats.shape[0]),
        sky=np.asarray(sky_img, np.float32).reshape(-1, 3),
        legacy_mats=_pad1(np.asarray(legacy_mats, np.float32)
                          .reshape(-1, 18)),
        **{**_forest_tables(forest, tris, object_ranges),
           **_streamed_tables(streamed, n_tri, object_ranges)},
    )
    scene = PackedScene(**{k: torch.tensor(v, device=device)
                           for k, v in host.items()})
    is_leaf = forest.left < 0
    info = SceneInfo(
        num_tris=n_tri, num_ellipsoids=n_ell, num_implicits=n_imp,
        num_materials=int(mats.shape[0]),
        mat_gates=mat_gates(mats, maps_present),
        ell_rotated=tuple(bool(x) for x in ell_rotated),
        imp_rotated=tuple(bool(x) for x in imp_rotated),
        imp_fn_ids=tuple(int(x) for x in imp_fn_ids),
        map_bindings=tuple(tuple(b) for b in bindings),
        map_shapes=tuple(shapes),
        sky_shape=(int(sky_img.shape[0]), int(sky_img.shape[1])),
        num_objects=int(forest.roots.shape[0]),
        num_leaves=int(is_leaf.sum()),
        max_leaf_size=forest.max_leaf_size(),
        forest_depth=depth,
        any_uv=bool((uvt[:, 9] > 0).any()),
        any_smooth=bool((attr[:, 9] % 2 > 0).any()),
        streamed=streamed is not None,
        st_n_treelets=streamed.n_treelets if streamed else 0,
        st_treelet_rows=lbvh.TREELET_ROWS if streamed else 0,
        st_leaf_cap=lbvh.TRIS_PER_ROW if streamed else 0,
        num_tri_objects=len(object_ranges),
        n_legacy_mats=len(legacy_mats),
        lights=tuple((int(k), int(s0), int(e0), int(m))
                     for k, s0, e0, m, _, _ in disk_lights),
        light_centers=tuple(tuple(float(x) for x in c)
                            for _, _, _, _, c, _ in disk_lights),
        light_radii=tuple(float(r) for *_, r in disk_lights),
    )
    return scene, info


def _attr_rows(n1, n2, n3, mat, smooth) -> np.ndarray:
    attr = np.zeros((n1.shape[0], 10), np.float32)
    attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = n1, n2, n3
    attr[:, 9] = (2.0 * np.asarray(mat, np.float32)
                  + np.asarray(smooth, np.float32))
    return attr


def _uvt_rows(e1, e2, uv1, uv2, uv3, has_uv) -> np.ndarray:
    """UV rows with the raw UV-space tangent (frag.glsl:421-439 before
    Gram-Schmidt) of float32 edges e1, e2; zero where it is not finite."""
    uvt = np.zeros((e1.shape[0], 10), np.float32)
    uvt[:, 0:2], uvt[:, 2:4], uvt[:, 4:6] = uv1, uv2, uv3
    du1, du2 = uv2 - uv1, uv3 - uv1
    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        traw = (du2[:, 1:2] * e1 - du1[:, 1:2] * e2) / det[:, None]
    has_uv = np.asarray(has_uv) > 0
    ok = has_uv & np.isfinite(traw).all(axis=1)
    uvt[ok, 6:9] = traw[ok]
    uvt[:, 9] = has_uv
    return uvt


def _column(scene, name, width, dtype):
    """Per-triangle column: loose triangles first, then the bulk meshes
    in the order they were added (the JAX package's packing order)."""
    parts = []
    if len(scene.tris):
        col = getattr(scene.tris, name)
        parts.append(np.stack(col) if width else np.asarray(col))
    parts += [bm[name] for bm in scene.bulk_meshes]
    if parts:
        return np.concatenate(parts).astype(dtype)
    return np.zeros((0, width) if width else (0,), dtype)


def pack_scene(scene, device, config, max_leaf=None):
    """Pack a `Scene` (scene/scene.py) onto `device`: one BVH per object
    (an OBJ group, a loose triangle, a bulk mesh) built with `config`'s
    `sah_planes`, `max_bvh_depth` and `max_tris_in_leaf` (or `max_leaf`);
    past `config.stream_threshold` triangles the streamed LBVH over all of
    them, in the median-split order of the native builder."""
    v1 = _column(scene, "v1", 3, np.float64)
    v2 = _column(scene, "v2", 3, np.float64)
    v3 = _column(scene, "v3", 3, np.float64)
    n_tri = v1.shape[0]
    object_ranges = list(scene.tris.object_ranges)
    ofs = len(scene.tris)
    for bm in scene.bulk_meshes:
        object_ranges.append((ofs, ofs + bm["v1"].shape[0]))
        ofs += bm["v1"].shape[0]
    if n_tri > config.stream_threshold:
        forest, streamed = _NO_FOREST, lbvh.build_streamed(v1, v2, v3)
    else:
        streamed = None
        forest = bvh_mod.build_forest(
            v1, v2, v3, object_ranges, sah_planes=config.sah_planes,
            max_depth=config.max_bvh_depth,
            max_leaf=(config.max_tris_in_leaf if max_leaf is None
                      else max_leaf))
    tris = np.concatenate([v1, v2 - v1, v3 - v1], axis=1).astype(np.float32)
    attr = _attr_rows(*(_column(scene, k, 3, np.float32)
                        for k in ("n1", "n2", "n3")),
                      _column(scene, "mat", 0, np.float32),
                      _column(scene, "has_smooth", 0, np.float32))
    uvt = _uvt_rows((v2 - v1).astype(np.float32),
                    (v3 - v1).astype(np.float32),
                    *(_column(scene, f"uv{k}", 2, np.float32)
                      for k in (1, 2, 3)),
                    _column(scene, "has_uv", 0, np.float32))

    n_ell = len(scene.ell_rad)
    ell_tab = np.zeros((n_ell, 17), np.float32)
    ell_rotated = []
    for e in range(n_ell):
        rot = np.asarray(scene.ell_rot[e], np.float32)
        ell_tab[e, 0:3] = np.asarray(scene.ell_c[e], np.float32)
        ell_tab[e, 3:6] = np.asarray(scene.ell_stretch[e], np.float32)
        ell_tab[e, 6] = np.float32(scene.ell_rad[e])
        ell_tab[e, 7] = np.float32(scene.ell_mat[e])
        ell_tab[e, 8:17] = rotmat_np(rot).reshape(9)
        ell_rotated.append(bool(np.any(rot != 0)))
    n_imp = len(scene.imp_fn)
    imp_tab = np.zeros((n_imp, 17), np.float32)
    imp_tab[:, 3:6] = 1.0
    imp_rotated = []
    for k in range(n_imp):
        rot = np.asarray(scene.imp_rot[k], np.float32)
        imp_tab[k, 0:3] = np.asarray(scene.imp_shift[k], np.float32)
        imp_tab[k, 3:6] = np.asarray(scene.imp_scale[k], np.float32)
        imp_tab[k, 7] = np.float32(scene.imp_mat[k])
        imp_tab[k, 8:17] = rotmat_np(rot).reshape(9)
        imp_rotated.append(bool(np.any(rot != 0)))

    mats = pack_materials(scene.materials)
    images = scene.textures.images
    maps_present = tuple(nm for nm in _MAP_NAMES
                         if mats.shape[0]
                         and bool((mats[:, COL[nm]] >= 0).any()))
    slot_of, bindings = {}, []
    for mi in range(mats.shape[0]):
        for ch in _BIND_CHANNELS:
            ti = int(mats[mi, COL[ch]])
            if ti < 0:
                continue
            if ti >= len(images):
                raise ValueError(
                    f"material {mi} {ch} names texture {ti}, but only "
                    f"{len(images)} are registered")
            slot_of.setdefault(ti, len(slot_of))
            bindings.append((ch, mi, slot_of[ti]))
    map_images = [images[ti] for ti in sorted(slot_of, key=slot_of.get)]
    sky = images[0] if images else np.full((1, 1, 3), 0.5, np.float32)
    return _finish(
        tris=tris, attr=attr, uvt=uvt, mats=mats, ell_tab=ell_tab,
        ell_rotated=ell_rotated, imp_tab=imp_tab, imp_rotated=imp_rotated,
        imp_fn_ids=[int(f) for f in scene.imp_fn], map_images=map_images,
        bindings=bindings, sky_img=sky, maps_present=maps_present,
        forest=forest, object_ranges=object_ranges, device=device,
        streamed=streamed, legacy_mats=scene.legacy_mats,
        disk_lights=scene.disk_lights)


def _unpack_rows(rows: np.ndarray, per_row: int, stride: int) -> np.ndarray:
    """(L, 128) lane rows holding `per_row` records of `stride` floats ->
    (L * per_row, stride)."""
    return np.ascontiguousarray(
        rows[:, :per_row * stride].reshape(-1, stride))


def scene_from_numpy(arrays: dict, info: dict, device=None):
    """Carry a scene built by the JAX package across to the port.

    `arrays` holds that package's DeviceScene fields as numpy arrays and
    `info` its StaticSceneInfo fields as a plain dict. Always needed:
    materials, ell_tab, imp_tab, tex_data, tex_sizes, fs_maps. Then either

      * the forest and the triangle columns (node_min, node_max, node_left,
        node_right, leaf_start, leaf_end, leaf_tri, roots, tri_v1..tri_v3,
        tri_n1..tri_n3, tri_uv1..tri_uv3, tri_has_uv, tri_has_smooth,
        tri_mat, tri_obj): triangles keep their ids and the port walks the
        very forest the JAX package built; or
      * the dense tables of its fused path alone (fs_tris, fs_attr,
        fs_uvt): triangles come in that package's BVH leaf order and the
        port builds a forest of its own over them, as one object.

    A streamed scene of that package (info["streamed"]) comes with its
    triangle columns as above and its LBVH tables (st_top, st_tris, st_sub,
    st_perm), which are carried into the port's layouts: the port then
    walks the very tree the JAX package built.

    Material maps come across where that package packed them for its fused
    path (fs_maps); the legacy records (legacy_mats, n_legacy_mats) and
    disk lights (lights, light_centers, light_radii) where given. The
    tables land on `device`: the card unless the caller passes
    device="cpu" (core/device.resolve_device; without a card that
    raises). Returns (PackedScene, SceneInfo).
    """
    device = resolve_device(device)
    def f32(key):
        return np.asarray(arrays[key], np.float32)

    streamed = None
    is_streamed = bool(info.get("streamed"))
    if is_streamed or ("node_min" in arrays and int(info["num_objects"])):
        v1, v2, v3 = f32("tri_v1"), f32("tri_v2"), f32("tri_v3")
        tris = np.concatenate([v1, v2 - v1, v3 - v1], axis=1)
        attr = _attr_rows(f32("tri_n1"), f32("tri_n2"), f32("tri_n3"),
                          arrays["tri_mat"], arrays["tri_has_smooth"])
        uvt = _uvt_rows(v2 - v1, v3 - v1, f32("tri_uv1"), f32("tri_uv2"),
                        f32("tri_uv3"), arrays["tri_has_uv"])
    if is_streamed:
        if (int(info["st_treelet_rows"]), int(info["st_leaf_cap"])) != (
                lbvh.TREELET_ROWS, lbvh.TRIS_PER_ROW):
            raise ValueError("the streamed tables were built with other "
                             "row or treelet sizes than accel/lbvh.py's")
        n_treelets = int(info["st_n_treelets"])
        st_tris = _unpack_rows(f32("st_tris"), lbvh.TRIS_PER_ROW, 9)
        streamed = lbvh.StreamedForest(
            ctree_f=f32("st_top"), tris=st_tris,
            sub_f=np.ascontiguousarray(f32("st_sub")[:, :8]),
            row_perm=np.asarray(arrays["st_perm"], np.int32),
            n_rows=-(-tris.shape[0] // lbvh.TRIS_PER_ROW),
            n_treelets=n_treelets,
            leaf_depth=(n_treelets * lbvh.TREELET_ROWS).bit_length() - 1)
        forest = _NO_FOREST
        # objects are contiguous id ranges; tri_obj holds their ordinals
        tri_obj = np.asarray(arrays["tri_obj"])[:tris.shape[0]]
        starts = [0] + (np.flatnonzero(np.diff(tri_obj)) + 1).tolist()
        object_ranges = list(zip(starts, starts[1:] + [tris.shape[0]]))
    elif "node_min" in arrays and int(info["num_objects"]):
        roots = np.asarray(arrays["roots"], np.int32)
        forest = bvh_mod.BVHArrays(
            node_min=f32("node_min"), node_max=f32("node_max"),
            leaf_start=np.asarray(arrays["leaf_start"], np.int32),
            leaf_end=np.asarray(arrays["leaf_end"], np.int32),
            left=np.asarray(arrays["node_left"], np.int32),
            right=np.asarray(arrays["node_right"], np.int32),
            leaf_tri_indices=np.asarray(arrays["leaf_tri"], np.int32),
            roots=roots)
        # objects are contiguous id ranges, in the order of their roots
        tri_obj = np.asarray(arrays["tri_obj"])
        starts = [int(np.flatnonzero(tri_obj == r)[0]) for r in roots]
        object_ranges = list(zip(starts, starts[1:] + [tris.shape[0]]))
    else:
        fs_tris = np.asarray(arrays["fs_tris"], np.float32)
        if fs_tris.shape[0] > 1:
            tris = _unpack_rows(fs_tris, 14, 9)
            live = np.flatnonzero(np.any(tris != 0.0, axis=1))
            n_tri = int(live[-1]) + 1 if live.size else 0
            tris = tris[:n_tri]
            attr = _unpack_rows(np.asarray(arrays["fs_attr"], np.float32),
                                12, 10)[:n_tri]
            fs_uvt = np.asarray(arrays["fs_uvt"], np.float32)
            uvt = (_unpack_rows(fs_uvt, 12, 10)[:n_tri]
                   if fs_uvt.shape[0] > 1
                   else np.zeros((n_tri, 10), np.float32))
        else:
            tris = np.zeros((0, 9), np.float32)
            attr = np.zeros((0, 10), np.float32)
            uvt = np.zeros((0, 10), np.float32)
        object_ranges = [(0, tris.shape[0])] if tris.shape[0] else []
        forest = bvh_mod.build_forest(
            tris[:, 0:3], tris[:, 0:3] + tris[:, 3:6],
            tris[:, 0:3] + tris[:, 6:9], object_ranges,
            max_leaf=max(int(info.get("max_leaf_size", 1)), 1))
    fs_maps = np.asarray(arrays["fs_maps"], np.float32)
    map_images = []
    for h, w, base, rpy in info.get("fs_map_shapes", ()):
        block = fs_maps[base:base + h * rpy].reshape(h, rpy * 128)
        map_images.append(block[:, :w * 3].reshape(h, w, 3))
    tex_data = np.asarray(arrays["tex_data"], np.float32)
    sh, sw = (int(x) for x in np.asarray(arrays["tex_sizes"])[0])
    mats = np.asarray(arrays["materials"], np.float32)
    n_ell = int(info["num_ellipsoids"])
    n_imp = int(info["num_implicits"])
    maps_present = tuple(info.get("maps_present", ()))
    n_legacy = int(info.get("n_legacy_mats", 0))
    return _finish(
        tris=tris, attr=attr, uvt=uvt, mats=mats,
        ell_tab=np.asarray(arrays["ell_tab"], np.float32),
        ell_rotated=tuple(info["ell_rotated"])[:n_ell],
        imp_tab=np.asarray(arrays["imp_tab"], np.float32),
        imp_rotated=tuple(info["imp_rotated"])[:n_imp],
        imp_fn_ids=tuple(info["imp_fn_ids"])[:n_imp],
        map_images=map_images,
        bindings=tuple(info.get("fs_map_bindings", ())),
        sky_img=tex_data[0, :sh, :sw], maps_present=maps_present,
        forest=forest, object_ranges=object_ranges, device=device,
        streamed=streamed,
        legacy_mats=np.asarray(arrays["legacy_mats"], np.float32)[:n_legacy]
        if n_legacy else (),
        disk_lights=[(*light, center, radius) for light, center, radius
                     in zip(info.get("lights", ()),
                            info.get("light_centers", ()),
                            info.get("light_radii", ()))])
