"""SAH BVH builder + flattened GPU-style layout (numpy only; the port's own
copy of the JAX package's accel/bvh.py, bit for bit the same forest for the
same input).

Host-side (NumPy) rebuild of the reference's `BVH` class
(dispatch.java:1579-1842) producing the same flattened arrays the GLSL
traversal consumes:

  * node_min/node_max  — AABB slots indexed by node ID
    (BVHdata 8-float records, slots 0-5: dispatch.java:1801-1806)
  * leaf_start/leaf_end — tri-index ranges for leaves
    (BVHdata slots 6-7: dispatch.java:1794-1795)
  * left/right          — child IDs, -1 for leaves
    (BVHtree triples sorted by ID: dispatch.java:1808-1812, 1817-1833)
  * leaf_tri_indices    — concatenated leaf triangle IDs (dispatch.java:1792)
  * roots               — top-level object node IDs (objIndicesInTree,
    dispatch.java:1777)

Split rule replicated exactly (dispatch.java:1647-1752):
  3 axes x `sah_planes` uniformly spaced candidate positions over the node
  bounds; cost = halfArea(childExtent) * childTriCount summed over sides
  (infinite for an empty side); candidate accepted only if strictly better
  than the best cost seen so far INCLUDING the parent split's cost (the
  recursion passes its chosen cost down: dispatch.java:1692/1710); partition
  by centroid < pos; a child becomes a leaf when the parent depth reaches
  `max_bvh_depth` or the child has <= `max_tris_in_leaf` triangles
  (dispatch.java:1689, 1707).

Node IDs are assigned in the reference's construction order (preorder: node,
left subtree, right child, right subtree) so flattened arrays are comparable
one-to-one in parity tests.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    """Flattened scene BVH forest, ready to ship to the device."""

    node_min: np.ndarray        # (N, 3) float32
    node_max: np.ndarray        # (N, 3) float32
    leaf_start: np.ndarray      # (N,) int32 (0 for internal nodes)
    leaf_end: np.ndarray        # (N,) int32 (0 for internal nodes)
    left: np.ndarray            # (N,) int32, -1 at leaves
    right: np.ndarray           # (N,) int32, -1 at leaves
    leaf_tri_indices: np.ndarray  # (L,) int32 global triangle indices
    roots: np.ndarray           # (O,) int32 top-level object node IDs

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def max_leaf_size(self) -> int:
        sizes = self.leaf_end - self.leaf_start
        return int(sizes.max()) if sizes.size else 0


def _half_area(extent: np.ndarray) -> np.ndarray:
    """halfSurfaceArea = xy + xz + yz (dispatch.java:1748-1752)."""
    x, y, z = extent[..., 0], extent[..., 1], extent[..., 2]
    return np.abs(x * y + x * z + y * z)


class _Builder:
    """One forest of per-object BVHs sharing an ID space (reference keeps a
    global `nextBVHId`, dispatch.java:131)."""

    def __init__(self, sah_planes: int, max_depth: int, max_leaf: int):
        self.sah_planes = sah_planes
        self.max_depth = max_depth
        self.max_leaf = max_leaf
        self.node_min: List[np.ndarray] = []
        self.node_max: List[np.ndarray] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.leaf_tris: List[Optional[np.ndarray]] = []  # per-node tri IDs
        self.roots: List[int] = []

    def _new_node(self, bmin, bmax, tri_ids) -> int:
        nid = len(self.node_min)
        self.node_min.append(np.asarray(bmin, np.float32))
        self.node_max.append(np.asarray(bmax, np.float32))
        self.left.append(-1)
        self.right.append(-1)
        self.leaf_tris.append(tri_ids)
        return nid

    def add_object(self, tri_min, tri_max, centroid, tri_ids) -> int:
        """Build the BVH for one OBJ object (BVH root ctor,
        dispatch.java:1630-1646). Returns the root node ID."""
        bmin = tri_min.min(axis=0)
        bmax = tri_max.max(axis=0)
        sel = np.arange(tri_ids.shape[0])
        root = self._new_node(bmin, bmax, tri_ids[sel])
        self._split(root, tri_min, tri_max, centroid, tri_ids, sel,
                    np.inf, 0, bmin, bmax)
        self.roots.append(root)
        return root

    def _best_split(self, tri_min, tri_max, centroid, sel, bmin, bmax,
                    best_cost):
        """Evaluate 3 axes x sah_planes candidates; return
        (axis, pos, cost) of the first strictly-better candidate, or None."""
        size = bmax - bmin
        cen = centroid[sel]           # (t, 3)
        tmin = tri_min[sel]           # (t, 3)
        tmax = tri_max[sel]
        planes = (np.arange(self.sah_planes, dtype=np.float64) + 1.0) / (
            self.sah_planes + 1.0
        )
        best = (None, None, best_cost)
        for axis in range(3):
            pos = bmin[axis] + size[axis] * planes  # (P,)
            go_left = cen[None, :, axis] < pos[:, None]  # (P, t)
            n_left = go_left.sum(axis=1)
            n_right = go_left.shape[1] - n_left
            # Child bounds from tri AABBs on each side
            big = np.float32(np.inf)
            lmin = np.where(go_left[..., None], tmin[None], big).min(axis=1)
            lmax = np.where(go_left[..., None], tmax[None], -big).max(axis=1)
            rmin = np.where(~go_left[..., None], tmin[None], big).min(axis=1)
            rmax = np.where(~go_left[..., None], tmax[None], -big).max(axis=1)
            with np.errstate(invalid="ignore"):
                # empty sides produce inf-inf extents; masked right below
                lcost = np.where(
                    n_left == 0, np.inf, _half_area(lmax - lmin) * n_left
                )
                rcost = np.where(
                    n_right == 0, np.inf, _half_area(rmax - rmin) * n_right
                )
            cost = lcost + rcost
            i = int(np.argmin(cost))
            if cost[i] < best[2]:
                best = (axis, float(pos[i]), float(cost[i]))
        return best

    def _split(self, node_id, tri_min, tri_max, centroid, tri_ids, sel,
               best_cost, depth, bmin, bmax) -> bool:
        """splitTEST (dispatch.java:1647-1721) on the selection `sel`.
        Returns True if children were created (node is internal)."""
        axis, pos, cost = self._best_split(
            tri_min, tri_max, centroid, sel, bmin, bmax, best_cost
        )
        if axis is None:
            return False  # no improving split: node stays a leaf

        go_left = centroid[sel, axis] < pos
        n_left = int(go_left.sum())
        if n_left == 0 or n_left == sel.shape[0]:
            return False  # degenerate partition: node stays a leaf

        self.leaf_tris[node_id] = None  # node is now internal
        first = True
        for side_mask in (go_left, ~go_left):
            side = sel[side_mask]
            smin = tri_min[side].min(axis=0)
            smax = tri_max[side].max(axis=0)
            child = self._new_node(smin, smax, None)
            if first:
                self.left[node_id] = child
                first = False
            else:
                self.right[node_id] = child
            is_leaf = (
                depth >= self.max_depth or side.shape[0] <= self.max_leaf
            )
            if not is_leaf:
                is_leaf = not self._split(
                    child, tri_min, tri_max, centroid, tri_ids, side,
                    cost, depth + 1, smin, smax,
                )
            if is_leaf:
                self.leaf_tris[child] = tri_ids[side]
        return True

    def finish(self) -> BVHArrays:
        n = len(self.node_min)
        leaf_start = np.zeros(n, np.int32)
        leaf_end = np.zeros(n, np.int32)
        left = np.asarray(self.left, np.int32)
        right = np.asarray(self.right, np.int32)
        # Emit leaf tri indices in flatten (preorder) order
        # (flattenBVH: dispatch.java:1786-1816). Node IDs were assigned in
        # preorder, so ascending ID order IS preorder.
        chunks: List[np.ndarray] = []
        cursor = 0
        for nid in range(n):
            if left[nid] == -1 and right[nid] == -1:
                tris = self.leaf_tris[nid]
                assert tris is not None
                leaf_start[nid] = cursor
                cursor += tris.shape[0]
                leaf_end[nid] = cursor
                chunks.append(tris.astype(np.int32))
        leaf_tri_indices = (
            np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
        )
        return BVHArrays(
            node_min=np.stack(self.node_min).astype(np.float32)
            if n
            else np.zeros((0, 3), np.float32),
            node_max=np.stack(self.node_max).astype(np.float32)
            if n
            else np.zeros((0, 3), np.float32),
            leaf_start=leaf_start,
            leaf_end=leaf_end,
            left=left,
            right=right,
            leaf_tri_indices=leaf_tri_indices,
            roots=np.asarray(self.roots, np.int32),
        )


def build_forest(
    v1: np.ndarray,
    v2: np.ndarray,
    v3: np.ndarray,
    object_ranges,
    sah_planes: int = 5,
    max_depth: int = 256,
    max_leaf: int = 1,
) -> BVHArrays:
    """Build one BVH per object (triangle index range) over shared triangle
    arrays; mirrors per-object `new BVH(start, end)` calls during OBJ parsing
    (dispatch.java:913, 996).

    object_ranges: iterable of (start, end) global triangle index ranges.
    """
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    v3 = np.asarray(v3, np.float64)
    tri_min = np.minimum(np.minimum(v1, v2), v3)
    tri_max = np.maximum(np.maximum(v1, v2), v3)
    centroid = (v1 + v2 + v3) / 3.0
    builder = _Builder(sah_planes, max_depth, max_leaf)
    for start, end in object_ranges:
        ids = np.arange(start, end, dtype=np.int32)
        builder.add_object(
            tri_min[start:end], tri_max[start:end], centroid[start:end], ids
        )
    return builder.finish()
