"""The two-level LBVH of large scenes, built on the host with NumPy or by
the native builder (accel/native_lbvh.py).

Own copy of the JAX package's accel/lbvh.py, with the port's table
layouts. The SAH builder (accel/bvh.py) recurses in Python per node, hours
at millions of triangles; this one is a sort and a few reductions:

  1. order the triangles so that neighbours in space are neighbours in
     memory: by the Morton code of their centroids (21 bits an axis), or
     by the balanced median split of the native builder;
  2. pack the order densely into rows of TRIS_PER_ROW triangles;
  3. put ONE implicit complete binary tree over the rows, their number
     padded to a power of two: the children of node i are 2i+1 and 2i+2,
     and the boxes come bottom-up, a level at a time.

The tree is cut at the level of *treelets*, TREELET_ROWS consecutive rows:
above the cut the top tree (`ctree_f`, 2 * n_treelets - 1 boxes in heap
order, its leaves the treelets), below it each treelet's own complete
subtree (`sub_f`) over groups of SUB_GROUP_ROWS rows. The four constants
fix the topology, which triangles share a row, a group and a treelet, so
that this package and the JAX package build the same tree and a hit's
`idx = row * TRIS_PER_ROW + slot` means the same triangle in both.

Empty rows and nodes carry inverted boxes (min = +inf, max = -inf) and
empty triangle slots zeroed edges, whose determinant is 0, so padding
masks itself (kernels/wavefront.py refuses a box whose min exceeds its
max, since inf * finite passes a bare slab test).

The Morton order with the complete-tree topology is the classic LBVH
(Lauterbach et al.); the median-split order bounds an actual object-median
partition at every node and so has tighter boxes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TRIS_PER_ROW = 14
MORTON_BITS = 21       # bits an axis: 63-bit codes, the 64-bit maximum
TREELET_ROWS = 128
SUB_GROUP_ROWS = 4     # rows under one leaf of a treelet's subtree
# triangle order -> mode of csrc/streambuild.cpp
MODES = {"morton": 0, "median": 1}


class StreamedForest(NamedTuple):
    """The streamed forest's host tables."""

    ctree_f: np.ndarray   # (2 * n_treelets - 1, 8) f32 top-tree boxes in
                          #   heap order: min xyz, max xyz, two pads
    tris: np.ndarray      # (R_pad * TRIS_PER_ROW, 9) f32 v1, e1, e2 by slot
    sub_f: np.ndarray     # (n_treelets * sub_stride, 8) f32: each treelet's
                          #   subtree boxes in heap order. The subtree has
                          #   TREELET_ROWS / SUB_GROUP_ROWS leaves; heap
                          #   node k >= n_groups - 1 covers the rows
                          #   [g * SUB_GROUP_ROWS, (g + 1) * SUB_GROUP_ROWS)
                          #   of the treelet, g = k - (n_groups - 1).
                          #   sub_stride = 2 * n_groups (one pad node)
    row_perm: np.ndarray  # (R_pad * TRIS_PER_ROW,) i32 slot -> triangle id
                          #   (-1 for padding)
    n_rows: int           # rows that hold triangles
    n_treelets: int       # R_pad / TREELET_ROWS, a power of two
    leaf_depth: int       # levels from the root down to single rows


def morton_codes(centroids: np.ndarray,
                 bits: int = MORTON_BITS) -> np.ndarray:
    """3*bits-bit Morton codes of centroid positions (bits <= 21),
    normalized to their bounding box in float64 and quantized in float32
    (exact for cells of at most 21 bits)."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    norm = ((centroids - lo) / span).astype(np.float32)
    q = np.clip(norm * np.float32(2 ** bits - 1), 0,
                2 ** bits - 1).astype(np.uint64)

    def spread(v):
        # two zero bits between each of the 21 input bits
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (spread(q[:, 0]) << np.uint64(2)) | (
        spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def shape(t: int):
    """(rows that hold triangles, treelets, padded rows) for t triangles:
    rows padded to whole treelets, treelets to a power of two."""
    n_rows = -(-t // TRIS_PER_ROW)
    n_treelets = max(-(-n_rows // TREELET_ROWS), 1)
    n_treelets = 1 << int(np.ceil(np.log2(n_treelets)))
    return n_rows, n_treelets, n_treelets * TREELET_ROWS


def build_streamed(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray,
                   order: str = "median") -> StreamedForest:
    """Build the streamed forest over T >= 1 triangles ((T, 3) each).

    order "median": the balanced median-split order, which only the
    native builder makes; it raises RuntimeError if that cannot be built.
    order "morton": the Morton order, by the native builder where it can
    be built, else by `_build_streamed_numpy`; the two are bit-equal."""
    from . import native_lbvh

    if order not in MODES:
        raise ValueError(f"order must be one of {tuple(MODES)}, "
                         f"not {order!r}")
    if v1.shape[0] < 1:
        raise ValueError("the streamed forest needs at least one triangle")
    if order == "median" or native_lbvh.available():
        return native_lbvh.build_streamed(v1, v2, v3, mode=MODES[order])
    return _build_streamed_numpy(v1, v2, v3)


def _build_streamed_numpy(v1: np.ndarray, v2: np.ndarray,
                          v3: np.ndarray) -> StreamedForest:
    """The Morton-order build in vectorized NumPy."""
    t = v1.shape[0]
    centroids = (v1 + v2 + v3) / 3.0
    order = np.argsort(morton_codes(centroids),
                       kind="stable").astype(np.int64)
    sa = v1[order].astype(np.float32)
    sb = v2[order].astype(np.float32)
    sc_ = v3[order].astype(np.float32)

    n_rows, n_treelets, r_pad = shape(t)

    # --- dense packing by slot (pad, no scatters) --------------------------
    t_pad = n_rows * TRIS_PER_ROW
    tris = np.zeros((r_pad * TRIS_PER_ROW, 9), np.float32)
    tris[:t, 0:3] = sa
    tris[:t, 3:6] = sb - sa
    tris[:t, 6:9] = sc_ - sa
    row_perm = np.full(r_pad * TRIS_PER_ROW, -1, np.int32)
    row_perm[:t] = order.astype(np.int32)

    # --- per-row boxes (padded reshape reduction) --------------------------
    INF = np.float32(np.inf)
    tmin = np.minimum(np.minimum(sa, sb), sc_)
    tmax = np.maximum(np.maximum(sa, sb), sc_)
    pmin = np.full((t_pad, 3), INF, np.float32)
    pmax = np.full((t_pad, 3), -INF, np.float32)
    pmin[:t] = tmin
    pmax[:t] = tmax
    row_min = np.full((r_pad, 3), INF, np.float32)
    row_max = np.full((r_pad, 3), -INF, np.float32)
    row_min[:n_rows] = pmin.reshape(n_rows, TRIS_PER_ROW, 3).min(axis=1)
    row_max[:n_rows] = pmax.reshape(n_rows, TRIS_PER_ROW, 3).max(axis=1)

    # --- complete tree, bottom-up -------------------------------------------
    # all levels in heap order: node i has children 2i+1, 2i+2; level k
    # occupies [2^k - 1, 2^(k+1) - 1); the rows are the last level
    n_nodes = 2 * r_pad - 1
    ctree_min = np.full((n_nodes, 3), INF, np.float32)
    ctree_max = np.full((n_nodes, 3), -INF, np.float32)
    ctree_min[r_pad - 1:] = row_min
    ctree_max[r_pad - 1:] = row_max
    lo = r_pad - 1
    size = r_pad
    while size > 1:
        child_min = ctree_min[lo:lo + size].reshape(size // 2, 2, 3)
        child_max = ctree_max[lo:lo + size].reshape(size // 2, 2, 3)
        plo = lo // 2
        ctree_min[plo:plo + size // 2] = child_min.min(axis=1)
        ctree_max[plo:plo + size // 2] = child_max.max(axis=1)
        lo = plo
        size //= 2

    # the top tree: down to the treelets
    cut_nodes = 2 * n_treelets - 1
    ctree_f = np.zeros((cut_nodes, 8), np.float32)
    ctree_f[:, 0:3] = ctree_min[:cut_nodes]
    ctree_f[:, 3:6] = ctree_max[:cut_nodes]

    # each treelet's subtree over groups of rows, bottom-up from the row
    # boxes, all treelets at once
    n_groups = TREELET_ROWS // SUB_GROUP_ROWS
    sub_stride = 2 * n_groups
    sub_min = np.full((n_treelets, sub_stride, 3), INF, np.float32)
    sub_max = np.full((n_treelets, sub_stride, 3), -INF, np.float32)
    pm = row_min.reshape(n_treelets, n_groups, SUB_GROUP_ROWS, 3).min(axis=2)
    px = row_max.reshape(n_treelets, n_groups, SUB_GROUP_ROWS, 3).max(axis=2)
    sub_min[:, n_groups - 1: 2 * n_groups - 1] = pm
    sub_max[:, n_groups - 1: 2 * n_groups - 1] = px
    lo = n_groups - 1
    size = n_groups
    while size > 1:
        cmin = sub_min[:, lo:lo + size].reshape(n_treelets, size // 2, 2, 3)
        cmax = sub_max[:, lo:lo + size].reshape(n_treelets, size // 2, 2, 3)
        plo = lo // 2
        sub_min[:, plo:plo + size // 2] = cmin.min(axis=2)
        sub_max[:, plo:plo + size // 2] = cmax.max(axis=2)
        lo = plo
        size //= 2
    sub_f = np.zeros((n_treelets * sub_stride, 8), np.float32)
    sub_f[:, 0:3] = sub_min.reshape(-1, 3)
    sub_f[:, 3:6] = sub_max.reshape(-1, 3)

    return StreamedForest(
        ctree_f=ctree_f, tris=tris, sub_f=sub_f, row_perm=row_perm,
        n_rows=n_rows, n_treelets=n_treelets,
        leaf_depth=int(np.log2(r_pad)))
