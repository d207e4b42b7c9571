"""The native (C++) builder of the streamed forest.

csrc/streambuild.cpp does the build of accel/lbvh._build_streamed_numpy,
the same Morton quantization, the same stable order, the same float32
packing arithmetic, in four streaming passes with a radix sort (mode 0,
bit-equal to the NumPy builder), and alone makes the balanced median-split
order (mode 1). It is compiled with g++ at first use (kernels/build.py)
and loaded with ctypes.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build
from . import lbvh


def available() -> bool:
    """Whether the native builder is built or can be (g++ is there)."""
    try:
        build.load("streambuild")
    except RuntimeError:
        return False
    return True


def build_streamed(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray,
                   mode: int = 1) -> lbvh.StreamedForest:
    """The streamed forest of (T, 3) vertex arrays: mode 0 the Morton
    order, mode 1 the balanced median-split order. Raises RuntimeError if
    the builder cannot be compiled."""
    lib = build.load("streambuild")
    fn = lib.pt0_build_streamed
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    fn.restype = ctypes.c_int64
    fn.argtypes = [dp, dp, dp] + [ctypes.c_int64] * 7 + [
        fp, ctypes.POINTER(ctypes.c_int32), fp, fp]
    t = int(v1.shape[0])
    v1, v2, v3 = (np.ascontiguousarray(v, np.float64) for v in (v1, v2, v3))
    if not v1.shape == v2.shape == v3.shape == (t, 3):
        raise ValueError("v1, v2 and v3 must be (T, 3) arrays of one T")

    n_rows, n_treelets, r_pad = lbvh.shape(t)
    sub_stride = 2 * (lbvh.TREELET_ROWS // lbvh.SUB_GROUP_ROWS)
    tris = np.zeros((r_pad * lbvh.TRIS_PER_ROW, 9), np.float32)
    row_perm = np.full(r_pad * lbvh.TRIS_PER_ROW, -1, np.int32)
    ctree_f = np.zeros((2 * n_treelets - 1, 8), np.float32)
    sub_f = np.zeros((n_treelets * sub_stride, 8), np.float32)
    rc = fn(v1.ctypes.data_as(dp), v2.ctypes.data_as(dp),
            v3.ctypes.data_as(dp), t, lbvh.TRIS_PER_ROW, lbvh.TREELET_ROWS,
            lbvh.SUB_GROUP_ROWS, lbvh.MORTON_BITS, n_treelets, mode,
            tris.ctypes.data_as(fp),
            row_perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctree_f.ctypes.data_as(fp), sub_f.ctypes.data_as(fp))
    if rc != 0:
        raise RuntimeError(f"pt0_build_streamed failed (rc={rc})")
    return lbvh.StreamedForest(
        ctree_f=ctree_f, tris=tris, sub_f=sub_f, row_perm=row_perm,
        n_rows=n_rows, n_treelets=n_treelets,
        leaf_depth=int(np.log2(r_pad)))
