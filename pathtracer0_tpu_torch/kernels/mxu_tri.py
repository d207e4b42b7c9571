"""Möller-Trumbore as a matrix product: the host side.

The port's own copy of the JAX package's kernels/mxu_tri.py. Every
quantity of the triangle test is bilinear in a per-ray and a per-triangle
vector (triple-product identities, frag.glsl:351-372):

  p     = d x e2
  det   = e1 . p                  = (e2 x e1) . d
  s     = o - v1
  u_num = s . p                   = e2 . (o x d) - (e2 x v1) . d
  q     = s x e1
  v_num = d . q                   = -e1 . (o x d) - (v1 x e1) . d
  t_num = e2 . q                  = n . o - n . v1,   n = e1 x e2

so with the per-ray FEATURE vector (w = o x d)

  f = [dx dy dz  wx wy wz  ox oy oz  1  0 ...] in R^16

each is f . c for a per-triangle COEFFICIENT vector c, and a fifth one,
w_num = det - u_num - v_num, turns the inside test into a sign test: a hit
needs det, u_num, v_num and w_num of one sign. One product of a group's
(320, 16) coefficients with (16, rays) features gives all five quantities
of its 56 triangles for every ray.

The expanded forms cancel badly when |o| or |v1| is large, so rays and
triangles are both re-centred by one offset (`center`) before features and
coefficients are built.

Triangles come in the port's streamed layout (scene/packing.py `st_tris`):
one triangle per 9-float row (v1, e1, e2), GROUP_TRIS = 56 consecutive
rows a group, empty slots zero.

Table layout, chosen for csrc/mxu_group_kernel.cu: (n_groups, 320, 16)
float32, candidate-major with the 16 features of a candidate contiguous,
so a thread reads the two neighbouring features of its `mma.sync` operand
with one 32-bit load. Candidate q * 64 + j is quantity q (0 det, 1 u, 2 v,
3 w, 4 t) of the group's triangle j; the 8 pad candidates past the 56 real
ones carry det = +1, u = -1 on the constant feature, and so does an empty
slot: both fail every sign test. `jax_layout` gives the table as the JAX
package lays it out, (n_groups * 16, 320).
"""
from __future__ import annotations

import numpy as np
import torch

N_FEATURES = 16
QUANT_PAD = 64      # candidates per quantity (56 real + 8 pad)
N_QUANT = 5         # det, u, v, w, t
GROUP_TRIS = 56     # accel/lbvh.py SUB_GROUP_ROWS * TRIS_PER_ROW
N_CAND = N_QUANT * QUANT_PAD


def ray_features(o, d, center):
    """(16, R) float32 features of R rays, re-centred by `center`. o and d
    are (x, y, z) sequences of (R,) tensors (or (3, R) tensors); `center`
    is the (3,) offset the coefficient table was built with."""
    ox, oy, oz = (o[i] - float(center[i]) for i in range(3))
    dx, dy, dz = d[0], d[1], d[2]
    w = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    return torch.stack([dx, dy, dz, *w, ox, oy, oz, one]
                       + [zero] * (N_FEATURES - 10))


def _n_groups(tris) -> int:
    slots = tris.shape[0]
    if tris.ndim != 2 or tris.shape[1] != 9 or slots % GROUP_TRIS:
        raise ValueError("tris must be (n_groups * 56, 9): v1, e1, e2 by "
                         f"slot, not {tuple(tris.shape)}")
    return slots // GROUP_TRIS


def coef_table_np(tris: np.ndarray, center) -> np.ndarray:
    """The (n_groups, 320, 16) float32 coefficient table of `tris`
    (n_groups * 56, 9), computed in float64. The reference of `coef_table`."""
    n_groups = _n_groups(tris)
    v1 = tris[:, 0:3].astype(np.float64) - np.asarray(center, np.float64)
    e1 = tris[:, 3:6].astype(np.float64)
    e2 = tris[:, 6:9].astype(np.float64)
    n = np.cross(e1, e2)
    # empty slots: det = +1, u = -1 on the constant feature
    is_pad = np.abs(tris).max(axis=1) == 0.0

    coef = np.zeros((tris.shape[0], N_QUANT, N_FEATURES), np.float64)
    coef[:, 0, 0:3] = np.cross(e2, e1)
    coef[:, 0, 9] = np.where(is_pad, 1.0, 0.0)
    coef[:, 1, 0:3] = -np.cross(e2, v1)
    coef[:, 1, 3:6] = e2
    coef[:, 1, 9] = np.where(is_pad, -1.0, 0.0)
    coef[:, 2, 0:3] = -np.cross(v1, e1)
    coef[:, 2, 3:6] = -e1
    coef[:, 3] = coef[:, 0] - coef[:, 1] - coef[:, 2]   # w = det - u - v
    coef[:, 4, 6:9] = n
    coef[:, 4, 9] = -(n * v1).sum(axis=1)

    out = np.zeros((n_groups, N_QUANT, QUANT_PAD, N_FEATURES), np.float32)
    out[:, :, :GROUP_TRIS] = coef.reshape(
        n_groups, GROUP_TRIS, N_QUANT, N_FEATURES).transpose(0, 2, 1, 3)
    out[:, 0, GROUP_TRIS:, 9] = 1.0
    out[:, 1, GROUP_TRIS:, 9] = -1.0
    return out.reshape(n_groups, N_CAND, N_FEATURES)


def coef_table(tris: torch.Tensor, center) -> torch.Tensor:
    """`coef_table_np` in float32 on the device of `tris` (within 1e-6 of
    it relative to the table's largest entry)."""
    n_groups = _n_groups(tris)
    tris = tris.to(torch.float32)
    v1 = tris[:, 0:3] - torch.as_tensor(center, dtype=torch.float32,
                                        device=tris.device)
    e1, e2 = tris[:, 3:6], tris[:, 6:9]
    n = torch.linalg.cross(e1, e2)
    is_pad = (tris.abs().amax(dim=1) == 0.0).to(torch.float32)

    coef = tris.new_zeros((tris.shape[0], N_QUANT, N_FEATURES))
    coef[:, 0, 0:3] = torch.linalg.cross(e2, e1)
    coef[:, 0, 9] = is_pad
    coef[:, 1, 0:3] = -torch.linalg.cross(e2, v1)
    coef[:, 1, 3:6] = e2
    coef[:, 1, 9] = -is_pad
    coef[:, 2, 0:3] = -torch.linalg.cross(v1, e1)
    coef[:, 2, 3:6] = -e1
    coef[:, 3] = coef[:, 0] - coef[:, 1] - coef[:, 2]
    coef[:, 4, 6:9] = n
    coef[:, 4, 9] = -(n * v1).sum(dim=1)

    out = tris.new_zeros((n_groups, N_QUANT, QUANT_PAD, N_FEATURES))
    out[:, :, :GROUP_TRIS] = coef.reshape(
        n_groups, GROUP_TRIS, N_QUANT, N_FEATURES).permute(0, 2, 1, 3)
    out[:, 0, GROUP_TRIS:, 9] = 1.0
    out[:, 1, GROUP_TRIS:, 9] = -1.0
    return out.reshape(n_groups, N_CAND, N_FEATURES)


def recentre_tris(tris, center):
    """`tris` (slots, 9) float32 with v1 moved by -`center`, the frame the
    features and the coefficient table use: what row E's scalar test reads
    (tools/diag_mxu.py:646-650). Empty slots move too; their zero edges
    still fail the test."""
    out = tris.clone()
    out[:, 0:3] -= torch.as_tensor(center, dtype=tris.dtype,
                                   device=tris.device)
    return out


def recentre_origins(o, center):
    """Ray origins o ((x, y, z) of (R,) tensors) moved by -`center`, as
    `ray_features` moves them."""
    return tuple(o[i] - float(center[i]) for i in range(3))


def jax_layout(coef):
    """The table (n_groups, 320, 16), NumPy or torch, as the JAX package
    lays it out: (n_groups * 16, 320), group g in rows [16 g, 16 g + 16)."""
    n_groups = coef.shape[0]
    swapped = (coef.transpose(0, 2, 1) if isinstance(coef, np.ndarray)
               else coef.permute(0, 2, 1))
    return swapped.reshape(n_groups * N_FEATURES, N_CAND)


# ---- the big form's B operand (csrc/mxu_group_kernel.cu big_body) --------
#
# A port-side layout of the same table for `wgmma`, whose B operand is read
# from shared memory in 8 x 16-byte core matrices (no swizzle, K-major).
# Columns are the table's candidates reordered so that one m64n40 product
# gives a thread D, U, V, W and Tn of the same triangles: column n = 40 j +
# 8 q + i is quantity q of triangle 8 j + i (chunk j = 0..7, the last one
# the pad candidates). Per group, column n's features f sit at
#   bf16 ("default", and each half of "split3"): (n // 8) * 256 + (f // 8)
#        * 128 + (n % 8) * 16 + (f % 8) * 2 bytes, 10,240 bytes a group;
#   tf32 ("highest": the big then the small part, each rounded to TF32 by
#        nearest, ties away, as cvt.rna does): (n // 8) * 512 + (f // 4)
#        * 128 + (n % 8) * 16 + (f % 4) * 4 bytes, 20,480 bytes a part.
# Both are permutations of the table's entries (`b_columns`).
B_CHUNKS = QUANT_PAD // 8       # 8 triangles a chunk


def b_columns() -> torch.Tensor:
    """(320,) int64: the table's candidate in each column of the B image."""
    j, q, i = torch.meshgrid(torch.arange(B_CHUNKS), torch.arange(N_QUANT),
                             torch.arange(8), indexing="ij")
    return (q * QUANT_PAD + j * 8 + i).reshape(-1)


def _b_blocks(table, k_block):
    """(n_groups, 320, 16) -> the core-matrix order of the B image: (n_groups,
    40, 16 // k_block, 8, k_block), columns in `b_columns` order."""
    n_groups = table.shape[0]
    cols = table[:, b_columns()]
    return cols.reshape(n_groups, N_CAND // 8, 8, N_FEATURES // k_block,
                        k_block).permute(0, 1, 3, 2, 4).contiguous()


def _from_blocks(blocks):
    """The inverse of `_b_blocks`: back to the (n_groups, 320, 16) table."""
    n_groups = blocks.shape[0]
    cols = blocks.permute(0, 1, 3, 2, 4).reshape(n_groups, N_CAND, N_FEATURES)
    table = torch.empty_like(cols)
    table[:, b_columns()] = cols
    return table


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as cvt.rna.tf32.f32; the result is float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def b_image(coef: torch.Tensor, precision: str) -> torch.Tensor:
    """The B image of a (n_groups, 320, 16) float32 table for `precision`
    "default" (bf16), "split3" (bf16 hi then lo, coef = hi + lo to 16
    mantissa bits) or "highest" (TF32 big then small, coef = big + small
    to 21 bits): (n_groups, bytes) uint8, the image of group g in row g."""
    n_groups = coef.shape[0]
    if precision == "default":
        parts = [_b_blocks(coef.to(torch.bfloat16), 8)]
    elif precision == "split3":
        hi = coef.to(torch.bfloat16)
        lo = (coef - hi.to(torch.float32)).to(torch.bfloat16)
        parts = [_b_blocks(hi, 8), _b_blocks(lo, 8)]
    elif precision == "highest":
        big = round_tf32(coef)
        parts = [_b_blocks(big, 4), _b_blocks(round_tf32(coef - big), 4)]
    else:
        raise ValueError(f"no B image for precision {precision!r}")
    return torch.cat([x.reshape(n_groups, -1).view(torch.uint8)
                      for x in parts], 1)


# ---- mxu_kernel's B operand (csrc/mxu_group_kernel.cu mxu_kernel) ---------
#
# (prefilter_kernel reads the "default" image too: tiles 0-3, with the
# sign bits cleared for its product of magnitudes.)
# A second port-side layout of the table, for `mma.sync`: the 56 real
# candidates of each quantity (the pad candidates are left out: the test
# never reads their products) in the order in which thread (g = lane // 4,
# q = lane % 4) of a warp holds its B fragments, so that it loads each with
# one 16- or 8-byte shared-memory load and a warp's load falls into 32
# banks. Chunk jt (0..6) holds tile k (quantity k of triangles 8 jt ..
# 8 jt + 7); tile k's fragment of lane L is candidate n = 64 k + 8 jt + g at
#   bf16 ("default"): words b0 (features 2q, 2q + 1) and b1 (2q + 8, 2q + 9)
#        at byte jt * 1280 + (k // 2) * 512 + 16 L + 8 (k % 2) for k < 4,
#        jt * 1280 + 1024 + 8 L for k = 4; 8,960 bytes a group;
#   tf32 ("highest", big and small parts from `round_tf32`): at byte jt *
#        5120 + (2 k + part) * 512 + 16 L, the words of features q, q + 4,
#        8 + q, 12 + q (b0, b1 of each half of K); 35,840 bytes a group.
FRAG_CHUNKS = GROUP_TRIS // 8


def frag_layout(precision: str):
    """(candidate, feature, part) of each element of a group's fragment
    image, in image order: three (elements,) int64 tensors; an element is a
    bf16 ("default") or a float32 ("highest"), part 0 the big and 1 the
    small TF32 part."""
    if precision == "default":
        jt, k, L, w, h = torch.meshgrid(
            torch.arange(FRAG_CHUNKS), torch.arange(N_QUANT),
            torch.arange(32), torch.arange(2), torch.arange(2),
            indexing="ij")
        at = (jt * 640 + torch.where(k < 4, (k // 2) * 256 + 8 * L
                                     + 4 * (k % 2), 512 + 4 * L)
              + 2 * w + h)
        feature = 2 * (L % 4) + 8 * w + h
        part = torch.zeros_like(at)
    elif precision == "highest":
        jt, k, part, L, i = torch.meshgrid(
            torch.arange(FRAG_CHUNKS), torch.arange(N_QUANT),
            torch.arange(2), torch.arange(32), torch.arange(4),
            indexing="ij")
        at = jt * 1280 + (2 * k + part) * 128 + 4 * L + i
        feature = (i // 2) * 8 + L % 4 + 4 * (i % 2)
    else:
        raise ValueError(f"no fragment image for precision {precision!r}")
    cand = QUANT_PAD * k + 8 * jt + L // 4
    order = at.reshape(-1).argsort()
    return tuple(x.reshape(-1)[order] for x in (cand, feature, part))


def frag_image(coef: torch.Tensor, precision: str) -> torch.Tensor:
    """The fragment image of a (n_groups, 320, 16) float32 table for
    `precision` "default" (bf16) or "highest" (TF32 big and small parts,
    coef = big + small to 21 bits): (n_groups, bytes) uint8, the image of
    group g in row g."""
    cand, feature, part = (x.to(coef.device) for x in frag_layout(precision))
    if precision == "default":
        words = coef.to(torch.bfloat16)[:, cand, feature]
    else:
        big = round_tf32(coef)
        words = torch.stack([big, round_tf32(coef - big)])[
            part, :, cand, feature].T
    return words.contiguous().view(torch.uint8)


def frag_image_tables(image: torch.Tensor, precision: str):
    """The tables a fragment image holds, read back as (n_groups, 320, 16)
    float32 with NaN where the image holds nothing (the pad candidates):
    one for "default", (big, small) for "highest"."""
    n_groups = image.shape[0]
    cand, feature, part = frag_layout(precision)
    dtype = torch.bfloat16 if precision == "default" else torch.float32
    words = image.contiguous().view(dtype).to(torch.float32)
    tables = torch.full((int(part.max()) + 1, n_groups, N_CAND, N_FEATURES),
                        float("nan"))
    tables[part, :, cand, feature] = words.T
    return tuple(tables)


# the images made so far: (layout, precision, n_groups) -> (table, its
# version counter then, image); the table is held, so its storage is not
# reused
_IMAGES = {}


def _image_of(make, coef, n_groups, precision):
    key = (make.__name__, precision, n_groups)
    held = _IMAGES.get(key)
    if held is not None and held[0] is coef and held[1] == coef._version:
        return held[2]
    image = make(coef[:n_groups], precision)
    _IMAGES[key] = (coef, coef._version, image)
    return image


def b_image_of(coef: torch.Tensor, n_groups: int,
               precision: str) -> torch.Tensor:
    """b_image(coef[:n_groups], precision), made once per table: a later
    call with the same tensor, not written since (its version counter),
    returns the same image, so a launch does no arithmetic for it."""
    return _image_of(b_image, coef, n_groups, precision)


def frag_image_of(coef: torch.Tensor, n_groups: int,
                  precision: str) -> torch.Tensor:
    """frag_image(coef[:n_groups], precision), made once per table as
    `b_image_of` makes the big form's."""
    return _image_of(frag_image, coef, n_groups, precision)


def b_image_tables(image: torch.Tensor, precision: str):
    """The (n_groups, 320, 16) float32 tables a B image holds, read back in
    the table's candidate order: one for "default", (hi, lo) for "split3",
    (big, small) for "highest"."""
    n_groups = image.shape[0]
    dtype, k_block = ((torch.float32, 4) if precision == "highest"
                      else (torch.bfloat16, 8))
    n_parts = 1 if precision == "default" else 2
    flat = image.contiguous().view(dtype).reshape(n_groups, n_parts, -1)
    return tuple(_from_blocks(flat[:, k].reshape(
        n_groups, N_CAND // 8, N_FEATURES // k_block, 8, k_block)).to(
            torch.float32) for k in range(n_parts))


def candidates_np(tris, o, d):
    """Float64 oracle: (det, u_num, v_num, t_num), each (R, slots), by the
    direct Möller-Trumbore forms on `tris` (slots, 9) and rays o, d (R, 3);
    what the expansion is held against."""
    tr = np.asarray(tris, np.float64)
    v1, e1, e2 = tr[:, 0:3], tr[:, 3:6], tr[:, 6:9]
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    p = np.cross(d[:, None, :], e2[None, :, :])
    det = (e1[None] * p).sum(-1)
    s = o[:, None, :] - v1[None, :, :]
    u = (s * p).sum(-1)
    q = np.cross(s, e1[None, :, :])
    v = (d[:, None, :] * q).sum(-1)
    t = (e2[None] * q).sum(-1)
    return det, u, v, t
