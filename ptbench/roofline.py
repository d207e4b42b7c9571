"""Frozen work counts of the renderer's kernels and the card's peaks.

The counts are those of the repository's chip_smoke.py as of 01cba3a,
worked from the work a frame needs: the cell's shapes, the scene's table
sizes and the scene queries the traced frames made (Renderer.rays_traced),
never a kernel's launch configuration or timing, so the same work is read
whatever implements it. Each count is a floor: work that depends on the
data and is not known from those is left out. So an implicit surface
counts its transform and bounding test a query (OPS_IMP) and not its
march: how many of the lattice's samples and bisections a ray takes
depends on where the ray meets the surface, and the kernel skips the
samples outside a bounded surface's sphere.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W: 67 TFLOP/s
of float32 outside the tensor cores, 3.35 TB/s of HBM3. A card set below
700 W reads its power limit beside them (`card`), and its shares are
against the published peaks all the same.
"""
from __future__ import annotations

import subprocess

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# float operations every scene query of the frame kernel surely does
# (csrc/pathtrace.cuh closest_hit): the nudge and hit test, each triangle
# test up to its first compare, each ellipsoid test up to its first
# compare, each implicit's transform and bounding test, two 3x3 rotations
# for each rotated primitive
OPS_QUERY, OPS_TRI, OPS_ELL, OPS_IMP, OPS_ROT = 7, 47, 47, 41, 30
# the frame kernel's bytes a pixel: its RNG state in (8) and out (8), its
# radiance out (12)
FRAME_PIXEL_BYTES = 8 + 8 + 12
# bounce_kernel's path form (csrc/integrate.cuh `bounce_ray`): a live
# ray's origin, direction, walk, throughput and query count (68); a ray
# that hit: its triangle id through the permutation (4), radiance, next
# ray, throughput, stack size, RNG state, medium flag, stack top and
# alive flag (94); a ray that missed: its sky radiance and alive flag (25)
BOUNCE_LIVE_BYTES, BOUNCE_HIT_BYTES, BOUNCE_MISS_BYTES = 68, 94, 25
BOUNCE_PERM_BYTES = 4
# its camera form a ray (`camera_ray`): the first sample 130, a later one,
# which also adds the sample before into the running total, 158
CAMERA_FIRST_BYTES, CAMERA_LATER_BYTES = 130, 158
# streamed_kernel a live query: the ray and its pruning distance in (28)
# and the hit's t, u, v and index out (16)
STREAMED_RAY_BYTES = 28 + 16
# the material table: 48 floats a material
MATERIAL_BYTES = 48 * 4


def least_s(nbytes, ops=0):
    """The least time the card can take for `nbytes` moved and `ops`
    float32 operations: the larger of the two over their peaks."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32)


def frame_kernel_s(*, pixels, queries, n_tris, n_ell, n_imp=0, n_rot=0,
                   n_mats=1):
    """frame_kernel's floor over `pixels` pixel launches (summed over the
    frames) that made `queries` scene queries."""
    ops = queries * (OPS_QUERY + OPS_TRI * n_tris + OPS_ELL * n_ell
                     + OPS_IMP * n_imp + OPS_ROT * n_rot)
    nbytes = (pixels * FRAME_PIXEL_BYTES + n_tris * 4 * (9 + 10 + 10)
              + n_ell * 17 * 4 + n_mats * MATERIAL_BYTES)
    return least_s(nbytes, ops)


def bounce_kernel_s(*, queries, paths, pixels, spp, frames, perm=True):
    """bounce_kernel's floor over `frames` frames of `pixels` pixels and
    `spp` samples, `paths` = frames x pixels x spp camera rays that made
    `queries` live queries. Of the queries at most one a path missed
    (a miss ends it), so misses = min(paths, queries) and the rest hit."""
    misses = min(paths, queries)
    hits = queries - misses
    path = (queries * BOUNCE_LIVE_BYTES + misses * BOUNCE_MISS_BYTES
            + hits * (BOUNCE_HIT_BYTES + BOUNCE_PERM_BYTES * perm))
    camera = frames * pixels * (CAMERA_FIRST_BYTES
                                + (spp - 1) * CAMERA_LATER_BYTES)
    return least_s(path + camera)


def streamed_kernel_s(*, queries):
    """streamed_kernel's floor over `queries` live queries."""
    return least_s(queries * STREAMED_RAY_BYTES)


def card():
    """The card's name and power limit as nvidia-smi reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None
