"""Build-time scene validation: malformed input fails at `Scene.build` with
the offending entity named, before any table reaches a kernel (the kernels
do no bounds or finiteness checks).

The port's own copy of the JAX package's scene/validate.py: the same
checks in the same order, with the same messages.
"""
from __future__ import annotations

import numpy as np


class SceneValidationError(ValueError):
    """Raised by validate_scene for malformed scene input."""


def _check_finite(name, arr):
    arr = np.asarray(arr, np.float64)
    if arr.size and not np.isfinite(arr).all():
        bad = np.argwhere(~np.isfinite(arr))[0]
        raise SceneValidationError(
            f"{name} contains a non-finite value at index "
            f"{tuple(int(b) for b in bad)}"
        )


def _check_mat(name, indices, n_mats):
    idx = np.asarray(indices, np.int64).ravel()
    if idx.size == 0:
        return
    bad = (idx < 0) | (idx >= n_mats)
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise SceneValidationError(
            f"{name}[{k}] references material {int(idx[k])}, but the scene "
            f"has {n_mats} material(s) (0..{n_mats - 1}); add it with "
            f"add_material() before use"
        )


def validate_scene(scene) -> None:
    """Cheap structural checks over the host-side scene. Raises
    SceneValidationError with the offending entity named."""
    n_mats = len(scene.materials)

    # triangles (parsed or loose, then the bulk meshes)
    t = scene.tris
    if len(t):
        for fld in ("v1", "v2", "v3", "uv1", "uv2", "uv3"):
            _check_finite(f"triangle {fld}", np.asarray(getattr(t, fld)))
        _check_mat("triangle material", t.mat, n_mats)
    for bi, bm in enumerate(scene.bulk_meshes):
        if "indexed" in bm:
            # Scene.add_mesh_indexed: the compact payload, as the reference
            # checks it (the face-index range is checked when it is added)
            verts, normals, uvs, mat_id = bm["indexed"]
            _check_finite(f"mesh[{bi}].verts", verts)
            if normals is not None:
                _check_finite(f"mesh[{bi}].normals", normals)
            if uvs is not None:
                _check_finite(f"mesh[{bi}].uvs", uvs)
            _check_mat(f"mesh[{bi}] material", [mat_id], n_mats)
            continue
        for fld in ("v1", "v2", "v3", "uv1", "uv2", "uv3", "n1", "n2", "n3"):
            _check_finite(f"mesh[{bi}].{fld}", bm[fld])
        _check_mat(f"mesh[{bi}] material", bm["mat"], n_mats)

    # ellipsoids
    _check_finite("ellipsoid center", scene.ell_c)
    _check_finite("ellipsoid stretch", scene.ell_stretch)
    _check_finite("ellipsoid rotation", scene.ell_rot)
    _check_finite("ellipsoid radius", scene.ell_rad)
    _check_mat("ellipsoid material", scene.ell_mat, n_mats)
    for i, r in enumerate(scene.ell_rad):
        if not r > 0:
            raise SceneValidationError(
                f"ellipsoid[{i}] radius must be > 0, got {r}")
    for i, s in enumerate(scene.ell_stretch):
        if any(v == 0 for v in s):
            raise SceneValidationError(
                f"ellipsoid[{i}] stretch has a zero component {tuple(s)} "
                f"(the quadric degenerates)")

    # implicits (the shader defines functions 1..10, frag.glsl:299-349)
    _check_finite("implicit shift", scene.imp_shift)
    _check_finite("implicit scale", scene.imp_scale)
    _check_finite("implicit rotation", scene.imp_rot)
    _check_mat("implicit material", scene.imp_mat, n_mats)
    for i, fn in enumerate(scene.imp_fn):
        if not 1 <= int(fn) <= 10:
            raise SceneValidationError(
                f"implicit[{i}] function id {fn} outside the defined set "
                f"1..10 (frag.glsl:299-349)")
    for i, s in enumerate(scene.imp_scale):
        if any(v == 0 for v in s):
            raise SceneValidationError(
                f"implicit[{i}] scale has a zero component {tuple(s)}")

    # material texture-map indices
    n_tex = len(scene.textures)
    for mi, m in enumerate(scene.materials):
        for fld in ("map_Ka", "map_Kd", "map_Ks", "map_Ke", "map_d",
                    "map_Tr", "map_Ns", "map_Pm", "map_Pr", "map_Ps",
                    "map_Pc", "map_Pcr", "map_norm"):
            v = int(getattr(m, fld))
            if v != -1 and not 0 <= v < n_tex:
                raise SceneValidationError(
                    f"material[{mi}] ('{m.name}') {fld} = {v}, but the "
                    f"scene has {n_tex} texture(s)")
