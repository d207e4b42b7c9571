"""Wavefront OBJ parsing into triangle SoA + per-object ranges (numpy only;
the port's own copy of the JAX package's scene/objparse.py).

Mirrors `scene.parseObj` (dispatch.java:888-1003):
  * vertex transform = componentwise scale -> Euler rotate (Rz Ry Rx) ->
    shift, in float64 (dispatch.java:938)
  * normals are scaled+rotated too (dispatch.java:953) and normalized at
    triangle construction (dispatch.java:1241-1243)
  * `o `/`g ` lines close the previous object (one BVH per object,
    dispatch.java:907-921) and reset the active material to the addObject
    default
  * `usemtl` looks up `name + parentDir`; the LAST registered match wins
    (dispatch.java:923-931)
  * faces are taken as triangles from their first three vertices
    (dispatch.java:961; quads lose their 4th vertex — replicated)
  * missing vt -> the 69.420 sentinel slot; we store a has_uv mask instead of
    the sentinel (dispatch.java:904, 404-412)
  * missing vn -> zero normal slot -> flat shading. PARITY.md #1: the
    reference stores the unnormalized face normal in n1 with n2=n3=0 and its
    shader then renders such triangles black whenever the face normal has a
    zero component (frag.glsl:501-507); we store the normalized face normal
    ((v3-v1)x(v2-v1), same orientation: dispatch.java:398) in all three slots
    with has_smooth=False.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

UV_SENTINEL = 69.420  # dispatch.java:904 — replaced by the has_uv mask


def _rotate_xyz(p: np.ndarray, rot) -> np.ndarray:
    """Rz(rz) @ Ry(ry) @ Rx(rx) @ p for p (..., 3), float64 — the Java
    vec.rotate convention (dispatch.java:1157-1191)."""
    rx, ry, rz = float(rot[0]), float(rot[1]), float(rot[2])
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    rmat = np.array(
        [
            [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
            [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
            [-sy, cy * sx, cy * cx],
        ],
        dtype=np.float64,
    )
    return p @ rmat.T


@dataclasses.dataclass
class TriangleSoA:
    """Host-side triangle arrays (float64 until packing)."""

    v1: List[np.ndarray] = dataclasses.field(default_factory=list)
    v2: List[np.ndarray] = dataclasses.field(default_factory=list)
    v3: List[np.ndarray] = dataclasses.field(default_factory=list)
    n1: List[np.ndarray] = dataclasses.field(default_factory=list)
    n2: List[np.ndarray] = dataclasses.field(default_factory=list)
    n3: List[np.ndarray] = dataclasses.field(default_factory=list)
    uv1: List[np.ndarray] = dataclasses.field(default_factory=list)
    uv2: List[np.ndarray] = dataclasses.field(default_factory=list)
    uv3: List[np.ndarray] = dataclasses.field(default_factory=list)
    has_uv: List[bool] = dataclasses.field(default_factory=list)
    has_smooth: List[bool] = dataclasses.field(default_factory=list)
    mat: List[int] = dataclasses.field(default_factory=list)
    object_ranges: List[tuple] = dataclasses.field(default_factory=list)

    def __len__(self):
        return len(self.v1)

    def add_triangle(self, v1, v2, v3, n1, n2, n3, uv1, uv2, uv3, has_uv,
                     mat):
        """Triangle ctor semantics (dispatch.java:1237-1255): normals
        normalized; an all-zero normal triple means flat shading (see module
        docstring)."""
        v1 = np.asarray(v1, np.float64)
        v2 = np.asarray(v2, np.float64)
        v3 = np.asarray(v3, np.float64)
        n1 = np.asarray(n1, np.float64)
        n2 = np.asarray(n2, np.float64)
        n3 = np.asarray(n3, np.float64)
        smooth = not (
            np.all(n1 == 0.0) or np.all(n2 == 0.0) or np.all(n3 == 0.0)
        )
        if not smooth:
            # Flat normal: same orientation as the host upload,
            # (v3-v1) x (v2-v1) (dispatch.java:398), normalized.
            fn = np.cross(v3 - v1, v2 - v1)
            mag = np.linalg.norm(fn)
            fn = fn / mag if mag > 0 else fn
            n1 = n2 = n3 = fn
        else:
            n1 = n1 / np.linalg.norm(n1)
            n2 = n2 / np.linalg.norm(n2)
            n3 = n3 / np.linalg.norm(n3)
        self.v1.append(v1)
        self.v2.append(v2)
        self.v3.append(v3)
        self.n1.append(n1)
        self.n2.append(n2)
        self.n3.append(n3)
        self.uv1.append(np.asarray(uv1, np.float64)[:2])
        self.uv2.append(np.asarray(uv2, np.float64)[:2])
        self.uv3.append(np.asarray(uv3, np.float64)[:2])
        self.has_uv.append(bool(has_uv))
        self.has_smooth.append(smooth)
        self.mat.append(int(mat))


def parse_obj(
    path: str,
    soa: TriangleSoA,
    material: int,
    scale,
    shift,
    rot,
    material_names: Optional[List[str]] = None,
    parent_dir: str = "",
) -> None:
    """Append one OBJ file's triangles + object ranges to `soa`."""
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)
    rot = np.asarray(rot, np.float64)
    material_names = material_names or []

    vertices: List[np.ndarray] = [np.zeros(3)]
    normals: List[np.ndarray] = [np.zeros(3)]
    texcoords: List[np.ndarray] = [np.array([UV_SENTINEL, 0.0])]

    object_start = len(soa)
    mtl = material

    def close_object():
        nonlocal object_start
        if len(soa) > object_start:
            soa.object_ranges.append((object_start, len(soa)))
        object_start = len(soa)

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("o ") or line.startswith("g "):
                mtl = material  # dispatch.java:908
                close_object()
            elif line.startswith("usemtl "):
                name = line.split()[1].strip() + parent_dir
                for i, mname in enumerate(material_names):
                    if mname == name:
                        mtl = i  # last match wins (dispatch.java:925-931)
            elif line.startswith("v "):
                parts = line.split()
                p = np.array(
                    [float(parts[1]), float(parts[2]), float(parts[3])]
                )
                vertices.append(_rotate_xyz(p * scale, rot) + shift)
            elif line.startswith("vt "):
                parts = line.split()
                texcoords.append(
                    np.array([float(parts[1]), float(parts[2])])
                )
            elif line.startswith("vn "):
                parts = line.split()
                n = np.array(
                    [float(parts[1]), float(parts[2]), float(parts[3])]
                )
                normals.append(_rotate_xyz(n * scale, rot))
            elif line.startswith("f "):
                parts = line.strip()[2:].split()
                vi, ti, ni = [0, 0, 0], [0, 0, 0], [0, 0, 0]
                for i in range(3):
                    comps = parts[i].split("/")
                    if comps[0]:
                        vi[i] = int(comps[0])
                    if len(comps) > 1 and comps[1]:
                        ti[i] = int(comps[1])
                    if len(comps) > 2 and comps[2]:
                        ni[i] = int(comps[2])
                uv_a = texcoords[ti[0]]
                has_uv = not (
                    uv_a[0] == UV_SENTINEL or ti[0] == 0
                )  # dispatch.java:404
                soa.add_triangle(
                    vertices[vi[0]], vertices[vi[1]], vertices[vi[2]],
                    normals[ni[0]], normals[ni[1]], normals[ni[2]],
                    texcoords[ti[0]], texcoords[ti[1]], texcoords[ti[2]],
                    has_uv, mtl,
                )
    close_object()
