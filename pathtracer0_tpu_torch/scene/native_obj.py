"""The native (C++) OBJ parser: the data loader of large OBJ files.

The reference's loader is scene.parseObj (dispatch.java:888-1003). The
byte-level tokenizing runs in C++ (csrc/objparse.cpp, built with g++ at
first use by kernels/build.py and loaded with ctypes); every SEMANTIC
rule stays here, vectorized over the token arrays, as the line-by-line
parser (scene/objparse.py) applies it:

  * vertex transform scale -> Euler rotate -> shift in float64
    (dispatch.java:938); normals scaled+rotated too (dispatch.java:953)
    and normalized;
  * `o `/`g ` closes the object and resets the active material to the
    add_object default (dispatch.java:907-918);
  * `usemtl` looks up name + parentDir, the LAST registered match wins
    (dispatch.java:925-931);
  * faces take their first three vertices (quads lose the 4th,
    dispatch.java:961);
  * missing vt -> has_uv False; a real u == 69.420 also disables UVs
    (the reference's sentinel, dispatch.java:404);
  * missing/zero vn -> flat shading with the normalized face normal
    (v3-v1) x (v2-v1) in all three slots.

Each o/g segment lands in Scene.bulk_meshes as one object, with the keys
Scene.add_mesh writes. Where a face has no vt, its UV slots hold the
sentinel (69.420, 0), as the line-by-line parser's do; add_mesh writes
zeros there. `Scene.add_object` sends files past
`Scene.NATIVE_OBJ_THRESHOLD` bytes here (PT0_NATIVE_OBJ=1 forces this
parser, 0 forbids it); where g++ cannot build the tokenizer, the parse
raises rather than taking the slow parser.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..kernels import build
from .objparse import UV_SENTINEL, _rotate_xyz


def _lib():
    """The loaded tokenizer, built first if needed; raises RuntimeError if
    it cannot be built."""
    lib = build.load("objparse")
    lib.pt0_obj_count.restype = ctypes.c_int
    lib.pt0_obj_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int64)]
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.pt0_obj_fill.restype = ctypes.c_int
    lib.pt0_obj_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64, dp, dp, dp,
                                 ip, ip, ip, ctypes.c_char_p]
    return lib


def available() -> bool:
    """Whether the tokenizer is built or can be (g++ is there)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def tokenize(path: str):
    """Raw token arrays: (verts, uvs, norms, faces (F, 9) int32, events
    [(face_idx, kind, name), ...]); kind 0 is o/g, 1 usemtl. Raises
    RuntimeError if the tokenizer cannot be built."""
    lib = _lib()
    with open(path, "rb") as f:
        data = f.read()
    counts = (ctypes.c_int64 * 6)()
    lib.pt0_obj_count(data, len(data), counts)
    nv, nvt, nvn, nf, nev, nbytes = [int(c) for c in counts]
    verts = np.zeros((max(nv, 1), 3), np.float64)
    uvs = np.zeros((max(nvt, 1), 2), np.float64)
    norms = np.zeros((max(nvn, 1), 3), np.float64)
    faces = np.full((max(nf, 1), 9), -1, np.int32)
    ev_face = np.zeros(max(nev, 1), np.int32)
    ev_kind = np.zeros(max(nev, 1), np.int32)
    names = ctypes.create_string_buffer(max(nbytes, 1))
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.pt0_obj_fill(data, len(data), verts.ctypes.data_as(dp),
                     uvs.ctypes.data_as(dp), norms.ctypes.data_as(dp),
                     faces.ctypes.data_as(ip), ev_face.ctypes.data_as(ip),
                     ev_kind.ctypes.data_as(ip), names)
    raw_names = names.raw[:nbytes].split(b"\0")[:nev] if nev else []
    events = [(int(ev_face[i]), int(ev_kind[i]),
               raw_names[i].decode("utf-8", "replace")) for i in range(nev)]
    return verts[:nv], uvs[:nvt], norms[:nvn], faces[:nf], events


def parse_obj_bulk(path: str, scene, material: int, scale, shift, rot,
                   material_names: Optional[List[str]] = None,
                   parent_dir: str = "") -> None:
    """The native counterpart of objparse.parse_obj: appends one bulk mesh
    per o/g segment to scene.bulk_meshes (the same object semantics)."""
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)
    rot = np.asarray(rot, np.float64)
    material_names = material_names or []

    verts, uvs, norms, faces, events = tokenize(path)
    nf = faces.shape[0]
    if nf == 0:
        return

    verts = _rotate_xyz(verts * scale, rot) + shift
    norms_t = _rotate_xyz(norms * scale, rot) if norms.shape[0] else norms
    # one zero row so the gathers below always have a target (indices are
    # masked by their ok flags)
    if norms_t.shape[0] == 0:
        norms_t = np.zeros((1, 3))
    if uvs.shape[0] == 0:
        uvs = np.zeros((1, 2))

    # per-face material and object segments, by replaying the events
    face_mtl = np.full(nf, material, np.int32)
    boundaries = [0]
    mtl = material
    last_face = 0
    for fidx, kind, name in events:
        face_mtl[last_face:fidx] = mtl
        last_face = fidx
        if kind == 0:  # o / g: close the object, reset the material
            if fidx != boundaries[-1]:
                boundaries.append(fidx)
            mtl = material
        else:  # usemtl: the LAST registered match of name + parentDir
            key = name.split()[0] + parent_dir if name else parent_dir
            for i, mname in enumerate(material_names):
                if mname == key:
                    mtl = i
    face_mtl[last_face:] = mtl
    boundaries.append(nf)

    def vtx(col):
        idx = faces[:, col]
        return np.where((idx >= 0)[:, None], verts[np.maximum(idx, 0)], 0.0)

    v1, v2, v3 = vtx(0), vtx(3), vtx(6)

    def nrm(col):
        idx = faces[:, col]
        ok = (idx >= 0) & (idx < norms_t.shape[0])
        return np.where(ok[:, None],
                        norms_t[np.clip(idx, 0, norms_t.shape[0] - 1)], 0.0)

    n1, n2, n3 = nrm(2), nrm(5), nrm(8)
    # smooth iff all three normals are present and non-zero (the triangle
    # constructor, dispatch.java:1241-1243)
    def nonzero(n):
        return np.any(n != 0.0, axis=1)

    def unit(n):
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                              1e-300)

    smooth = nonzero(n1) & nonzero(n2) & nonzero(n3)
    fn = unit(np.cross(v3 - v1, v2 - v1))
    sm = smooth[:, None]
    n1f, n2f, n3f = (np.where(sm, unit(n), fn) for n in (n1, n2, n3))

    def uvx(col):
        idx = faces[:, col]
        ok = (idx >= 0) & (idx < uvs.shape[0])
        # a missing vt slot holds the sentinel, as the line-by-line
        # parser's placeholder row does
        return np.where(ok[:, None], uvs[np.clip(idx, 0, uvs.shape[0] - 1)],
                        np.array([UV_SENTINEL, 0.0])), ok

    uv1, ok1 = uvx(1)
    uv2, _ = uvx(4)
    uv3, _ = uvx(7)
    has_uv = ok1 & (uv1[:, 0] != UV_SENTINEL)

    for s, e in zip(boundaries[:-1], boundaries[1:]):
        if e <= s:
            continue
        scene.bulk_meshes.append(dict(
            v1=v1[s:e], v2=v2[s:e], v3=v3[s:e],
            n1=n1f[s:e], n2=n2f[s:e], n3=n3f[s:e],
            uv1=uv1[s:e], uv2=uv2[s:e], uv3=uv3[s:e],
            has_uv=has_uv[s:e], has_smooth=smooth[s:e],
            mat=face_mtl[s:e]))
