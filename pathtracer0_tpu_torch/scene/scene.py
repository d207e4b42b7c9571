"""Scene builder: the host-side API of the reference `scene` class
(dispatch.java:866-1064), as the JAX package exposes it.

    scene.addObject(path, mtl, scale, shift, rot)   -> add_object
    scene.addTri(v1, v2, v3, m)                     -> add_tri
    scene.addEllipsoid(c, stretch, rot, radius, m)  -> add_ellipsoid
    scene.addImplicit(fn, shift, scale, rot, m)     -> add_implicit
    scene.addMaterial(name) / setLastMtl(prop, val) -> add_material /
                                                       set_last_mtl
    scene.addMat(Ka, Kd, Ks, ...)                   -> add_mat
plus texture 0 as the sky (set_sky), bulk meshes (add_mesh,
add_mesh_indexed; large OBJ files load as bulk meshes through the native
parser, scene/native_obj.py) and the legacy shader's emissive-disk
lights (add_disk_light, add_emissive_sphere). `build(config, device=...)`
builds the SAH forest over the triangles, or the two-level LBVH past
`config.stream_threshold` of them, and packs everything onto one device
(scene/packing.py).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np

from ..config import RenderConfig
from ..core.device import resolve_device
from . import native_obj
from .material import Material, parse_mtl
from .objparse import TriangleSoA, parse_obj
from .packing import pack_scene
from .texture import TextureRegistry
from .validate import validate_scene


class Scene:
    def __init__(self):
        self.materials: List[Material] = []
        self.textures = TextureRegistry()
        self.tris = TriangleSoA()
        self.imp_fn: List[int] = []
        self.imp_shift: List[Sequence[float]] = []
        self.imp_scale: List[Sequence[float]] = []
        self.imp_rot: List[Sequence[float]] = []
        self.imp_mat: List[int] = []
        self.ell_c: List[Sequence[float]] = []
        self.ell_stretch: List[Sequence[float]] = []
        self.ell_rot: List[Sequence[float]] = []
        self.ell_rad: List[float] = []
        self.ell_mat: List[int] = []
        self.bulk_meshes: List[dict] = []
        # legacy emissive-disk lights (raytrace.glsl EmissiveData): (kind,
        # id_start, id_end, material, centre, radius)
        self.disk_lights: List[tuple] = []
        # legacy 18-float materials (addMat, dispatch.java:1025-1046)
        self.legacy_mats: List[tuple] = []

    # -- sky ---------------------------------------------------------------
    def set_sky(self, image: Union[str, np.ndarray], name: str = "sky"):
        """Register the equirect sky as texture 0 (dispatch.java:221-222).
        Must come before any other texture."""
        if len(self.textures):
            raise RuntimeError("set_sky must register texture index 0")
        if isinstance(image, str):
            self.textures.register(image, name)
        else:
            self.textures.register_array(image, name)

    def set_constant_sky(self, color=(0.5, 0.5, 0.5)):
        self.set_sky(np.full((1, 1, 3), 0.0, np.float32)
                     + np.asarray(color, np.float32), "sky")

    # -- materials ----------------------------------------------------------
    def add_material(self, name: str) -> Material:
        mat = Material(name=name)
        self.materials.append(mat)
        return mat

    def set_last_mtl(self, prop: str, value):
        if not self.materials:
            raise RuntimeError("no material added yet")
        self.materials[-1].set(prop, value)

    def add_mat(self, KaR, KaG, KaB, KdR, KdG, KdB, KsR, KsG, KsB,
                alpha, reflectivity, transmission, ref_index, emission,
                emissive_radius, solid, absorption, texture_id):
        """Legacy 18-float material (addMat, dispatch.java:1025-1046), in
        the reference's argument order: packed as PackedScene.legacy_mats
        and read by shade/mtl.decode_legacy. No render mode shades with
        these records, as in the reference."""
        self.legacy_mats.append(tuple(float(v) for v in (
            KaR, KaG, KaB, KdR, KdG, KdB, KsR, KsG, KsB,
            alpha, reflectivity, transmission, ref_index, emission,
            emissive_radius, solid, absorption, texture_id)))

    # -- geometry -----------------------------------------------------------
    # OBJ files past this size go to the native tokenizer
    # (scene/native_obj.py): the line-by-line parser cannot be vectorized
    NATIVE_OBJ_THRESHOLD = 4 << 20  # bytes

    def _parse_obj(self, path: str, material, scale, shift, rot,
                   parent_dir: str):
        """One .obj file through the native parser (past
        NATIVE_OBJ_THRESHOLD bytes, or always with PT0_NATIVE_OBJ=1; never
        with PT0_NATIVE_OBJ=0) or the line-by-line one. Where the native
        parser is chosen and g++ cannot build it, this raises."""
        force = os.environ.get("PT0_NATIVE_OBJ")
        names = [m.name for m in self.materials]
        if force == "1" or (force != "0" and os.path.getsize(path)
                            > self.NATIVE_OBJ_THRESHOLD):
            native_obj.parse_obj_bulk(path, self, material, scale, shift,
                                      rot, names, parent_dir)
        else:
            parse_obj(path, self.tris, material, scale, shift, rot, names,
                      parent_dir)

    def add_object(self, filepath: str, material: int = 0,
                   scale=(1.0, 1.0, 1.0), shift=(0.0, 0.0, 0.0),
                   rot=(0.0, 0.0, 0.0)):
        """A directory: every .mtl, then every .obj inside it; a file: that
        one .obj (dispatch.java:867-886). Each `o`/`g` group becomes one
        object of the forest. Large files go to the native parser (see
        _parse_obj)."""
        if os.path.isdir(filepath):
            entries = sorted(os.listdir(filepath))
            objs = [e for e in entries if e.lower().endswith(".obj")]
            if not objs:
                print("no obj files found in the directory.")
                return
            for m in (e for e in entries if e.lower().endswith(".mtl")):
                parse_mtl(os.path.join(filepath, m), filepath,
                          self.materials, self.textures)
            for o in objs:
                self._parse_obj(os.path.join(filepath, o), material, scale,
                                shift, rot, filepath)
        elif os.path.isfile(filepath) and filepath.lower().endswith(".obj"):
            self._parse_obj(filepath, material, scale, shift, rot, "")
        else:
            raise FileNotFoundError(filepath)

    def add_mesh_indexed(self, verts, faces, m: int, normals=None,
                         uvs=None):
        """Bulk triangle mesh in indexed form: verts (V, 3) shared vertex
        positions, faces (T, 3) vertex indices, optional per-vertex
        normals (V, 3) (smooth shading; else flat) and UVs (V, 2). The same
        mesh as `add_mesh(verts[faces[:, 0]], verts[faces[:, 1]],
        verts[faces[:, 2]], m, ...)`, and expanded to it here on the host:
        positions, smooth normals and UVs are gathers, flat normals
        (v3 - v1) x (v2 - v1) in float64."""
        verts = np.asarray(verts, np.float64).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
            raise ValueError("face index out of range")
        if normals is not None:
            normals = np.asarray(normals, np.float64).reshape(-1, 3)
            if normals.shape[0] != verts.shape[0]:
                raise ValueError("normals must be per-vertex (V, 3)")
        if uvs is not None:
            uvs = np.asarray(uvs, np.float64).reshape(-1, 2)
            if uvs.shape[0] != verts.shape[0]:
                raise ValueError("uvs must be per-vertex (V, 2)")

        def corners(table):
            return (None if table is None
                    else tuple(table[faces[:, c]] for c in range(3)))

        self.add_mesh(*corners(verts), m, normals=corners(normals),
                      uvs=corners(uvs))
        # the compact payload, which validation checks as the reference does
        self.bulk_meshes[-1]["indexed"] = (verts, normals, uvs, int(m))

    def add_tri(self, v1, v2, v3, m: int):
        """One flat-shaded triangle without UVs (dispatch.java:1013-1015),
        an object of its own in the forest."""
        start = len(self.tris)
        self.tris.add_triangle(v1, v2, v3, (0, 0, 0), (0, 0, 0), (0, 0, 0),
                               (0, 0), (0, 0), (0, 0), False, m)
        self.tris.object_ranges.append((start, start + 1))

    def add_mesh(self, v1, v2, v3, m: int, normals=None, uvs=None):
        """Bulk triangle mesh from (T, 3) vertex arrays. normals: optional
        three (T, 3) per-vertex normal arrays (smooth shading), else flat;
        uvs: optional three (T, 2) arrays. Packs as one object after all
        parsed and loose triangles, meshes in the order they were added."""
        v1 = np.asarray(v1, np.float64).reshape(-1, 3)
        v2 = np.asarray(v2, np.float64).reshape(-1, 3)
        v3 = np.asarray(v3, np.float64).reshape(-1, 3)
        t = v1.shape[0]
        if normals is not None:
            def unit(n):
                n = np.asarray(n, np.float64).reshape(-1, 3)
                return n / np.maximum(
                    np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
            n1, n2, n3 = (unit(n) for n in normals)
            has_smooth = np.ones(t, bool)
        else:
            fn = np.cross(v3 - v1, v2 - v1)
            fn = fn / np.maximum(
                np.linalg.norm(fn, axis=1, keepdims=True), 1e-30)
            n1 = n2 = n3 = fn
            has_smooth = np.zeros(t, bool)
        if uvs is not None:
            uv1, uv2, uv3 = (np.asarray(u, np.float64).reshape(-1, 2)
                             for u in uvs)
            has_uv = np.ones(t, bool)
        else:
            uv1 = uv2 = uv3 = np.zeros((t, 2))
            has_uv = np.zeros(t, bool)
        self.bulk_meshes.append(dict(
            v1=v1, v2=v2, v3=v3, n1=n1, n2=n2, n3=n3,
            uv1=uv1, uv2=uv2, uv3=uv3, has_uv=has_uv,
            has_smooth=has_smooth, mat=np.full(t, int(m), np.int32)))

    def add_ellipsoid(self, c, stretch, rot, radius: float, m: int):
        self.ell_c.append(tuple(c))
        self.ell_stretch.append(tuple(stretch))
        self.ell_rot.append(tuple(rot))
        self.ell_rad.append(float(radius))
        self.ell_mat.append(int(m))

    def add_sphere(self, center, radius: float, m: int):
        """A unit-stretch ellipsoid."""
        self.add_ellipsoid(center, (1.0, 1.0, 1.0), (0.0, 0.0, 0.0),
                           radius, m)

    def add_disk_light(self, center, radius: float, m: int, kind: int = 3,
                       id_start: int = 0, id_end: int = 0):
        """Legacy emissive-disk light (raytrace.glsl EmissiveData), read by
        RenderConfig.legacy_shading and legacy_pathtrace: a disk at
        `center` of `radius` that emits material m's Ke, bound to the
        primitives a shadow ray must reach (kind 1 triangles or 3
        ellipsoids, ids id_start..id_end)."""
        self.disk_lights.append((int(kind), int(id_start), int(id_end),
                                 int(m), tuple(float(c) for c in center),
                                 float(radius)))

    def add_emissive_sphere(self, center, radius: float, m: int):
        """A sphere of material m and the disk light bound to it."""
        idx = len(self.ell_rad)
        self.add_sphere(center, radius, m)
        self.add_disk_light(center, radius, m, kind=3, id_start=idx,
                            id_end=idx)

    def add_implicit(self, fn: int, shift, scale, rot, m: int):
        """Implicit surface `fn` in 1..10 (shade/implicits.py); `build`
        refuses any other id."""
        self.imp_fn.append(int(fn))
        self.imp_shift.append(tuple(shift))
        self.imp_scale.append(tuple(scale))
        self.imp_rot.append(tuple(rot))
        self.imp_mat.append(int(m))

    # -- packing -------------------------------------------------------------
    def build(self, config: Optional[RenderConfig] = None,
              max_leaf: Optional[int] = None, validate: bool = True, *,
              device=None):
        """Build the forest (`config.sah_planes`, `max_bvh_depth`,
        `max_tris_in_leaf` or `max_leaf`), or the streamed LBVH for more
        than `config.stream_threshold` triangles, and pack onto `device`
        (default: the card). The positional arguments are the JAX
        package's (`build(config, max_leaf, validate)`); `device` is by
        keyword only. Returns (PackedScene, SceneInfo).

        validate=True (default) first runs scene/validate.py: bad material
        or texture indices, non-finite geometry and degenerate primitives
        raise SceneValidationError here, with the entity named."""
        if validate:
            validate_scene(self)
        return pack_scene(self, resolve_device(device),
                          config or RenderConfig(), max_leaf=max_leaf)
