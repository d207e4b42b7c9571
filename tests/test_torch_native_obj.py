"""The port's native OBJ parser (scene/native_obj.py over
csrc/objparse.cpp) against the JAX package's line-by-line parser and the
port's own, on the CPU.

The JAX side parses with PT0_NATIVE_OBJ=0: tests/test_native_obj.py
already pins the JAX package's native parser to its Python one, and its
native library is compiled in place by every worker that loads it, so a
case held against it could skip at random. The port's tokenizer is built
through kernels/build.py (a temporary file, then a rename).

Tolerances. Against the JAX package's parser: the packed triangle
tables within 1e-6 (tests/test_native_obj.py's limit: the vertex
transform runs per vertex there, vectorized here), materials, flags,
object structure and UV masks equal. Against the port's own parser: every
packed table equal to every bit, but the UV fields of triangles without
UVs (where add_mesh and the parsers may store different placeholders).
"""
import dataclasses

import numpy as np
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu_torch import RenderConfig, Scene, scenes
from pathtracer0_tpu_torch.kernels import build
from pathtracer0_tpu_torch.scene import native_obj

torch.set_num_threads(1)

TRANSFORMS = {"plain": dict(material=0),
              "transformed": dict(material=1, scale=(0.5, 2.0, 1.0),
                                  shift=(3.0, -1.0, 2.0),
                                  rot=(0.3, 0.7, 0.1))}


def _mixed_obj(path):
    """tests/test_native_obj.py's OBJ: vt/vn faces, a quad, usemtl, three
    objects (o and g), the UV sentinel and missing normals."""
    lines = [
        "mtllib fake.mtl",
        "o first",
        "v 0 0 5", "v 1 0 5", "v 0 1 5", "v 1 1 5",
        "vt 0.1 0.2", "vt 0.9 0.2", "vt 0.1 0.8",
        "vn 0 0 -1", "vn 0 0.2 -1", "vn 0.1 0 -1",
        "usemtl red",
        "f 1/1/1 2/2/2 3/3/3",
        "f 1/1 2/2 3/3",            # no normals -> flat
        "f 1 2 4 3",                 # quad, no uv/vn -> truncated + flat
        "g second",                  # material resets to the default
        "v -1 0 7", "v 1 0 7", "v 0 2 7",
        "f 5 6 7",
        "usemtl blue",
        "f 5 7 6",
        "o third",
        "v 0 0 9", "v 2 0 9", "v 0 2 9",
        "vt 69.420 0.5", "vt 0.5 0.5", "vt 0.6 0.6",
        "f 8/4 9/5 10/6",            # u == sentinel -> has_uv False
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _materials(sc):
    sc.set_constant_sky()
    sc.add_material("red")
    sc.set_last_mtl("Kd", (0.8, 0.1, 0.1))
    sc.add_material("blue")
    sc.set_last_mtl("Kd", (0.1, 0.1, 0.8))
    return sc


def _load(scene_cls, path, native, monkeypatch, **kw):
    monkeypatch.setenv("PT0_NATIVE_OBJ", "1" if native else "0")
    sc = _materials(scene_cls())
    sc.add_object(path, **kw)
    monkeypatch.delenv("PT0_NATIVE_OBJ")
    return sc


@pytest.fixture
def mixed(tmp_path):
    path = str(tmp_path / "mixed.obj")
    _mixed_obj(path)
    return path


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_native_matches_the_jax_parser(mixed, monkeypatch, case):
    """The port's native parse against the JAX package's line-by-line
    parse of the same file: triangles, normals, materials, flags, UVs,
    objects."""
    kw = TRANSFORMS[case]
    ts = _load(Scene, mixed, True, monkeypatch, **kw)
    js = _load(JScene, mixed, False, monkeypatch, **kw)
    assert len(ts.tris) == 0 and len(ts.bulk_meshes) == 3
    dev, info = js.build(JConfig(max_tris_in_leaf=4))
    p, pinfo = ts.build(RenderConfig(max_tris_in_leaf=4), device="cpu")
    assert pinfo.num_tris == np.asarray(dev.tri_v1).shape[0] == 6
    assert pinfo.num_objects == info.num_objects == 3
    j = {k: np.asarray(getattr(dev, k), np.float64) for k in (
        "tri_v1", "tri_v2", "tri_v3", "tri_n1", "tri_n2", "tri_n3",
        "tri_uv1", "tri_uv2", "tri_uv3", "tri_has_uv", "tri_has_smooth",
        "tri_mat")}
    tris = p.tris.numpy().astype(np.float64)
    attr, uvt = p.attr.numpy(), p.uvt.numpy()
    np.testing.assert_allclose(tris[:, 0:3], j["tri_v1"], atol=1e-6)
    np.testing.assert_allclose(tris[:, 0:3] + tris[:, 3:6], j["tri_v2"],
                               atol=1e-6)
    np.testing.assert_allclose(tris[:, 0:3] + tris[:, 6:9], j["tri_v3"],
                               atol=1e-6)
    for k in range(3):
        np.testing.assert_allclose(attr[:, 3 * k:3 * k + 3],
                                   j[f"tri_n{k + 1}"], atol=1e-6)
    np.testing.assert_array_equal(attr[:, 9],
                                  2 * j["tri_mat"] + j["tri_has_smooth"])
    np.testing.assert_array_equal(uvt[:, 9], j["tri_has_uv"])
    has_uv = uvt[:, 9] > 0
    assert has_uv.tolist() == [True, True, False, False, False, False]
    for k in range(3):
        np.testing.assert_allclose(uvt[has_uv, 2 * k:2 * k + 2],
                                   j[f"tri_uv{k + 1}"][has_uv], atol=1e-6)
    np.testing.assert_array_equal(p.roots.numpy(), np.asarray(dev.roots))
    np.testing.assert_array_equal(p.tri_obj.numpy(), np.asarray(dev.tri_obj))


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_native_matches_the_port_parser(mixed, monkeypatch, case):
    """The two parsers of the port build the same scene to every bit, but
    the UV fields of triangles without UVs."""
    kw = TRANSFORMS[case]
    nat = _load(Scene, mixed, True, monkeypatch, **kw)
    py = _load(Scene, mixed, False, monkeypatch, **kw)
    assert len(py.bulk_meshes) == 0 and py.tris.object_ranges == [
        (0, 3), (3, 5), (5, 6)]
    cfg = RenderConfig(max_tris_in_leaf=4)
    (a, ia), (b, ib) = (s.build(cfg, device="cpu") for s in (nat, py))
    assert ia == ib
    has_uv = b.uvt[:, 9] > 0
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "uvt":
            x, y = x[has_uv], y[has_uv]
            assert torch.equal(a.uvt[:, 9], b.uvt[:, 9])
        assert x.shape == y.shape and torch.equal(x, y), f.name


def test_segments_are_bulk_meshes(mixed, monkeypatch):
    """One bulk mesh per o/g segment, with the keys add_mesh writes; the
    material resets at each segment and usemtl's last match wins."""
    sc = _load(Scene, mixed, True, monkeypatch)
    ref = Scene()
    ref.add_mesh(np.zeros((1, 3)), np.ones((1, 3)), np.eye(3)[:1], 0)
    assert [set(m) for m in sc.bulk_meshes] == [set(ref.bulk_meshes[0])] * 3
    assert [m["mat"].tolist() for m in sc.bulk_meshes] == [
        [0, 0, 0], [0, 1], [0]]
    assert [m["has_smooth"].tolist() for m in sc.bulk_meshes] == [
        [True, False, False], [False, False], [False]]
    # the quad keeps its first three vertices
    np.testing.assert_array_equal(sc.bulk_meshes[0]["v3"][2], [1, 1, 5])
    # a later material of the same name wins
    sc2 = _materials(Scene())
    sc2.add_material("red")
    monkeypatch.setenv("PT0_NATIVE_OBJ", "1")
    sc2.add_object(mixed)
    assert sc2.bulk_meshes[0]["mat"].tolist() == [2, 2, 2]


@pytest.mark.parametrize("force, threshold, native", [
    (None, None, False), (None, 64, True), ("0", 64, False),
    ("1", None, True)])
def test_size_routing(mixed, monkeypatch, force, threshold, native):
    """Files past NATIVE_OBJ_THRESHOLD bytes (4 MiB, the JAX package's)
    go to the native parser; PT0_NATIVE_OBJ=1 forces it, 0 forbids it."""
    assert Scene.NATIVE_OBJ_THRESHOLD == JScene.NATIVE_OBJ_THRESHOLD \
        == 4 << 20
    if threshold is not None:
        monkeypatch.setattr(Scene, "NATIVE_OBJ_THRESHOLD", threshold)
    if force is None:
        monkeypatch.delenv("PT0_NATIVE_OBJ", raising=False)
    else:
        monkeypatch.setenv("PT0_NATIVE_OBJ", force)
    sc = _materials(Scene())
    sc.add_object(mixed)
    assert (len(sc.bulk_meshes), len(sc.tris)) == ((3, 0) if native
                                                   else (0, 6))


def test_no_fallback_when_the_tokenizer_cannot_be_built(
        mixed, monkeypatch, tmp_path):
    """Where the native parser is chosen and g++ cannot build it, the load
    raises; the line-by-line parser still serves PT0_NATIVE_OBJ=0."""
    def no_gxx():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(build, "gxx", no_gxx)
    monkeypatch.setattr(build, "BUILD", tmp_path / "empty_build")
    monkeypatch.delitem(build._libs, "objparse", raising=False)
    assert not native_obj.available()
    monkeypatch.setenv("PT0_NATIVE_OBJ", "1")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        _materials(Scene()).add_object(mixed)
    monkeypatch.setenv("PT0_NATIVE_OBJ", "0")
    sc = _materials(Scene())
    sc.add_object(mixed)
    assert len(sc.tris) == 6


def write_obj(path, verts, faces, name="terrain"):
    """An OBJ of one object: `v` in %.17g (float64 round trip), `f` in the
    given vertex order, no vt or vn."""
    with open(path, "w") as f:
        f.write(f"o {name}\n")
        np.savetxt(f, verts, fmt="v %.17g %.17g %.17g")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")


def test_terrain_obj_matches_the_indexed_mesh(tmp_path, monkeypatch):
    """scenes.terrain as an OBJ, natively parsed and streamed, against the
    same mesh through add_mesh_indexed: the LBVH and every packed field
    equal to every bit, but the UV fields (the sentinel against zeros;
    no triangle has UVs)."""
    ref = scenes.terrain(12)
    path = str(tmp_path / "terrain.obj")
    write_obj(path, *scenes.terrain_mesh(12))
    sc = scenes.terrain_materials(Scene())
    monkeypatch.setenv("PT0_NATIVE_OBJ", "1")
    sc.add_object(path)
    cfg = RenderConfig(stream_threshold=0)
    (a, ia), (b, ib) = (s.build(cfg, device="cpu") for s in (sc, ref))
    assert ia.streamed and ia == ib and ia.num_tris == 2 * 11 * 11
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "uvt":
            x, y = x[:, 6:], y[:, 6:]
        assert torch.equal(x, y), f.name

