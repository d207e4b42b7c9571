"""Port scene building (pathtracer0_tpu_torch.scene) against the JAX
package's Scene.build for BASELINE configs 1-6: the material, ellipsoid and
implicit tables equal, the triangle set equal as a set, the gates equal,
and scene_from_numpy carrying the JAX scene across intact; and
`Scene.build` taking its config positionally, as the JAX package's does.
"""
import numpy as np
import pytest
import torch

from pathtracer0_tpu import scenes as jscenes
from pathtracer0_tpu_torch import RenderConfig
from pathtracer0_tpu_torch import scenes as tscenes
from pathtracer0_tpu_torch.scene import packing
from pathtracer0_tpu_torch.scene.scene import Scene
from pathtracer0_tpu_torch.scene.validate import SceneValidationError

torch.set_num_threads(1)

CONFIGS = (1, 2, 3, 4, 5, 6)
FS_FIELDS = ("fs_tris", "fs_attr", "fs_uvt", "fs_maps", "fs_sky",
             "materials", "ell_tab", "imp_tab", "tex_data", "tex_sizes")


def _jax(n):
    dev, info = jscenes.BUILDERS[n]().build(max_leaf=4)
    return dev, info


def _tri_set(tris, attr, uvt):
    rows = np.concatenate([tris, attr, uvt], axis=1)
    return sorted(map(tuple, np.round(rows.astype(np.float64), 6)))


@pytest.mark.parametrize("n", CONFIGS)
def test_build_matches_jax(n):
    dev, info = _jax(n)
    sc, pinfo = tscenes.BUILDERS[n]().build(device="cpu")
    np.testing.assert_array_equal(sc.materials.numpy(),
                                  np.asarray(dev.materials))
    np.testing.assert_array_equal(sc.ell_tab.numpy(),
                                  np.asarray(dev.ell_tab))
    np.testing.assert_array_equal(sc.imp_tab.numpy(),
                                  np.asarray(dev.imp_tab))
    assert pinfo.mat_gates == info.mat_gates
    assert pinfo.ell_rotated == info.ell_rotated
    assert pinfo.imp_rotated == info.imp_rotated
    assert pinfo.imp_fn_ids == info.imp_fn_ids
    assert pinfo.map_bindings == info.fs_map_bindings
    h, w = (int(x) for x in np.asarray(dev.tex_sizes)[0])
    np.testing.assert_array_equal(
        sc.sky.numpy(), np.asarray(dev.tex_data)[0, :h, :w].reshape(-1, 3))
    # the same triangles (JAX keeps BVH leaf order, the port insertion
    # order)
    via_jax, _ = packing.scene_from_numpy(
        {k: np.asarray(getattr(dev, k)) for k in FS_FIELDS}, info._asdict(),
        device="cpu")
    assert pinfo.num_tris == via_jax.tris.shape[0] or pinfo.num_tris == 0
    if pinfo.num_tris:
        assert _tri_set(sc.tris.numpy(), sc.attr.numpy(), sc.uvt.numpy()) \
            == _tri_set(via_jax.tris.numpy(), via_jax.attr.numpy(),
                        via_jax.uvt.numpy())
        np.testing.assert_array_equal(sc.atlas.numpy(),
                                      via_jax.atlas.numpy())


@pytest.mark.parametrize("n", CONFIGS)
def test_scene_from_numpy_round_trip(n):
    """Every packed table of the JAX scene comes across unchanged: the
    dense 14-/12-slot lane rows re-flatten to the JAX triangle order."""
    dev, info = _jax(n)
    sc, pinfo = packing.scene_from_numpy(
        {k: np.asarray(getattr(dev, k)) for k in FS_FIELDS}, info._asdict(),
        device="cpu")
    fs_tris = np.asarray(dev.fs_tris)
    assert pinfo.num_ellipsoids == info.num_ellipsoids
    assert pinfo.num_implicits == info.num_implicits
    assert pinfo.mat_gates == info.mat_gates
    assert pinfo.map_bindings == info.fs_map_bindings
    for t in range(pinfo.num_tris):
        row, j = divmod(t, 14)
        np.testing.assert_array_equal(sc.tris[t].numpy(),
                                      fs_tris[row, 9 * j:9 * j + 9])
        arow, aj = divmod(t, 12)
        np.testing.assert_array_equal(
            sc.attr[t].numpy(), np.asarray(dev.fs_attr)[arow,
                                                       10 * aj:10 * aj + 10])
    for (h, w, off), (jh, jw, base, rpy) in zip(pinfo.map_shapes,
                                                 info.fs_map_shapes):
        assert (h, w) == (jh, jw)
        img = sc.atlas[off:off + h * w].numpy().reshape(h, w, 3)
        block = np.asarray(dev.fs_maps)[base:base + h * rpy]
        np.testing.assert_array_equal(
            img, block.reshape(h, rpy * 128)[:, :w * 3].reshape(h, w, 3))
    np.testing.assert_array_equal(sc.materials.numpy(),
                                  np.asarray(dev.materials))


def test_scene_from_numpy_needs_the_card_or_cpu():
    """A JAX scene carried across lands on the card by default: without a
    card that raises, and device="cpu" is the caller's choice."""
    dev, info = _jax(6)
    arrays = {k: np.asarray(getattr(dev, k)) for k in FS_FIELDS}
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        packing.scene_from_numpy(arrays, info._asdict())
    sc, pinfo = packing.scene_from_numpy(arrays, info._asdict(), device="cpu")
    assert sc.device == torch.device("cpu")
    assert pinfo.num_ellipsoids == info.num_ellipsoids


def test_scene_api_limits():
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.7))
    sc.add_material("a")
    with pytest.raises(FileNotFoundError):
        sc.add_object("x.obj")
    with pytest.raises(ValueError, match="face index"):
        sc.add_mesh_indexed(np.zeros((3, 3)), np.array([[0, 1, 3]]), 0)
    with pytest.raises(ValueError, match="per-vertex"):
        sc.add_mesh_indexed(np.zeros((3, 3)), np.array([[0, 1, 2]]), 0,
                            normals=np.ones((2, 3)))
    bad_fn = Scene()
    bad_fn.add_material("a")
    bad_fn.add_implicit(11, (0, 0, 0), (1, 1, 1), (0, 0, 0), 0)
    with pytest.raises(SceneValidationError, match="function id"):
        bad_fn.build(device="cpu")
    sc.add_sphere((0, 0, 3), 1.0, m=1)
    with pytest.raises(SceneValidationError, match="material 1"):
        sc.build(device="cpu")
    # packing's own check stays the last guard
    with pytest.raises(ValueError, match="material id"):
        sc.build(device="cpu", validate=False)
    big = Scene()
    big.add_material("a")
    v = np.random.RandomState(0).rand(65, 3)
    big.add_mesh(v, v + [1, 0, 0], v + [0, 1, 0], 0)
    # past stream_threshold: the streamed LBVH and no forest
    _, info = big.build(device="cpu", config=RenderConfig(stream_threshold=64))
    assert info.streamed and info.num_objects == 0 and info.num_tris == 65
    _, info = big.build(device="cpu")
    assert info.num_tris == 65 and info.num_objects == 1
    assert not info.streamed


def test_parse_mtl_matches_jax(tmp_path):
    """The port's own copy of parse_mtl gives the JAX package's records and
    texture slots for every key it reads, malformed lines included."""
    from pathtracer0_tpu.scene import material as jmat
    from pathtracer0_tpu.scene import texture as jtex
    from pathtracer0_tpu_torch.scene import material as tmat
    from pathtracer0_tpu_torch.scene import texture as ttex
    from pathtracer0_tpu_torch.utils import image as img_util

    rng = np.random.RandomState(3)
    img_util.write_png(str(tmp_path / "t.png"),
                       rng.rand(4, 5, 3).astype(np.float32))
    (tmp_path / "m.mtl").write_text(
        "newmtl glass\nKd 0.1 0.2 0.3\nKa 0.5 0.5 0.5\nKs 1 1 1\nNs 250\n"
        "Ni 1.45\nillum 7\nTf 0.9 0.8 0.7\nPr 0.05\nPm 0.1\nPc 0.5\n"
        "Pcr 0.25\nPs 0.3\naniso 0.2\nanisor 0.1\nsubsurface 0.4\n"
        "subsurfaceColor 1 0.5 0.2\nsubsurfaceRadius 1 2 3\nDensity 2\n"
        "map_Kd t.png\nbump t.png\nrefl_x t.png\nNs oops\n\n"
        "newmtl a\nd 0.3\nKe 3 0 4\n\nnewmtl b\nTr 0.2\nmap_Pm t.png\n")
    out = []
    for mod, tex in ((jmat, jtex), (tmat, ttex)):
        mats, reg = [], tex.TextureRegistry()
        mod.parse_mtl(str(tmp_path / "m.mtl"), str(tmp_path), mats, reg)
        out.append(([m.name for m in mats], mod.pack_materials(mats),
                    reg.names))
    (jn, jrec, jreg), (tn, trec, treg) = out
    assert jn == tn and jreg == treg and len(jn) == 3
    np.testing.assert_array_equal(jrec, trec)


def test_add_tri_flat_normal():
    sc = Scene()
    sc.add_material("a")
    sc.add_tri((0, 0, 0), (1, 0, 0), (0, 1, 0), 0)
    p, info = sc.build(device="cpu")
    assert info.num_tris == 1
    np.testing.assert_array_equal(p.tris[0].numpy(),
                                  [0, 0, 0, 1, 0, 0, 0, 1, 0])
    np.testing.assert_allclose(p.attr[0, :3].numpy(), [0, 0, -1])
    assert float(p.attr[0, 9]) == 0.0


def test_add_object_directory_matches_jax(tmp_path):
    """A directory with an .mtl and an .obj (two groups, `usemtl`, UVs and
    normals, a quad, a transform): both packages parse the same materials,
    triangles, object ranges and forest."""
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene

    (tmp_path / "m.mtl").write_text(
        "newmtl red\nKd 0.8 0.1 0.1\nPr 0.4\n\nnewmtl blue\nKd 0 0 1\n")
    (tmp_path / "a.obj").write_text(
        "mtllib m.mtl\no first\nusemtl red\n"
        "v 0 0 2\nv 1 0 2\nv 1 1 2.5\nv 0 1 2\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 -1\nvn 0.1 0 -1\n"
        "f 1/1/1 2/2/2 3/3/1 4/4/2\nf 1/1/1 3/3/1 4/4/2\n"
        "g second\nusemtl blue\nv 2 0 3\nv 3 0 3\nv 2 1 3\n"
        "f 5 6 7\nf 5//1 7//1 6//2\n")
    kw = dict(material=0, scale=(1.0, 2.0, 1.0), shift=(0.5, 0.0, 1.0),
              rot=(0.1, 0.2, 0.3))
    js, ts = JScene(), Scene()
    for sc in (js, ts):
        sc.set_constant_sky((0.5, 0.5, 0.5))
        sc.add_material("default")
        sc.add_object(str(tmp_path), **kw)
    assert [m.name for m in ts.materials] == [m.name for m in js.materials]
    assert ts.tris.object_ranges == js.tris.object_ranges == [(0, 2), (2, 4)]
    assert ts.tris.mat == js.tris.mat
    assert ts.tris.has_uv == js.tris.has_uv == [True, True, False, False]
    assert ts.tris.has_smooth == js.tris.has_smooth
    for name in ("v1", "v2", "v3", "n1", "n2", "n3", "uv1", "uv2", "uv3"):
        np.testing.assert_array_equal(np.stack(getattr(ts.tris, name)),
                                      np.stack(getattr(js.tris, name)))
    dev, info = js.build(JConfig())
    p, pinfo = ts.build(device="cpu")
    np.testing.assert_array_equal(p.materials.numpy(),
                                  np.asarray(dev.materials))
    np.testing.assert_array_equal(p.roots.numpy(), np.asarray(dev.roots))
    np.testing.assert_array_equal(p.tri_obj.numpy(), np.asarray(dev.tri_obj))
    np.testing.assert_array_equal(p.attr[:, 0:3].numpy(),
                                  np.asarray(dev.tri_n1))
    assert pinfo.any_uv == info.any_uv and pinfo.any_smooth == info.any_smooth
    with pytest.raises(FileNotFoundError):
        ts.add_object(str(tmp_path / "m.mtl"))


def _wavy_grid(sc):
    """A 12 x 12 height field of 242 triangles in one mesh, over a
    ground sphere."""
    xs = np.linspace(-3.0, 3.0, 12)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X) * np.cos(Z) * 0.4, Z + 6.0], -1)
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    sc.add_mesh(np.concatenate([a.reshape(-1, 3), d.reshape(-1, 3)]),
                np.concatenate([b.reshape(-1, 3)] * 2),
                np.concatenate([c.reshape(-1, 3)] * 2), 0)
    sc.add_sphere((0.0, -101.0, 6.0), 100.0, m=0)
    return sc


@pytest.mark.parametrize("case", ["mesh", "config1"])
def test_build_takes_the_config_positionally(case):
    """`build(config, max_leaf, validate, *, device)`: the JAX package's
    call form `build(RenderConfig(...))` with the device by keyword builds
    the same forest, bit for bit, as the JAX `build(JConfig(...))`."""
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene

    if case == "mesh":
        kw = dict(sah_planes=1, max_tris_in_leaf=4)
        dev, info = _wavy_grid(JScene()).build(JConfig(**kw))
        sc, pinfo = _wavy_grid(Scene()).build(RenderConfig(**kw),
                                              device="cpu")
        assert pinfo.num_tris == dev.num_tris == 242
    else:
        dev, info = jscenes.BUILDERS[1]().build(JConfig())
        sc, pinfo = tscenes.BUILDERS[1]().build(RenderConfig(), device="cpu")
        assert pinfo.num_tris == 0 and pinfo.num_ellipsoids == 4
    assert sc.device == torch.device("cpu")
    assert pinfo.num_objects == info.num_objects
    np.testing.assert_array_equal(sc.materials.numpy(),
                                  np.asarray(dev.materials))
    np.testing.assert_array_equal(sc.ell_tab.numpy(),
                                  np.asarray(dev.ell_tab))
    if pinfo.num_tris:
        assert pinfo.max_leaf_size == info.max_leaf_size
        np.testing.assert_array_equal(sc.nodes_f[:, 0:3].numpy(),
                                      np.asarray(dev.node_min))
        np.testing.assert_array_equal(sc.nodes_f[:, 3:6].numpy(),
                                      np.asarray(dev.node_max))
        np.testing.assert_array_equal(sc.nodes_i[:, 0].numpy(),
                                      np.asarray(dev.node_left))
        np.testing.assert_array_equal(sc.wf_perm.numpy(),
                                      np.asarray(dev.leaf_tri))
        np.testing.assert_array_equal(sc.tri_obj.numpy(),
                                      np.asarray(dev.tri_obj))
        np.testing.assert_array_equal(sc.roots.numpy(),
                                      np.asarray(dev.roots))
    # the positional max_leaf and validate are the JAX package's too
    _, leaf2 = _wavy_grid(Scene()).build(RenderConfig(sah_planes=1), 2,
                                         False, device="cpu")
    assert leaf2.max_leaf_size <= 2
