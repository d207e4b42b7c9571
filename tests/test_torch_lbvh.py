"""The port's LBVH builders (accel/lbvh.py, accel/native_lbvh.py over
csrc/streambuild.cpp) against the JAX package's, and `add_mesh_indexed`
against `add_mesh`, on the CPU.

Both packages must build the same tree: the top-tree boxes, the subtree
boxes, the slot -> triangle permutation and the packed triangles are
held bit-equal (the port stores one box per 8-float row and one triangle
per 9-float row, the JAX package 128-lane rows, so the comparison reads
the JAX tables' live lanes). Flat normals of an indexed mesh are held to
1e-6 against the JAX package's float32 expansion, the tolerance of
tests/test_indexed_mesh.py.
"""
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu.accel import lbvh as jlbvh
from pathtracer0_tpu.accel import native_lbvh as jnative
from pathtracer0_tpu.scene import packing as jpacking
from pathtracer0_tpu_torch import RenderConfig, Scene
from pathtracer0_tpu_torch.accel import lbvh, native_lbvh
from pathtracer0_tpu_torch.scene import packing

torch.set_num_threads(1)


def _soup(t, seed=0, spread=20.0):
    """t small random triangles in a box of side `spread`."""
    rng = np.random.RandomState(seed)
    v1 = rng.rand(t, 3) * spread
    return v1, v1 + rng.randn(t, 3) * 0.3, v1 + rng.randn(t, 3) * 0.3


def _assert_same_forest(port, ref):
    """A port StreamedForest against a JAX one, bit for bit."""
    assert (port.n_rows, port.n_treelets, port.leaf_depth) == (
        ref.n_rows, ref.n_treelets, ref.leaf_depth)
    assert port.ctree_f.shape == (ref.cut_nodes, 8)
    np.testing.assert_array_equal(port.ctree_f, ref.ctree_f)
    np.testing.assert_array_equal(port.sub_f[:, :6], ref.sub_f[:, :6])
    np.testing.assert_array_equal(port.row_perm, ref.row_perm)
    per_row = 9 * jlbvh.TRIS_PER_ROW
    np.testing.assert_array_equal(
        port.tris, ref.tri_rows[:, :per_row].reshape(-1, 9))


def test_constants_fix_the_same_topology():
    for name in ("TRIS_PER_ROW", "TREELET_ROWS", "SUB_GROUP_ROWS",
                 "MORTON_BITS"):
        assert getattr(lbvh, name) == getattr(jlbvh, name), name
    assert (lbvh.TRIS_PER_ROW, lbvh.TREELET_ROWS, lbvh.SUB_GROUP_ROWS,
            lbvh.MORTON_BITS) == (14, 128, 4, 21)


# 50: one treelet; 1793: the first count past one treelet; 5000: four
SIZES = [50, 1793, 5000]


@pytest.mark.parametrize("t", SIZES)
def test_morton_codes_match_jax(t):
    v1, v2, v3 = _soup(t, seed=t)
    c = (v1 + v2 + v3) / 3.0
    np.testing.assert_array_equal(lbvh.morton_codes(c), jlbvh.morton_codes(c))


@pytest.mark.parametrize("t", SIZES)
def test_numpy_builder_matches_jax(t):
    v = _soup(t, seed=t)
    _assert_same_forest(lbvh._build_streamed_numpy(*v),
                        jlbvh._build_streamed_numpy(*v))


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the native builder")


@pytest.mark.parametrize("t", SIZES)
def test_native_morton_matches_numpy_and_jax(t):
    """Mode 0 of the native builder is bit-equal to the NumPy builder, the
    port's and the JAX package's."""
    _need_gxx()
    v = _soup(t, seed=t + 1)
    nat = native_lbvh.build_streamed(*v, mode=0)
    ref = lbvh._build_streamed_numpy(*v)
    again = lbvh.build_streamed(*v, order="morton")   # the native one here
    np.testing.assert_array_equal(again.row_perm, nat.row_perm)
    for field in ("ctree_f", "tris", "sub_f", "row_perm"):
        np.testing.assert_array_equal(getattr(nat, field),
                                      getattr(ref, field))
    _assert_same_forest(nat, jlbvh._build_streamed_numpy(*v))


def _jax_native_available(monkeypatch) -> bool:
    """The JAX package's native builder, loaded. Its loader compiles into
    one shared path with no temporary file, so a process that loaded the
    library while another was still writing it caches the failure; by the
    time this test runs the library is whole, so one more try after
    clearing that cache (in this test only) tells a failed build from the
    race."""
    if jnative.available():
        return True
    monkeypatch.setattr(jnative, "_LIB_FAILED", False)
    return jnative.available()


@pytest.mark.parametrize("t", SIZES)
def test_native_median_matches_jax_native(t, monkeypatch):
    """Mode 1, the default order: the port's copy of the builder against
    the JAX package's native/streambuild.cpp."""
    _need_gxx()
    if not _jax_native_available(monkeypatch):
        pytest.skip("the JAX package's native builder did not build")
    v = _soup(t, seed=t + 2)
    ref = jnative.build_streamed(
        *v, jlbvh.TRIS_PER_ROW, jlbvh.TREELET_ROWS, jlbvh.SUB_GROUP_ROWS,
        jlbvh.MORTON_BITS, mode=1)
    port = lbvh.build_streamed(*v)
    _assert_same_forest(port, ref)
    # the median order is another order than Morton's, over the same set
    morton = lbvh.build_streamed(*v, order="morton")
    assert not np.array_equal(port.row_perm, morton.row_perm)
    assert sorted(port.row_perm[:t]) == list(range(t))
    assert (port.row_perm[t:] == -1).all()


@pytest.mark.parametrize("native", [False, True])
def test_duplicate_centroids_keep_a_stable_order(native):
    """Triangles with one centroid share a Morton code: both builders keep
    them in input order (a stable sort)."""
    if native:
        _need_gxx()
    v1, v2, v3 = _soup(40, seed=5)
    v1, v2, v3 = (np.concatenate([v, v, v]) for v in (v1, v2, v3))
    f = (native_lbvh.build_streamed(v1, v2, v3, mode=0) if native
         else lbvh._build_streamed_numpy(v1, v2, v3))
    perm = f.row_perm[:120].reshape(40, 3)
    assert (np.diff(perm, axis=1) == 40).all()
    _assert_same_forest(f, jlbvh._build_streamed_numpy(v1, v2, v3))


def test_empty_rows_and_slots_mask_themselves():
    """Padding: inverted infinite boxes and zero triangles, -1 in the
    permutation; the top tree of 1,793 triangles is half empty."""
    v = _soup(1793, seed=9)
    f = lbvh._build_streamed_numpy(*v)
    assert f.n_treelets == 2 and f.n_rows == 129
    assert (f.tris[1793:] == 0).all() and (f.row_perm[1793:] == -1).all()
    n_groups = lbvh.TREELET_ROWS // lbvh.SUB_GROUP_ROWS
    second = f.sub_f[2 * n_groups:]
    empty_group = second[n_groups - 1 + 1]     # rows 4..7 of treelet 1
    assert (empty_group[:3] == np.inf).all()
    assert (empty_group[3:6] == -np.inf).all()
    # every real box holds its triangles
    assert np.isfinite(f.ctree_f[0, :6]).all()
    lo = np.minimum(np.minimum(v[0], v[1]), v[2]).min(0).astype(np.float32)
    np.testing.assert_array_equal(f.ctree_f[0, :3], lo)


def test_build_streamed_dispatch():
    v = _soup(30)
    with pytest.raises(ValueError, match="order"):
        lbvh.build_streamed(*v, order="sah")
    with pytest.raises(ValueError, match="at least one"):
        lbvh.build_streamed(*(x[:0] for x in v))
    assert lbvh.shape(1) == (1, 1, 128)
    assert lbvh.shape(14 * 128) == (128, 1, 128)
    assert lbvh.shape(14 * 128 + 1) == (129, 2, 256)
    assert lbvh.shape(999_698) == (71_407, 1024, 131_072)
    assert packing.stream_stack_need(1) == 6
    assert packing.stream_stack_need(1024) == 16
    assert native_lbvh.available() == (shutil.which("g++") is not None)


# ---- indexed meshes --------------------------------------------------------

def _height_field(n, seed=0):
    """(verts (n*n, 3), faces (2 (n-1)^2, 3)) of a bumpy grid."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-3.0, 3.0, n)
    X, Z = np.meshgrid(xs, xs)
    Y = np.sin(X) * np.cos(Z) * 0.5 + rng.rand(n, n) * 0.2
    g = np.arange(n * n).reshape(n, n)
    a, b = g[:-1, :-1].reshape(-1), g[1:, :-1].reshape(-1)
    c, d = g[:-1, 1:].reshape(-1), g[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([a, b, c], 1), np.stack([d, b, c], 1)])
    return np.stack([X, Y, Z + 6.0], -1).reshape(-1, 3), faces


def _packed(fill, **cfg):
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    fill(sc)
    return sc.build(device="cpu", config=RenderConfig(**cfg))


@pytest.mark.parametrize("smooth,with_uv", [(False, False), (True, True),
                                            (True, False), (False, True)])
def test_add_mesh_indexed_matches_add_mesh(smooth, with_uv):
    """Positions, smooth normals and UVs of the indexed mesh are gathers
    and so bit-equal to the expanded mesh's; flat normals within 1e-6."""
    verts, faces = _height_field(9)
    rng = np.random.RandomState(1)
    vn = rng.randn(len(verts), 3) if smooth else None
    vuv = rng.rand(len(verts), 2) if with_uv else None

    def corners(tab):
        return None if tab is None else tuple(tab[faces[:, c]]
                                              for c in range(3))

    a, ia = _packed(lambda sc: sc.add_mesh_indexed(verts, faces, 0,
                                                   normals=vn, uvs=vuv))
    b, ib = _packed(lambda sc: sc.add_mesh(*corners(verts), 0,
                                           normals=corners(vn),
                                           uvs=corners(vuv)))
    assert ia == ib and ia.num_tris == 128
    assert ia.any_smooth == smooth and ia.any_uv == with_uv
    assert torch.equal(a.tris, b.tris)
    assert torch.equal(a.uvt, b.uvt)
    if smooth:
        assert torch.equal(a.attr, b.attr)
    else:
        assert float((a.attr - b.attr).abs().max()) <= 1e-6


def test_indexed_flat_normals_match_the_jax_expansion():
    """The JAX package expands a big indexed mesh on the device and takes
    its flat normals in float32 there (`_idx_tables_impl`); the port's,
    taken in float64 on the host, agree to 1e-6. Positions are bit-equal."""
    verts, faces = _height_field(12, seed=3)
    sc, info = _packed(lambda s: s.add_mesh_indexed(verts, faces, 0),
                       stream_threshold=0)
    assert info.streamed
    tabs = jpacking._idx_tables_impl(
        jnp.asarray(verts, jnp.float32), jnp.asarray(faces, jnp.int32),
        None, None, 0, False, False)
    n1 = np.asarray(tabs["n1"])
    attr = sc.attr.numpy()
    assert np.abs(attr[:, 0:3] - n1).max() <= 1e-6
    np.testing.assert_array_equal(attr[:, 0:3], attr[:, 3:6])
    np.testing.assert_array_equal(attr[:, 9], 0.0)
    np.testing.assert_array_equal(sc.tris[:, 0:3].numpy(),
                                  np.asarray(tabs["v1"]))
