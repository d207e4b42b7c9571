"""The port's forest modules (accel/bvh.py, kernels/intersect.py ray_box,
kernels/wavefront.py, kernels/traverse.py) against the JAX package on the
generated meshes of tests/test_wavefront.py, run as that package's own
tests run it on the CPU: its Pallas kernels in interpret mode
(pallas="interpret") and its vmapped traversal (pallas="off").

Tolerances: t within rtol/atol 1e-5, triangle id equal on >= 99.9% of the
rays (ties at shared edges), switched-off rays exact, the port's per-ray
counters equal to `traverse._traverse_object`'s summed over the objects,
surface_sample fields within 1e-5.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.accel import bvh as jbvh
from pathtracer0_tpu.kernels import intersect as jintersect
from pathtracer0_tpu.kernels import traverse as jtraverse
from pathtracer0_tpu.kernels import wavefront as jwavefront
from pathtracer0_tpu_torch import RenderConfig, Scene
from pathtracer0_tpu_torch.accel import bvh as tbvh
from pathtracer0_tpu_torch.kernels import intersect as tintersect
from pathtracer0_tpu_torch.kernels import traverse as ttraverse
from pathtracer0_tpu_torch.kernels import wavefront as twavefront
from pathtracer0_tpu_torch.scene import packing

torch.set_num_threads(1)

MISS = np.float32(1e30)


def _rand_rays(n, seed=3, center=(0.0, 0.5, 3.0), spread=4.0, aim=None):
    """Random origins around `center`; random directions, or with `aim`
    directions scattered around that vector."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * spread + np.asarray(
        center, np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    if aim is not None:
        d = d * np.float32(0.08) + np.asarray(aim, np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tri_grid_obj(path, nx, nz, jitter=0.3, seed=0):
    """A jittered triangle grid in one OBJ object
    (tests/test_wavefront.py)."""
    rng = np.random.RandomState(seed)
    lines = ["o grid"]
    vid = 0
    faces = []
    for i in range(nx):
        for k in range(nz):
            bx, bz = i * 0.7, k * 0.7
            by = rng.rand() * 1.5
            p = np.array([[bx, by, bz],
                          [bx + 0.6, by + rng.randn() * jitter, bz],
                          [bx, by + rng.randn() * jitter, bz + 0.6]])
            for v in p:
                lines.append(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}")
            faces.append(f"f {vid + 1} {vid + 2} {vid + 3}")
            vid += 3
    lines += faces
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _clump_obj(path):
    """14 triangles with coincident centroids: SAH cannot split them."""
    lines = ["o clump"]
    base = np.zeros(3)
    for _ in range(14):
        for v in (base, base + (0.5, 0, 0), base + (0, 0.5, 0)):
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2] + 5:.6f}")
    for k in range(14):
        lines.append(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _many_obj(path, n=33):
    """n one-triangle objects: more roots than the TPU kernel takes."""
    lines = []
    for k in range(n):
        lines.append(f"o obj{k}")
        z = 2.0 + k * 0.1
        lines += [f"v 0 0 {z}", f"v 1 0 {z}", f"v 0 1 {z}"]
        lines.append(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# name -> (writer, max_leaf, ray centre, ray spread, port goes brute)
MESHES = {
    "grid12": (functools.partial(_tri_grid_obj, nx=12, nz=12), 4,
               (4.0, 1.0, 4.0), 4.0, True),
    "grid40": (functools.partial(_tri_grid_obj, nx=40, nz=40), 2,
               (14.0, 1.0, 14.0), 12.0, False),
    "clump": (_clump_obj, 1, (0.2, 0.2, 0.0), 0.5, True),
    "many": (_many_obj, 4, (0.3, 0.3, 0.0), 0.5, True),
}
AIM = {"clump": (0.0, 0.0, 1.0), "many": (0.0, 0.0, 1.0)}


class Pair:
    """One OBJ built by both packages, plus the JAX scene carried across."""

    def __init__(self, name, tmp):
        writer, self.max_leaf, self.center, self.spread, self.brute = \
            MESHES[name]
        self.aim = AIM.get(name)
        self.path = str(tmp / f"{name}.obj")
        writer(self.path)
        js = JScene()
        js.set_constant_sky((0.3, 0.3, 0.3))
        js.add_material("m")
        js.add_object(self.path, material=0)
        self.jscene = js
        self.dev, self.info = js.build(
            JConfig(stream_threshold=10 ** 9, max_tris_in_leaf=self.max_leaf))
        ts = Scene()
        ts.set_constant_sky((0.3, 0.3, 0.3))
        ts.add_material("m")
        ts.add_object(self.path, material=0)
        self.tscene = ts
        self.sc, self.pinfo = ts.build(
            device="cpu", config=RenderConfig(max_tris_in_leaf=self.max_leaf))

    def rays(self, n, seed=3):
        return _rand_rays(n, seed, self.center, self.spread, self.aim)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("objs")
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Pair(name, tmp)
        return cache[name]
    return get


def _soa(a):
    t = torch.tensor(np.asarray(a))
    return tuple(t[:, i].contiguous() for i in range(t.shape[1]))


def _aos(v):
    return torch.stack(list(v), dim=-1).numpy()


def _assert_hits(t_a, tri_a, t_b, tri_b):
    assert np.allclose(t_a, t_b, rtol=1e-5, atol=1e-5)
    assert (np.asarray(tri_a) == np.asarray(tri_b)).mean() >= 0.999


@pytest.mark.parametrize("name", list(MESHES))
def test_build_forest_equals_jax(pairs, name):
    """The port's copy of the SAH builder gives the same arrays, and the
    packed tables hold them."""
    p = pairs(name)
    t = p.tscene.tris
    args = (np.stack(t.v1), np.stack(t.v2), np.stack(t.v3), t.object_ranges)
    kw = dict(sah_planes=5, max_depth=256, max_leaf=p.max_leaf)
    fj, ft = jbvh.build_forest(*args, **kw), tbvh.build_forest(*args, **kw)
    for field in ("node_min", "node_max", "leaf_start", "leaf_end", "left",
                  "right", "leaf_tri_indices", "roots"):
        np.testing.assert_array_equal(getattr(fj, field), getattr(ft, field))
    np.testing.assert_array_equal(p.sc.nodes_f[:, 0:3].numpy(),
                                  np.asarray(p.dev.node_min))
    np.testing.assert_array_equal(p.sc.nodes_f[:, 3:6].numpy(),
                                  np.asarray(p.dev.node_max))
    np.testing.assert_array_equal(p.sc.nodes_i[:, 0].numpy(),
                                  np.asarray(p.dev.node_left))
    np.testing.assert_array_equal(p.sc.wf_perm.numpy(),
                                  np.asarray(p.dev.leaf_tri))
    np.testing.assert_array_equal(p.sc.tri_obj.numpy(),
                                  np.asarray(p.dev.tri_obj))
    np.testing.assert_array_equal(p.sc.roots.numpy(), np.asarray(p.dev.roots))
    assert p.pinfo.num_objects == p.info.num_objects
    assert p.pinfo.max_leaf_size == p.info.max_leaf_size
    assert p.pinfo.any_uv == p.info.any_uv
    assert p.pinfo.any_smooth == p.info.any_smooth
    assert twavefront.use_brute(p.pinfo) == p.brute
    assert p.pinfo.forest_depth == packing.forest_depth(
        fj.left, fj.right, fj.roots)


def test_ray_box_equals_jax():
    rng = np.random.RandomState(11)
    n = 1024
    o = rng.randn(n, 3).astype(np.float32) * 3
    lo = rng.randn(n, 3).astype(np.float32) * 2
    hi = lo + rng.rand(n, 3).astype(np.float32) * 3
    # aimed near the boxes, so about half the rays hit
    d = ((lo + hi) / 2 - o + rng.randn(n, 3) * 1.5).astype(np.float32)
    d[::7, 0] = 0.0          # axis-parallel rays
    d[::11, 1] = 0.0
    o[::13] = lo[::13]       # origins on a box plane
    ref = np.asarray(jintersect.ray_box(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(lo), jnp.asarray(hi)))
    inv = tuple(tintersect.safe_inv_dir(c) for c in _soa(d))
    np.testing.assert_array_equal(
        _aos(inv), np.asarray(jintersect.safe_inv_dir(jnp.asarray(d))))
    ours = tintersect.ray_box(_soa(o), inv, _soa(lo), _soa(hi)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert 0.1 < (ref < 1e29).mean() < 0.9


@pytest.mark.parametrize("name", ["grid12", "grid40", "clump"])
def test_trace_forest_matches_jax_kernels(pairs, name):
    """The plain versions of the brute and traverse kernels against the
    Pallas kernels in interpret mode, some rays switched off."""
    p = pairs(name)
    o, d = p.rays(1024)
    on = o + np.float32(1e-4) * d
    t_init = np.where(np.arange(1024) % 5 == 0, 0.0, MISS).astype(np.float32)
    leaf_cap = max(p.info.max_leaf_size, 1)
    tj, _, _, ij, _, _ = jwavefront.trace_forest(
        jnp.asarray(on.T), jnp.asarray(d.T), jnp.asarray(t_init),
        p.dev.wf_roots, p.dev.wf_nodes_f, p.dev.wf_nodes_i, p.dev.wf_tris,
        leaf_cap=leaf_cap, block_rows=8, interpret=True)
    ij = np.asarray(ij)
    tri_j = np.where(ij >= 0, np.asarray(p.dev.wf_perm)[np.maximum(ij, 0)],
                     -1)
    tt, _, _, it, box, leaf = twavefront.trace_forest(
        _soa(on), _soa(d), torch.tensor(t_init), p.sc, p.pinfo)
    it = it.numpy()
    tri_t = np.where(it >= 0, p.sc.wf_perm.numpy()[np.maximum(it, 0)], -1)
    _assert_hits(tt.numpy(), tri_t, np.asarray(tj), tri_j)
    dead = t_init == 0.0
    assert (tt.numpy()[dead] == 0.0).all() and (tri_t[dead] == -1).all()
    assert (box.numpy()[dead] == 0).all() and (leaf.numpy()[dead] == 0).all()
    assert 0.02 < (tri_t >= 0).mean() < 0.98
    if p.brute:
        assert (box.numpy() == 0).all()
        assert (leaf.numpy()[~dead] == p.pinfo.num_leaves).all()


@pytest.mark.parametrize("name", ["grid12", "grid40"])
def test_brute_and_walk_agree(pairs, name):
    """Both plain versions on the same forest: same hits."""
    p = pairs(name)
    o, d = p.rays(512, seed=9)
    args = (_soa(o), _soa(d), torch.full((512,), float(MISS)), p.sc, p.pinfo)
    tb, ub, vb, ib, _, _ = twavefront.brute_reference(*args)
    tw, uw, vw, iw, _, _ = twavefront.traverse_reference(*args)
    torch.testing.assert_close(tb, tw, rtol=0, atol=0)
    assert float((ib == iw).float().mean()) >= 0.999
    same = ib == iw
    assert torch.equal(ub[same], uw[same]) and torch.equal(vb[same], vw[same])


def _jax_hit(p, o, d, pallas, active=None):
    hit, on = jtraverse.ray_scene(
        jnp.asarray(o), jnp.asarray(d), p.dev, p.info, pallas=pallas,
        active=None if active is None else jnp.asarray(active))
    return hit, on


@pytest.mark.parametrize("pallas", ["interpret", "off"])
@pytest.mark.parametrize("name", list(MESHES))
def test_ray_scene_matches_jax(pairs, name, pallas):
    p = pairs(name)
    if pallas == "interpret" and not p.info.wf_ok:
        # 33 roots: the Pallas kernel does not take this forest, and
        # ray_scene would fall back to the vmapped walk of the other case
        assert name == "many"
        pallas = "auto"
    o, d = p.rays(1024)
    hj, on_j = _jax_hit(p, o, d, pallas)
    ht, on_t = ttraverse.ray_scene(_soa(o), _soa(d), p.sc, p.pinfo)
    np.testing.assert_array_equal(_aos(on_t), np.asarray(on_j))
    _assert_hits(ht.t.numpy(), ht.tri.numpy(), np.asarray(hj.t),
                 np.asarray(hj.tri))
    same = ht.tri.numpy() == np.asarray(hj.tri)
    np.testing.assert_array_equal(ht.obj.numpy()[same],
                                  np.asarray(hj.obj)[same])
    np.testing.assert_array_equal(ht.kind.numpy()[same],
                                  np.asarray(hj.kind)[same])
    np.testing.assert_allclose(ht.u.numpy()[same], np.asarray(hj.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(ht.v.numpy()[same], np.asarray(hj.v)[same],
                               atol=1e-4)
    assert (ht.prim.numpy() == -1).all()


@pytest.mark.parametrize("name", ["grid12", "grid40"])
def test_dead_lanes(pairs, name):
    """Rays switched off come back t == 0, tri == -1, at no cost, and do
    not disturb their neighbours (tests/test_wavefront.py:108-121)."""
    p = pairs(name)
    o, d = p.rays(512)
    active = np.arange(512) % 3 != 0
    hm, _ = ttraverse.ray_scene(_soa(o), _soa(d), p.sc, p.pinfo,
                                active=torch.tensor(active))
    hf, _ = ttraverse.ray_scene(_soa(o), _soa(d), p.sc, p.pinfo)
    hj, _ = _jax_hit(p, o, d, "interpret", active)
    assert (hm.t.numpy()[~active] == 0.0).all()
    assert (hm.tri.numpy()[~active] == -1).all()
    assert bool(hm.is_hit[~torch.tensor(active)].all())
    np.testing.assert_array_equal(hm.t.numpy()[active],
                                  hf.t.numpy()[active])
    np.testing.assert_array_equal(hm.t.numpy()[~active],
                                  np.asarray(hj.t)[~active])
    np.testing.assert_array_equal(hm.tri.numpy()[~active],
                                  np.asarray(hj.tri)[~active])


def _jax_counts(p, o, d):
    """Per-ray (box tests, leaf visits) of the reference walk: its
    `_traverse_object` over the objects in order, each pruned by the
    closest hit so far (as `_ray_scene_scalar` does)."""
    leaf_cap = max(p.info.max_leaf_size, 1)

    def one(o1, d1):
        o1 = o1 + jnp.float32(1e-4) * d1

        def body(i, carry):
            closest, box, leaf = carry
            new_t, new_tri, _, _, (b, lf) = jtraverse._traverse_object(
                o1, d1, p.dev.roots[i], closest, p.dev, 64, leaf_cap)
            return (jnp.where(new_tri >= 0, new_t, closest), box + b,
                    leaf + lf)

        return jax.lax.fori_loop(
            0, p.info.num_objects, body,
            (jnp.float32(MISS), jnp.int32(0), jnp.int32(0)))

    t, box, leaf = jax.vmap(one)(jnp.asarray(o), jnp.asarray(d))
    return np.asarray(t), np.asarray(box), np.asarray(leaf)


@pytest.mark.parametrize("name", ["grid40", "many", "grid12", "clump"])
def test_walk_counters_equal_traverse_object(pairs, name):
    """The port counts per ray (the TPU kernel counts per block of rays):
    2 box tests per internal node visited, 1 per leaf, equal to the
    reference walk's on >= 99% of the rays (a tie between two children's
    entry distances may order them differently by an ulp)."""
    p = pairs(name)
    o, d = p.rays(512, seed=5)
    tj, bj, lj = _jax_counts(p, o, d)
    on = o + np.float32(1e-4) * d
    t, _, _, _, box, leaf = twavefront.traverse_reference(
        _soa(on), _soa(d), torch.full((512,), float(MISS)), p.sc, p.pinfo)
    assert np.allclose(t.numpy(), tj, rtol=1e-5, atol=1e-5)
    assert (box.numpy() == bj).mean() >= 0.99
    assert (leaf.numpy() == lj).mean() >= 0.99
    assert bj.max() > 0 or name in ("clump", "many")
    hb, hl = ttraverse.heat_counts(_soa(o), _soa(d), p.sc, p.pinfo)
    if not p.brute:
        assert torch.equal(hb, box) and torch.equal(hl, leaf)


def _mixed_pair():
    """A UV'd smooth mesh, a flat loose triangle, a sphere and a rotated
    ellipsoid, built by both packages."""
    out = []
    for cls, cfg in ((JScene, None), (Scene, None)):
        sc = cls()
        sc.set_constant_sky((0.3, 0.3, 0.3))
        sc.add_material("a")
        sc.add_material("b")
        v = np.array([[0, 0, 3], [2, 0, 3], [2, 2, 3.5], [0, 2, 3]],
                     np.float64)
        uv = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float64)
        n = np.array([[0.1, 0.2, -1.0], [-0.2, 0.1, -1.0], [0.0, 0.3, -1.0],
                      [0.2, 0.0, -1.0]])
        idx = [(0, 1, 2), (0, 2, 3)]

        def pick(a, j):
            return a[[i[j] for i in idx]]

        sc.add_mesh(pick(v, 0), pick(v, 1), pick(v, 2), 1,
                    normals=(pick(n, 0), pick(n, 1), pick(n, 2)),
                    uvs=(pick(uv, 0), pick(uv, 1), pick(uv, 2)))
        sc.add_tri((-2, 0, 4), (0, 0, 4), (-1, 2, 4), 0)
        sc.add_sphere((1.0, 1.0, 1.5), 0.4, m=0)
        sc.add_ellipsoid((-1.0, 0.5, 2.0), (1.0, 1.6, 0.8), (0.2, 0.3, 0.1),
                         0.5, m=1)
        out.append(sc)
    dev, info = out[0].build(JConfig())
    sc, pinfo = out[1].build(device="cpu")
    return dev, info, sc, pinfo


def _assert_surface(st, sj, hit_kind):
    hit = hit_kind > 0
    for name in ("loc", "norm", "tangent", "uv"):
        np.testing.assert_allclose(
            _aos(getattr(st, name))[hit], np.asarray(getattr(sj, name))[hit],
            atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(st.mat.numpy(), np.asarray(sj.mat))
    np.testing.assert_array_equal(st.has_uv.numpy(), np.asarray(sj.has_uv))


def test_surface_sample_matches_jax_mixed_scene():
    dev, info, sc, pinfo = _mixed_pair()
    o, d = _rand_rays(1024, seed=2, center=(0.5, 1.0, 0.0), spread=0.7)
    d = np.abs(d) * np.array([1, 1, 1], np.float32)
    d[:, :2] = (d[:, :2] - 0.5) * 0.8
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hj, on_j = jtraverse.ray_scene(jnp.asarray(o), jnp.asarray(d), dev, info,
                                   pallas="off")
    sj = jtraverse.surface_sample(hj, on_j, jnp.asarray(d), dev, info=info)
    ht, on_t = ttraverse.ray_scene(_soa(o), _soa(d), sc, pinfo)
    np.testing.assert_array_equal(ht.kind.numpy(), np.asarray(hj.kind))
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    st = ttraverse.surface_sample(ht, on_t, _soa(d), sc, pinfo)
    kinds = np.asarray(hj.kind)
    assert {0, 1, 3} <= set(kinds.tolist())
    assert bool(st.has_uv.any()) and not bool(st.has_uv.all())
    _assert_surface(st, sj, kinds)


@pytest.mark.parametrize("name", ["grid12", "grid40"])
def test_surface_sample_matches_jax_flat_mesh(pairs, name):
    p = pairs(name)
    o, d = p.rays(512, seed=8)
    hj, on_j = _jax_hit(p, o, d, "off")
    sj = jtraverse.surface_sample(hj, on_j, jnp.asarray(d), p.dev,
                                  info=p.info)
    ht, on_t = ttraverse.ray_scene(_soa(o), _soa(d), p.sc, p.pinfo)
    st = ttraverse.surface_sample(ht, on_t, _soa(d), p.sc, p.pinfo)
    same = ht.tri.numpy() == np.asarray(hj.tri)
    assert same.mean() >= 0.999
    _assert_surface(st, sj, np.where(same, np.asarray(hj.kind), 0))


def _carried(dev, info):
    return packing.scene_from_numpy(
        {k: np.asarray(getattr(dev, k)) for k in dev._fields},
        info._asdict(), device="cpu")


@pytest.mark.parametrize("name", ["grid40", "many"])
def test_scene_from_numpy_carries_the_forest(pairs, name):
    """A JAX DeviceScene with a forest comes across with the same tables
    the port packs itself, and both walk it to the same hits."""
    p = pairs(name)
    sc2, info2 = _carried(p.dev, p.info)
    for field in ("nodes_f", "nodes_i", "wf_perm", "tri_obj", "roots",
                  "nodes_w", "root_links", "attr", "uvt"):
        np.testing.assert_array_equal(getattr(sc2, field).numpy(),
                                      getattr(p.sc, field).numpy(), field)
    # edges: float32 differences of float32 vertices there, float64
    # differences rounded once here
    np.testing.assert_allclose(sc2.wf_tris.numpy(), p.sc.wf_tris.numpy(),
                               rtol=0, atol=4e-6)
    assert info2 == p.pinfo
    o, d = p.rays(256)
    h2, _ = ttraverse.ray_scene(_soa(o), _soa(d), sc2, info2)
    hj, _ = _jax_hit(p, o, d, "off")
    _assert_hits(h2.t.numpy(), h2.tri.numpy(), np.asarray(hj.t),
                 np.asarray(hj.tri))


def test_scene_from_numpy_mixed_scene_round_trip():
    dev, info, sc, pinfo = _mixed_pair()
    sc2, info2 = _carried(dev, info)
    for field in ("nodes_f", "nodes_i", "wf_perm", "tri_obj", "roots",
                  "nodes_w", "root_links", "attr", "ell_tab", "materials"):
        np.testing.assert_array_equal(getattr(sc2, field).numpy(),
                                      getattr(sc, field).numpy(), field)
    np.testing.assert_allclose(sc2.uvt.numpy(), sc.uvt.numpy(), atol=1e-6)
    assert info2 == pinfo


def test_too_deep_a_forest_is_refused_at_pack_time(pairs, monkeypatch):
    """The traversal stack is sized from the forest's depth; a forest the
    kernel's largest stack cannot serve raises when it is packed."""
    p = pairs("grid40")
    assert p.pinfo.forest_depth + 1 <= twavefront.TRAVERSE_MAX_STACK \
        == packing.TRAVERSE_MAX_STACK
    monkeypatch.setattr(packing, "TRAVERSE_MAX_STACK", p.pinfo.forest_depth)
    with pytest.raises(ValueError, match="levels deep"):
        p.tscene.build(device="cpu",
                       config=RenderConfig(max_tris_in_leaf=p.max_leaf))


def test_probe_is_the_closest_triangle():
    """probe_forest_t is ray_scene's distance where a triangle is hit
    first."""
    dev, info, sc, pinfo = _mixed_pair()
    o, d = _rand_rays(64, seed=2, center=(0.5, 1.0, 0.0), spread=0.7)
    a, _ = ttraverse.ray_scene(_soa(o), _soa(d), sc, pinfo)
    t = ttraverse.probe_forest_t(_soa(o), _soa(d), sc, pinfo)
    tri_only = torch.where(a.kind == 1, a.t, t)
    assert torch.equal(t, tri_only)


def _deep_mesh(n=200, ratio=0.88):
    """Triangles shrinking geometrically towards x = 0, from 2e4 wide to
    below what the triangle test accepts (|det| >= 1e-10): with one SAH
    plane every split peels off the few largest, so the tree is some 43
    levels deep."""
    x = 1e5 * ratio ** np.arange(n)
    s = 0.1 * x
    zero = np.zeros(n)
    v1 = np.stack([x, zero, zero + 3.0], 1)
    return v1, v1 + np.stack([s, zero, zero], 1), \
        v1 + np.stack([zero, s, zero], 1)


def test_deep_forest_walk():
    """A forest some 43 levels deep: the stack tensor grows with the
    depth and the walk still finds every hit."""
    v1, v2, v3 = _deep_mesh()
    out = []
    for cls in (JScene, Scene):
        sc = cls()
        sc.set_constant_sky((0.3, 0.3, 0.3))
        sc.add_material("m")
        sc.add_mesh(v1, v2, v3, 0)
        out.append(sc)
    dev, info = out[0].build(JConfig(sah_planes=1))
    sc, pinfo = out[1].build(device="cpu", config=RenderConfig(sah_planes=1))
    assert 32 < pinfo.forest_depth + 1 <= twavefront.TRAVERSE_MAX_STACK
    assert not twavefront.use_brute(pinfo)
    # rays aimed at triangles of every size, from just in front of them
    rng = np.random.RandomState(4)
    k = rng.randint(0, v1.shape[0], 512)
    size = (v2 - v1)[k, 0]
    o = v1[k] + np.stack([size * rng.rand(512) * 1.2,
                          size * rng.rand(512) * 1.2,
                          -size * 3], 1)
    o, d = o.astype(np.float32), np.tile(np.float32([0, 0, 1]), (512, 1))
    hj, _ = jtraverse.ray_scene(jnp.asarray(o), jnp.asarray(d), dev, info,
                                pallas="off")
    ht, _ = ttraverse.ray_scene(_soa(o), _soa(d), sc, pinfo)
    _assert_hits(ht.t.numpy(), ht.tri.numpy(), np.asarray(hj.t),
                 np.asarray(hj.tri))
    assert 0.2 < (ht.tri.numpy() >= 0).mean() < 0.9
    assert len(set(ht.tri.numpy().tolist())) > 80
    on = o + np.float32(1e-4) * d
    args = (_soa(on), _soa(d), torch.full((512,), float(MISS)), sc, pinfo)
    tb, _, _, ib, _, _ = twavefront.brute_reference(*args)
    tw, _, _, iw, _, _ = twavefront.traverse_reference(*args)
    assert torch.equal(tb, tw) and torch.equal(ib, iw)


# ---- the walk's record table (scene/packing.walk_records) -----------------

def _multi_forest(tmp):
    """Three objects at leaf 4: a 12x12 grid, 14 triangles SAH cannot split
    (one leaf of 14 as the root) and one triangle (a one-leaf object)."""
    grid, clump = str(tmp / "grid.obj"), str(tmp / "clump.obj")
    _tri_grid_obj(grid, 12, 12)
    _clump_obj(clump)
    sc = Scene()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_object(grid, material=0)
    sc.add_object(clump, material=0)
    sc.add_tri((0.0, 0.0, 2.0), (1.0, 0.0, 2.0), (0.0, 1.0, 2.0), 0)
    return sc.build(device="cpu", config=RenderConfig(max_tris_in_leaf=4))


def _terrain181_tiny():
    """configs/terrain181.tiny.json's scene: 2,178 triangles at leaf 1."""
    from ptbench import bench

    with open(bench.PKG / "configs" / "terrain181.tiny.json") as f:
        tiny = json.load(f)
    c = bench.cell("terrain181.progressive", {"config": tiny})
    scene, info, _ = bench.build_program_scene(c.config, c.config_module,
                                               torch.device("cpu"))
    return scene, info


@pytest.fixture(scope="module")
def walk_scenes(pairs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("walk")
    cache = {}

    def get(name):
        if name not in cache:
            if name == "terrain181":
                cache[name] = _terrain181_tiny()
            elif name == "multi":
                cache[name] = _multi_forest(tmp)
            else:
                cache[name] = (pairs(name).sc, pairs(name).pinfo)
        return cache[name]
    return get


def _decode(link, inner):
    """(node id, first row, count) of the links (k, 2): an inner link's
    node from `inner` (record -> node), rows -1 and count 0."""
    link = link.to(torch.int64)
    is_leaf = link[:, 0] < 0
    inner = torch.cat([inner, inner.new_zeros(1)])   # for a forest of leaves
    node = torch.where(is_leaf, -1, inner[link[:, 0].clamp(min=0)])
    return (node, torch.where(is_leaf, -1 - link[:, 0], -1),
            torch.where(is_leaf, link[:, 1], 0))


def _expect(child, nodes_i):
    """What a link of each node of `child` must decode to."""
    n = nodes_i[child].to(torch.int64)
    is_leaf = n[:, 0] < 0
    return (torch.where(is_leaf, -1, child), torch.where(is_leaf, n[:, 2], -1),
            torch.where(is_leaf, n[:, 3], 0))


@pytest.mark.parametrize("name", ["terrain181", "multi", "many", "grid40"])
def test_walk_records_relay_the_forest(walk_scenes, name):
    """nodes_w holds one 64-byte record per inner node, 64-byte aligned:
    both children's nodes_f boxes bit for bit, and links that decode to
    the same children, or to the same leaf's first row and count; the
    root links to each object's root."""
    sc, info = walk_scenes(name)
    nodes_i = sc.nodes_i.to(torch.int64)
    inner = torch.nonzero(nodes_i[:, 0] >= 0).flatten()
    w = sc.nodes_w
    assert w.dtype == torch.int32 and w.is_contiguous()
    assert w.shape == (max(inner.numel(), 1), 16)
    assert w.shape[1] * w.element_size() == 64 and w.data_ptr() % 64 == 0
    assert sc.root_links.shape == (info.num_objects, 2)
    boxes = sc.nodes_f[:, 0:6].contiguous().view(torch.int32)
    for side in (0, 1):
        child = nodes_i[inner, side]
        assert torch.equal(w[:inner.numel(), 6 * side:6 * side + 6],
                           boxes[child])
        got = _decode(w[:inner.numel(), 12 + 2 * side:14 + 2 * side], inner)
        for a, b in zip(got, _expect(child, nodes_i)):
            assert torch.equal(a, b)
    roots = sc.roots.to(torch.int64)
    for a, b in zip(_decode(sc.root_links, inner), _expect(roots, nodes_i)):
        assert torch.equal(a, b)
    if name in ("multi", "many"):   # objects whose root is a leaf
        assert bool((sc.root_links[:, 0] < 0).any())
    if name == "multi":
        assert int(sc.root_links[1, 1]) == 14 and info.num_objects == 3


def test_walk_records_of_a_scene_without_a_forest():
    """A scene with no triangles keeps one zero record and one zero link,
    so the kernel's pointers stay valid."""
    sc = Scene()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_sphere((0.0, 0.0, 3.0), 1.0, m=0)
    scene, info = sc.build(device="cpu")
    assert info.num_objects == 0
    assert tuple(scene.nodes_w.shape) == (1, 16)
    assert tuple(scene.root_links.shape) == (1, 2)
    assert not bool(scene.nodes_w.any()) and not bool(scene.root_links.any())

