"""The port's streamed route (LBVH -> `trace_streamed` -> `ray_scene` ->
bounce loop -> frame) against the JAX package's, on the CPU.

The JAX package builds each scene with `stream_threshold=0`;
`scene_from_numpy` carries its LBVH tables into the port's layouts, so
both packages walk the very same tree. The JAX side runs its Pallas
`_streamed_kernel` in interpret mode (as its own tests do on the CPU), the
port its plain version `streamed_reference`.

Tolerances. Kernel against kernel: the slot hit equal on >= 99.9% of the
rays (one t on a shared edge may go to either neighbour: the two walk in
different orders), t, u, v within 1e-5 where the slots agree, switched-off
rays exact. Frames: those of tests/test_torch_route.py (per-pixel max-abs
difference < 1e-4 on >= 99% of the pixels, mean abs difference < 5e-3, ray
count within 1% + 16). Streamed against the SAH route (a division-free
against a dividing triangle test): triangle id equal on >= 99.9%, t within
1e-4. Through `ray_scene` the distances are held relative to 1 + t: an
ellipsoid's root differs by a few ulps of t between the two packages.
"""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.accel import native_lbvh as jnative_lbvh
from pathtracer0_tpu.kernels import traverse as jtraverse
from pathtracer0_tpu.kernels import wavefront as jwavefront
from pathtracer0_tpu.render import renderer as jrenderer
from pathtracer0_tpu_torch import (RenderConfig, Renderer, Scene, render_frame,
                                   scenes)
from pathtracer0_tpu_torch.accel import lbvh as tlbvh
from pathtracer0_tpu_torch.accel import native_lbvh as tnative_lbvh
from pathtracer0_tpu_torch.core import camera as tcamera
from pathtracer0_tpu_torch.kernels import traverse as ttraverse
from pathtracer0_tpu_torch.kernels import wavefront as twavefront
from pathtracer0_tpu_torch.render.renderer import render_rays
from pathtracer0_tpu_torch.scene import packing
from pathtracer0_tpu_torch.scene.packing import scene_from_numpy

torch.set_num_threads(1)

FIELDS = ("tri_v1", "tri_v2", "tri_v3", "tri_n1", "tri_n2", "tri_n3",
          "tri_uv1", "tri_uv2", "tri_uv3", "tri_has_uv", "tri_has_smooth",
          "tri_mat", "tri_obj", "st_top", "st_tris", "st_sub", "st_perm",
          "fs_maps", "materials", "ell_tab", "imp_tab", "tex_data",
          "tex_sizes")


def _grid(n, seed=0):
    """n x n jittered triangles over a 0.7-pitch grid (the grid of
    tests/test_wavefront.py), as (v1, v2, v3)."""
    rng = np.random.RandomState(seed)
    i, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    base = np.stack([i.ravel() * 0.7, rng.rand(n * n) * 1.5,
                     k.ravel() * 0.7], -1)
    v2 = base + np.stack([np.full(n * n, 0.6), rng.randn(n * n) * 0.3,
                          np.zeros(n * n)], -1)
    v3 = base + np.stack([np.zeros(n * n), rng.randn(n * n) * 0.3,
                          np.full(n * n, 0.6)], -1)
    return base, v2, v3


def _fill(sc, n, ellipsoid):
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("ground")
    sc.set_last_mtl("Kd", (0.7, 0.6, 0.5))
    sc.set_last_mtl("Ka", (0.05, 0.02, 0.0))
    sc.add_material("metal")
    sc.set_last_mtl("Pm", 1.0)
    sc.set_last_mtl("Pr", 0.05)
    sc.set_last_mtl("Ks", (0.9, 0.85, 0.7))
    sc.add_mesh(*_grid(n), 0)
    if ellipsoid:
        c = 0.35 * n
        sc.add_ellipsoid((c, 1.6, c), (1.0, 1.4, 0.8), (0.2, 0.0, 0.3),
                         2.0 + 0.05 * n, 1)
    return sc


@pytest.fixture(scope="module")
def pair():
    """(JAX scene, info, port scene carried across, info) of an n x n
    grid built streamed, with or without an ellipsoid."""
    cache = {}

    def get(n, ellipsoid=False):
        if (n, ellipsoid) not in cache:
            dev, info = _fill(JScene(), n, ellipsoid).build(
                JConfig(stream_threshold=0))
            sc, pinfo = scene_from_numpy(
                {k: np.asarray(getattr(dev, k)) for k in FIELDS},
                info._asdict(), device="cpu")
            cache[n, ellipsoid] = (dev, info, sc, pinfo)
        return cache[n, ellipsoid]
    return get


def _rays(n_rays, n, seed=1):
    """Rays from above an n x n grid, mostly downwards, some with a zero
    direction component."""
    rng = np.random.RandomState(seed)
    o = np.stack([rng.rand(n_rays) * 0.7 * n, 3.0 + rng.rand(n_rays) * 2.0,
                  rng.rand(n_rays) * 0.7 * n], -1).astype(np.float32)
    d = rng.randn(n_rays, 3) + np.array([0.0, -1.5, 0.0])
    d[::17, 0] = 0.0
    d[5::17, 2] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _soa(a):
    t = torch.tensor(np.asarray(a))
    return tuple(t[:, i].contiguous() for i in range(3))


def test_scene_from_numpy_carries_the_lbvh(pair):
    dev, info, sc, pinfo = pair(12)
    assert info.streamed and pinfo.streamed
    assert pinfo.num_objects == 0 and pinfo.num_tris == 144
    assert (pinfo.st_n_treelets, pinfo.st_treelet_rows, pinfo.st_leaf_cap) \
        == (info.st_n_treelets, info.st_treelet_rows, info.st_leaf_cap)
    n = pinfo.st_n_treelets
    assert sc.st_top.shape == (2 * n - 1, 8) and sc.st_sub.shape == (64 * n, 8)
    assert sc.st_tris.shape == (1792 * n, 9) and sc.st_perm.shape == (1792 * n,)
    np.testing.assert_array_equal(sc.st_top.numpy(), np.asarray(dev.st_top))
    np.testing.assert_array_equal(
        sc.st_tris.numpy().reshape(-1, 126), np.asarray(dev.st_tris)[:, :126])
    np.testing.assert_array_equal(sc.st_sub.numpy()[:, :6],
                                  np.asarray(dev.st_sub)[:, :6])
    np.testing.assert_array_equal(sc.st_perm.numpy(), np.asarray(dev.st_perm))
    np.testing.assert_array_equal(sc.tri_obj.numpy(), 0)
    # The port's own build of the same mesh is the median-split order of
    # its native builder. The JAX package builds that order where its
    # native builder loads, and NumPy's Morton order where it does not
    # (PT0_NATIVE_LBVH=0, or a worker that lost the race to compile it):
    # the port is held against whichever tree the JAX package built.
    own, oinfo = _fill(Scene(), 12, False).build(
        RenderConfig(stream_threshold=0), device="cpu")
    assert oinfo == pinfo
    assert torch.equal(own.attr, sc.attr)
    tables = ("st_top", "st_sub", "st_tris", "st_perm")
    if (jnative_lbvh.available()
            and os.environ.get("PT0_STREAM_ORDER") != "morton"):
        for name in tables:
            assert torch.equal(getattr(own, name), getattr(sc, name)), name
    else:
        mesh = _fill(Scene(), 12, False).bulk_meshes[0]
        v = [mesh[k] for k in ("v1", "v2", "v3")]
        morton = tlbvh.build_streamed(*v, order="morton")
        for name, field in zip(tables, ("ctree_f", "sub_f", "tris",
                                        "row_perm")):
            assert torch.equal(torch.from_numpy(getattr(morton, field)),
                               getattr(sc, name)), name
        # the port's median build is its native builder's median order
        median = tnative_lbvh.build_streamed(*v, mode=1)
        for name, field in zip(tables, ("ctree_f", "sub_f", "tris",
                                        "row_perm")):
            assert torch.equal(torch.from_numpy(getattr(median, field)),
                               getattr(own, name)), name


@pytest.mark.parametrize("n", [12, 45])
def test_scene_from_numpy_makes_the_row_boxes(pair, n):
    """A scene carried across from the JAX package gets the walk's row
    boxes too, made from the carried slots as the port's own build makes
    them; its own build of the same mesh has the same boxes where it has
    the same slots."""
    _, _, sc, pinfo = pair(n)
    rows = packing.row_boxes(sc.st_tris.numpy(), sc.st_perm.numpy())
    assert sc.st_rows.shape == (128 * pinfo.st_n_treelets, 8)
    np.testing.assert_array_equal(sc.st_rows.numpy(), rows)
    full = (sc.st_perm.numpy().reshape(-1, 14) >= 0).any(1)
    assert full.sum() == -(-pinfo.num_tris // 14)
    own, _ = _fill(Scene(), n, False).build(
        RenderConfig(stream_threshold=0), device="cpu")
    if torch.equal(own.st_tris, sc.st_tris):
        assert torch.equal(own.st_rows, sc.st_rows)


# 12 x 12 = 144 triangles: one treelet; 45 x 45 = 2,025: two (a treelet
# holds 1,792), the second mostly empty
@pytest.mark.parametrize("n,treelets", [(12, 1), (45, 2)])
def test_streamed_reference_matches_jax_kernel(pair, n, treelets):
    dev, info, sc, pinfo = pair(n)
    assert pinfo.st_n_treelets == treelets
    o, d = _rays(2048, n)
    t_init = np.where(np.arange(2048) % 7 == 0, 0.0, 1e30).astype(np.float32)
    tj, uj, vj, ij, _, _ = jwavefront.trace_streamed(
        jnp.asarray(o.T), jnp.asarray(d.T), jnp.asarray(t_init), dev.st_top,
        dev.st_tris, dev.st_sub, n_treelets=info.st_n_treelets,
        treelet_rows=info.st_treelet_rows, leaf_cap=info.st_leaf_cap,
        block_rows=8, interpret=True)
    before = dict(twavefront.launches)
    tt, ut, vt, it, box, rows = twavefront.trace_streamed(
        _soa(o), _soa(d), torch.tensor(t_init), sc, pinfo)
    assert twavefront.launches == before    # CPU: the plain version
    ij, it = np.asarray(ij), it.numpy()
    same = ij == it
    assert same.mean() >= 0.999, same.mean()
    assert 0.1 < (it >= 0).mean() < 0.95
    for a, b in ((tj, tt), (uj, ut), (vj, vt)):
        a, b = np.asarray(a)[same], b.numpy()[same]
        hit = a < 1e29
        assert np.array_equal(hit, b < 1e29)
        assert np.abs(a[hit] - b[hit]).max() <= 1e-5
    off = t_init == 0.0
    assert (tt.numpy()[off] == 0.0).all() and (it[off] == -1).all()
    assert (ut.numpy()[off] == 0.0).all() and (vt.numpy()[off] == 0.0).all()
    assert (box.numpy()[off] == 0).all() and (rows.numpy()[off] == 0).all()
    # a live ray tests at least the root's children; rows come in groups
    assert (box.numpy()[~off] >= 2).all()
    assert (rows.numpy() % 4 == 0).all() and rows.numpy().max() > 0


def test_streamed_reference_edge_cases(pair):
    """All lanes off; a ray with zero direction components through a tree
    whose second treelet is mostly empty boxes; a short t_init prunes."""
    dev, info, sc, pinfo = pair(45)
    o, d = _rays(64, 45)
    dead = twavefront.streamed_reference(_soa(o), _soa(d), torch.zeros(64),
                                         sc, pinfo)
    assert (dead[0] == 0).all() and (dead[3] == -1).all()
    assert (dead[4] == 0).all() and (dead[5] == 0).all()
    # straight down: two zero direction components
    o1 = torch.tensor([[10.0, 5.0, 10.0]])
    d1 = torch.tensor([[0.0, -1.0, 0.0]])
    t, u, v, idx, box, rows = twavefront.streamed_reference(
        _soa(o1), _soa(d1), torch.full((1,), 1e30), sc, pinfo)
    assert torch.isfinite(t).all() and int(idx[0]) >= 0
    forest, finfo = _fill(Scene(), 45, False).build(
        device="cpu", config=RenderConfig(max_tris_in_leaf=4))
    hit_f, _ = ttraverse.ray_scene(_soa(o1), _soa(d1), forest, finfo)
    hit_t, _ = ttraverse.ray_scene(_soa(o1), _soa(d1), sc, pinfo)
    assert int(hit_t.tri[0]) == int(hit_f.tri[0]) >= 0
    assert abs(float(hit_t.t[0]) - float(hit_f.t[0])) <= 1e-5
    # nothing closer than t_init = 0.5: no hit, t comes back as it went in
    near = twavefront.streamed_reference(_soa(o1), _soa(d1),
                                         torch.full((1,), 0.5), sc, pinfo)
    assert float(near[0][0]) == 0.5 and int(near[3][0]) == -1
    # an empty box is refused whatever the ray: inf * finite would pass
    # the bare slab test
    assert np.isinf(sc.st_sub.numpy()[64:, 0]).any()


@pytest.mark.parametrize("n", [12, 45])
def test_streamed_reference_marks_what_it_reads(pair, n):
    """`visited` changes no result; the marked boxes and groups are no more
    than the counters' visits, hold every group with a hit, and leave the
    never-tested root and the empty treelet's boxes out."""
    _, _, sc, pinfo = pair(n)
    o, d = _rays(512, n)
    t_init = torch.where(torch.arange(512) % 7 == 0, 0.0, 1e30)
    nt = pinfo.st_n_treelets
    marks = (torch.zeros(2 * nt - 1 + 64 * nt, dtype=torch.bool),
             torch.zeros(32 * nt, dtype=torch.bool))
    plain = twavefront.streamed_reference(_soa(o), _soa(d), t_init, sc, pinfo)
    marked = twavefront.streamed_reference(_soa(o), _soa(d), t_init, sc,
                                           pinfo, visited=marks)
    for a, b in zip(plain, marked):
        assert torch.equal(a, b)
    idx, box, rows = marked[3:]
    boxes, groups = marks
    assert 0 < int(boxes.sum()) <= int(box.sum())
    assert 0 < int(groups.sum()) <= int(rows.sum()) // 4
    assert not bool(boxes[0])
    hit_groups = torch.unique(idx[idx >= 0].to(torch.int64) // 56)
    assert bool(groups[hit_groups].all())
    # a group is entered only through its own box, 2n - 1 + 64 treelet + 31
    # + group, unless it is alone in its tree
    entered = groups.nonzero()[:, 0]
    codes = 2 * nt - 1 + 64 * (entered // 32) + 31 + entered % 32
    assert bool(boxes[codes].all())
    # boxes of empty groups are tested (and refused) but never entered
    empty = torch.cat([sc.st_top, sc.st_sub])[:, 0] > \
        torch.cat([sc.st_top, sc.st_sub])[:, 3]
    assert bool(empty.any())
    sub_codes = torch.arange(32 * nt)
    group_box = 2 * nt - 1 + 64 * (sub_codes // 32) + 31 + sub_codes % 32
    assert not bool(groups[empty[group_box]].any())


def _assert_hits(a, b, t_tol):
    """Port Hit `a` against Hit `b` (port or JAX), t within t_tol (1 + t)."""
    tri_a, tri_b = np.asarray(a.tri), np.asarray(b.tri)
    same = tri_a == tri_b
    assert same.mean() >= 0.999, same.mean()
    ta, tb = np.asarray(a.t)[same], np.asarray(b.t)[same]
    assert np.array_equal(ta < 1e25, tb < 1e25)
    hit = ta < 1e25
    assert (np.abs(ta[hit] - tb[hit]) / (1.0 + tb[hit])).max() <= t_tol
    for name in ("kind", "prim"):
        assert np.array_equal(np.asarray(getattr(a, name))[same],
                              np.asarray(getattr(b, name))[same]), name


@pytest.mark.parametrize("n", [12, 45])
def test_ray_scene_streamed_matches_jax_and_the_sah_route(pair, n):
    """`ray_scene` on a streamed scene with an ellipsoid in it, so the
    analytic merge is covered: against the JAX package's on the same tree,
    and against the port's own SAH forest over the same mesh."""
    dev, info, sc, pinfo = pair(n, ellipsoid=True)
    o, d = _rays(2048, n, seed=3)
    active = np.arange(2048) % 5 != 0
    hit_j, on_j = jtraverse.ray_scene(jnp.asarray(o), jnp.asarray(d), dev,
                                      info, active=jnp.asarray(active))
    hit_t, on_t = ttraverse.ray_scene(_soa(o), _soa(d), sc, pinfo,
                                      active=torch.tensor(active))
    _assert_hits(hit_t, hit_j, 1e-5)
    kinds = hit_t.kind.numpy()
    assert (kinds == 1).mean() > 0.05 and (kinds == 3).mean() > 0.05
    assert (hit_t.t.numpy()[~active] == 0.0).all()
    # the object is the mesh's ordinal, as the JAX package's
    assert np.array_equal(hit_t.obj.numpy(), np.asarray(hit_j.obj))
    np.testing.assert_array_equal(torch.stack(on_t, -1).numpy(),
                                  np.asarray(on_j))
    # the SAH route: its own forest, the dividing triangle test
    forest, finfo = _fill(Scene(), n, True).build(
        device="cpu", config=RenderConfig(max_tris_in_leaf=4))
    assert not finfo.streamed and finfo.num_objects == 1
    hit_f, _ = ttraverse.ray_scene(_soa(o), _soa(d), forest, finfo,
                                   active=torch.tensor(active))
    _assert_hits(hit_t, hit_f, 1e-4)
    # probe and counters take the streamed branch
    t_probe = ttraverse.probe_forest_t(_soa(o), _soa(d), sc, pinfo)
    tri_only = kinds == 1
    assert torch.equal(t_probe[tri_only], hit_t.t[tri_only])
    box, rows = ttraverse.heat_counts(_soa(o), _soa(d), sc, pinfo)
    assert int(box.min()) >= 2 and int(rows.max()) > 0


def test_streamed_route_sorts_its_rays_as_jax(pair, monkeypatch):
    """A streamed query of >= 1,024 rays, some switched off and some that
    miss the LBVH's root box: the port hands its kernel the rays the JAX
    package hands its `_streamed_kernel`, in the same order (rays that
    miss the root, then switched-off ones, at the back); sorted and
    unsorted give the same bits; `ray_scene` matches the JAX one (which
    sorts) at the tolerances above; `probe_forest_t` and `heat_counts`
    walk the sorted rays too."""
    dev, info, sc, pinfo = pair(12)
    n_rays = 1536
    o, d = _rays(n_rays, 12, seed=5)
    d[::11, 1] = np.abs(d[::11, 1])          # upwards: these miss the root
    o[3::13, 0] -= 40.0                      # beside the grid, and away
    d[3::13, 0] = -np.abs(d[3::13, 0])
    active = np.arange(n_rays) % 6 != 0
    seen = {}
    real = jwavefront.trace_streamed

    def spy(o3, d3, t_init, *args, **kw):
        seen.update(o=np.asarray(o3), d=np.asarray(d3),
                    t=np.asarray(t_init))
        return real(o3, d3, t_init, *args, **kw)

    monkeypatch.setattr(jwavefront, "trace_streamed", spy)
    hit_j, _ = jtraverse.ray_scene(jnp.asarray(o), jnp.asarray(d), dev, info,
                                   active=jnp.asarray(active))
    on = ttraverse.nudged(_soa(o), _soa(d))
    t_init = torch.where(torch.tensor(active), 1e30, 0.0)
    order = ttraverse.streamed_order(on, _soa(d), t_init, sc)
    assert sorted(order.tolist()) == list(range(n_rays))
    np.testing.assert_array_equal(
        torch.stack([c[order] for c in on]).numpy(), seen["o"][:, :n_rays])
    np.testing.assert_array_equal(
        torch.stack([c[order] for c in _soa(d)]).numpy(),
        seen["d"][:, :n_rays])
    np.testing.assert_array_equal(t_init[order].numpy(), seen["t"][:n_rays])
    # the back of the order: root misses, then the switched-off rays
    walked = twavefront.streamed_reference(on, _soa(d), t_init, sc, pinfo)
    dead = ~torch.tensor(active)
    n_dead = int(dead.sum())
    assert bool(dead[order[-n_dead:]].all())
    assert not bool(dead[order[:-n_dead]].any())
    box = sc.st_top[0].numpy()
    on_np = torch.stack(on, -1).numpy()
    with np.errstate(divide="ignore"):
        inv = np.clip(1.0 / np.where(d == 0.0, 1e-30, d), -1e30, 1e30)
    ta, tb = (box[0:3] - on_np) * inv, (box[3:6] - on_np) * inv
    near = np.minimum(ta, tb).max(-1)
    far = np.maximum(ta, tb).min(-1)
    miss = torch.tensor(~((far >= near) & (far > 0.0)) & active)
    n_miss = int(miss.sum())
    assert 0 < n_miss < n_rays - n_dead
    assert float((walked[3] >= 0).float().mean()) > 0.05
    assert bool(miss[order[-n_dead - n_miss:-n_dead]].all())
    assert bool((walked[5][miss] == 0).all())

    # sorted against unsorted: the same bits, kernel outputs and counters
    got = {}
    real_ref = twavefront.streamed_reference

    def spy_ref(o, d, t_init, *args, **kw):
        got["t_init"] = t_init
        return real_ref(o, d, t_init, *args, **kw)

    sorted_out = ttraverse.sorted_query(real_ref, on, _soa(d), t_init, sc,
                                        pinfo)
    for a, b in zip(sorted_out, walked):
        assert torch.equal(a, b)
    monkeypatch.setattr(twavefront, "streamed_reference", spy_ref)
    small = ttraverse.sorted_query(real_ref, tuple(c[:1000] for c in on),
                                   tuple(c[:1000] for c in _soa(d)),
                                   t_init[:1000], sc, pinfo)
    for a, b in zip(small, walked):
        assert torch.equal(a, b[:1000])

    # the route: ray_scene, probe_forest_t and heat_counts walk sorted rays
    hit_t, _ = ttraverse.ray_scene(_soa(o), _soa(d), sc, pinfo,
                                   active=torch.tensor(active))
    assert torch.equal(got["t_init"], t_init[order])
    _assert_hits(hit_t, hit_j, 1e-5)
    assert torch.equal(hit_t.t, walked[0])
    got.clear()
    probe = ttraverse.probe_forest_t(_soa(o), _soa(d), sc, pinfo)
    full = torch.full((n_rays,), 1e30)
    assert torch.equal(got["t_init"], full[order]) and bool(
        (got["t_init"] > 0).all())
    live = torch.tensor(active)
    assert torch.equal(probe[live], walked[0][live])
    got.clear()
    box, rows = ttraverse.heat_counts(_soa(o), _soa(d), sc, pinfo)
    assert "t_init" in got
    assert torch.equal(box[live], walked[4][live])
    assert torch.equal(rows[live], walked[5][live])


W, H, CAM, ROT, SEED = 48, 36, (2.5, 3.0, -4.0), (0.4, 0.0, 0.0), 7


def _assert_frames(a, b, rays_a, rays_b):
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, (diff.max(), (diff < 1e-4).mean())
    assert np.abs(a - b).mean() < 5e-3
    assert abs(float(rays_a) - float(rays_b)) <= 0.01 * float(rays_a) + 16


@pytest.mark.parametrize("raytracing", [True, False],
                         ids=["path", "whitted"])
def test_streamed_frame_matches_jax(pair, raytracing):
    """The slice as a whole: a 48x36, 1 spp, 2 bounce frame of a small
    streamed scene (the frame of tests/test_wavefront.py's
    test_renders_end_to_end, an ellipsoid added) in both packages."""
    dev, info, sc, pinfo = pair(8, ellipsoid=True)
    kw = dict(width=W, height=H, samples_per_frame=1, max_bounces=2,
              auto_focus=False, blur=0.0, raytracing=raytracing,
              stream_threshold=0)
    jcfg = JConfig(**kw)
    img_j, rays_j = jrenderer.render_frame(
        dev, jnp.asarray(CAM, jnp.float32), jnp.asarray(ROT, jnp.float32),
        jnp.uint32(SEED), info=info, params=jrenderer._frame_params(jcfg),
        width=W, height=H, spp=1, raytracing=raytracing, auto_focus=False,
        cam_size=jcfg.cam_size, focal_length=jcfg.focal_length, blur=0.0,
        focal_distance=jcfg.focal_distance)
    img_t, rays_t = render_frame(sc, pinfo, RenderConfig(**kw), CAM, ROT,
                                 SEED, device="cpu")
    b = img_t.numpy()
    _assert_frames(np.asarray(img_j), b, rays_j, int(rays_t))
    # the grid, the ellipsoid and the sky are in the picture
    assert b.std() > 0.05
    assert (np.abs(b[..., 2] - b[..., 0]) > 1e-3).any()


def test_streamed_frame_through_renderer_and_against_the_sah_route():
    """The port's own build (`stream_threshold=0`) through Renderer, path
    and Whitted, against the same mesh over the SAH forest: RMSE < 0.05."""
    from pathtracer0_tpu_torch.utils import image as img_util

    for raytracing in (True, False):
        imgs = []
        for stream in (True, False):
            cfg = RenderConfig(
                width=W, height=H, samples_per_frame=2, max_bounces=2,
                auto_focus=True, raytracing=raytracing, max_tris_in_leaf=4,
                stream_threshold=0 if stream else 1 << 16)
            sc, info = _fill(Scene(), 8, True).build(device="cpu", config=cfg)
            assert info.streamed == stream
            r = Renderer(sc, info, cfg, cam_pos=CAM, cam_rot=ROT, seed=3,
                         device="cpu")
            imgs.append(np.clip(r.render(1).numpy(), 0.0, 1.0))
            assert r.rays_traced >= W * H * 2
        assert img_util.rmse(*imgs) < 0.05
        assert imgs[0].std() > 0.05


@pytest.mark.parametrize("raytracing", [True, False],
                         ids=["path", "whitted"])
def test_ray_batch_size_chunks_change_nothing(raytracing):
    """`render_rays` over more than `ray_batch_size` pixels renders them
    in chunks; a pixel's RNG stream depends on its index alone, so the
    frame and the query count are identical, ragged last chunk or not."""
    cfg = RenderConfig(width=W, height=H, samples_per_frame=2, max_bounces=3,
                       auto_focus=False, focal_distance=5.0,
                       raytracing=raytracing, stream_threshold=0)
    sc, info = _fill(Scene(), 8, True).build(device="cpu", config=cfg)
    whole, q = render_frame(sc, info, cfg, CAM, ROT, SEED, device="cpu")
    for batch in (1000, 577, W * H - 1):
        img, qc = render_frame(
            sc, info, dataclasses.replace(cfg, ray_batch_size=batch), CAM,
            ROT, SEED, device="cpu")
        assert torch.equal(img, whole) and int(qc) == int(q), batch
    # render_rays itself, on a subset of the pixels
    uv, index = tcamera.pixel_centers(W, H, torch.device("cpu"))
    pose = [torch.tensor(v, dtype=torch.float32) for v in (CAM, ROT)]
    part, _ = render_rays(sc, info, uv[100:700], index[100:700], *pose, SEED,
                          torch.tensor(5.0),
                          config=dataclasses.replace(cfg, ray_batch_size=128))
    assert torch.equal(part, whole.reshape(-1, 3)[100:700])


def test_spatial_sort_key_matches_jax():
    """The ray-coherence key (the streamed route's sort) is bit-equal to the
    JAX package's on seeded rays, some with zero direction components and
    some outside the box."""
    o, d = _rays(4096, 20, seed=11)
    o[::9] += 30.0
    lo = np.array([0.0, -1.0, 0.0], np.float32)
    hi = np.array([14.0, 6.0, 14.0], np.float32)
    kj = jtraverse._spatial_sort_key(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(lo), jnp.asarray(hi))
    kt = ttraverse.spatial_sort_key(torch.tensor(o), torch.tensor(d),
                                    torch.tensor(lo), torch.tensor(hi))
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert len(np.unique(kt.numpy())) > 500


def _key_rays(population, n=4096, seed=13):
    """Rays about the root box [0, -1, 0] - [14, 6, 14] of one kind, one
    in five switched off: "inside" (origins in and around the box, some
    direction components 0), "miss" (from beside the box, half of them
    pointing away), "faces" (origins on the box's faces, the direction
    along the face's normal 0 where the nudge must leave them there)."""
    rng = np.random.RandomState(seed)
    lo = np.array([0.0, -1.0, 0.0], np.float32)
    hi = np.array([14.0, 6.0, 14.0], np.float32)
    o = (lo + rng.rand(n, 3) * 1.4 * (hi - lo) - 0.2 * (hi - lo))
    d = rng.randn(n, 3)
    if population == "inside":
        d[::7, 0] = 0.0
        d[3::7, 1] = 0.0
        d[5::11] = 0.0
    elif population == "miss":
        o[:, 0] = hi[0] + 1.0 + rng.rand(n) * 20.0
        d[::2, 0] = np.abs(d[::2, 0])
        d[1::2, 0] = -np.abs(d[1::2, 0])
    else:
        at, axis = np.arange(n), np.arange(n) % 3
        side = np.where((at % 2 == 0)[:, None], lo, hi)
        o[at, axis] = side[at, axis]
        flat = at % 4 == 0
        d[flat, axis[flat]] = 0.0
    d = d.astype(np.float32)
    active = np.arange(n) % 5 != 2
    return o.astype(np.float32), d, active, np.concatenate([lo, hi])


@pytest.mark.parametrize("population", ["inside", "miss", "faces"])
def test_sort_key_kernel_body_matches_jax_and_the_route(population):
    """csrc/sort_key.cuh's per-ray body (sort_key_kernel's and the ordered
    walk's nudge and key, built by g++) against the route's plain twin
    `streamed_keys` on the nudged rays, bit for bit, and where a ray is on
    and meets the root box against the JAX package's `_spatial_sort_key`;
    switched-off rays keyed 2^30 + 1, root misses 2^30."""
    import ctypes

    from pathtracer0_tpu_torch.kernels import build

    o, d, active, root = _key_rays(population)
    n = o.shape[0]
    lib = build.load("sort_key")
    lib.pt_sort_keys.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)      # noqa: E731
    oc, dc = np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)
    on = np.empty((3, n), np.float32)
    key = np.empty(n, np.int32)
    act = active.astype(np.uint8)
    lib.pt_sort_keys(ptr(oc), ptr(dc), ptr(act), ptr(root), n, ptr(on),
                     ptr(key))
    on_t = ttraverse.nudged(_soa(o), _soa(d))
    np.testing.assert_array_equal(on, torch.stack(on_t).numpy())
    t_init = torch.where(torch.tensor(active), 1e30, 0.0)
    plain = ttraverse.streamed_keys(on_t, _soa(d), t_init,
                                    torch.tensor(root)).numpy()
    assert plain.dtype == np.int32
    np.testing.assert_array_equal(key, plain)
    assert (key[~active] == 2 ** 30 + 1).all()
    inside = key < 2 ** 30
    kj = np.asarray(jtraverse._spatial_sort_key(
        jnp.asarray(on.T), jnp.asarray(d), jnp.asarray(root[0:3]),
        jnp.asarray(root[3:6])))
    np.testing.assert_array_equal(key[inside], kj[inside])
    missed = (key == 2 ** 30).mean()
    if population == "miss":
        assert 0.3 < missed < 0.8
    else:
        assert inside.mean() > 0.3 and len(np.unique(key)) > 300
    # with no mask every ray is on
    lib.pt_sort_keys(ptr(oc), ptr(dc), None, ptr(root), n, ptr(on), ptr(key))
    np.testing.assert_array_equal(key[active], plain[active])
    assert (key < 2 ** 30 + 1).all()


def test_terrain_scene_streams_past_the_threshold():
    """`scenes.terrain(n)`: 2 (n - 1)^2 triangles as one indexed mesh; it
    streams once past `stream_threshold`. (Its own camera suits the
    benchmark's sizes; this small one is looked at from close by.)"""
    sc = scenes.terrain(24)
    cfg = RenderConfig(width=32, height=24, samples_per_frame=1,
                       max_bounces=3, auto_focus=False, blur=0.0,
                       stream_threshold=1000)
    scene, info = sc.build(device="cpu", config=cfg)
    assert info.num_tris == 2 * 23 * 23 and info.streamed
    assert info.num_objects == 0 and info.st_n_treelets == 1
    cam, rot = scenes.terrain_camera(708)
    assert cam == pytest.approx((0.0, 14.0, -58.0)) and rot == (0.25, 0, 0)
    img, rays = render_frame(scene, info, cfg, (0.0, 5.5, -2.5),
                             (0.5, 0.0, 0.0), 5, device="cpu")
    assert torch.isfinite(img).all() and int(rays) > 32 * 24
    sky = torch.tensor([0.5, 0.6, 0.9])
    covered = float(((img - sky).abs().amax(-1) > 0.02).float().mean())
    assert 0.05 < covered < 0.98
    _, small = sc.build(device="cpu", config=RenderConfig())
    assert not small.streamed and small.num_objects == 1


def _watertight(sc):
    """The 12 x 12 watertight height field of the JAX package's
    test_pick_streamed_scene (tests/test_debug_tools.py), one mesh."""
    n = 12
    xs = np.linspace(0.0, 6.0, n)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X) * np.cos(Z) * 0.4, Z], axis=-1)
    a, b = P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3)
    c, d4 = P[:-1, 1:].reshape(-1, 3), P[1:, 1:].reshape(-1, 3)
    sc.set_constant_sky((0.2, 0.3, 0.8))
    sc.add_material("m")
    sc.add_mesh(np.concatenate([a, d4]), np.concatenate([b, b]),
                np.concatenate([c, c]), 0)
    return sc


def test_pick_streamed_scene():
    """Renderer.pick through the streamed route, straight down over the
    grid's centre on a 3 x 3 block of pixels: every pick a triangle hit
    at a distance in (4, 12), record by record the JAX package's (hit,
    kind, obj, material equal; distance within 1e-5 x (1 + t); normal and
    loc within 1e-5 x (1 + |loc|), the limits of `ray_scene` above)."""
    pose = dict(cam_pos=(3.0, 8.0, 3.0), cam_rot=(np.pi / 2, 0.0, 0.0))
    kw = dict(width=32, height=32, auto_focus=False, stream_threshold=10)
    dev, info = _watertight(JScene()).build(JConfig(**kw))
    sc, pinfo = _watertight(Scene()).build(RenderConfig(**kw), device="cpu")
    assert info.streamed and pinfo.streamed
    jr = jrenderer.Renderer(dev, info, JConfig(**kw), **pose)
    r = Renderer(sc, pinfo, RenderConfig(**kw), device="cpu", **pose)
    for x in (14, 16, 18):
        for y in (14, 16, 18):
            rj, rt = jr.pick(x, y), r.pick(x, y)
            assert rt["hit"] and rt["kind"] == 1 and rt["obj"] == 0
            assert np.isfinite(rt["normal"]).all()
            assert 4.0 < rt["distance"] < 12.0
            for key in ("hit", "kind", "obj", "material"):
                assert rj[key] == rt[key], key
            t = rj["distance"]
            assert abs(t - rt["distance"]) <= 1e-5 * (1.0 + t)
            limit = 1e-5 * (1.0 + np.abs(rj["loc"]).max())
            for key in ("normal", "loc"):
                assert np.abs(rj[key] - rt[key]).max() <= limit, key
