"""The port's debug heatmap (render/renderer.render_debug_frame,
heat_color, kernels/traverse.object_heat_counts) against the JAX package
on the CPU.

Over the SAH forest the port keeps the reference's per-object semantics
(frag.glsl:534, 539-547): each object walked alone from no hit, the mean
of their colours, as the JAX package's XLA path does. Tolerances: the
per-object counters equal on every ray; the frame within 1e-6; heat_color
bit-equal in red and green, and in blue wherever XLA's float32 exp is the
correctly rounded one (the port rounds a float64 exp, so that the card and
the CPU agree), else within one ulp. A streamed scene's counters are per
ray (the JAX package counts per block of 1,024 rays, a logged deviation):
the frame is held against the port's plain walker, unsorted, to every bit.
"""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Renderer as JRenderer
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.kernels import traverse as jtraverse
from pathtracer0_tpu.render.renderer import _frame_params, _heat_color
from pathtracer0_tpu.render.renderer import render_debug_frame as jdebug
from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene
from pathtracer0_tpu_torch.core import camera
from pathtracer0_tpu_torch.core import math as vm
from pathtracer0_tpu_torch.kernels import traverse, wavefront
from pathtracer0_tpu_torch.kernels.intersect import MISS
from pathtracer0_tpu_torch.render.renderer import (heat_color,
                                                   render_debug_frame)

torch.set_num_threads(1)

CAM = ((3.5, 3.0, -4.0), (0.45, -0.2, 0.0))


def _grid_lines(name, nx, nz, x0, z0, y0, rs):
    """A jittered triangle grid (tests/test_wavefront.py's generator): the
    object's name, its vertices and the first vertex of each triangle."""
    verts, tris = [], []
    for i in range(nx):
        for k in range(nz):
            bx, bz, by = x0 + i * 0.7, z0 + k * 0.7, y0 + rs.rand() * 1.5
            verts += [(bx, by, bz), (bx + 0.6, by + rs.randn() * 0.3, bz),
                      (bx, by + rs.randn() * 0.3, bz + 0.6)]
            tris.append(len(verts) - 3)
    return name, verts, tris


def _two_object_obj(path):
    """Two objects in one OBJ file: a 10x10 grid and a 5x5 grid in front
    of it, 125 triangles."""
    rs = np.random.RandomState(0)
    lines, base = [], 0
    for name, verts, tris in (_grid_lines("back", 10, 10, 0.0, 0.0, 0.0, rs),
                              _grid_lines("front", 5, 5, 1.5, 1.0, 1.2, rs)):
        lines.append(f"o {name}")
        lines += ["v %.5f %.5f %.5f" % v for v in verts]
        lines += [f"f {base + t + 1} {base + t + 2} {base + t + 3}"
                  for t in tris]
        base += len(verts)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _build(cls, path, **cfg):
    sc = cls()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_object(path, material=0)
    sc.add_sphere((2.0, 1.0, 9.0), 1.0, m=0)
    if cls is JScene:
        return sc.build(JConfig(max_tris_in_leaf=2, **cfg))
    return sc.build(RenderConfig(max_tris_in_leaf=2, **cfg), device="cpu")


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("heat") / "two.obj")
    _two_object_obj(path)
    return (*_build(JScene, path), *_build(Scene, path))


def _primary(width, height, cfg):
    uv, _ = camera.pixel_centers(width, height, "cpu")
    d = camera.primary_directions(
        uv, vm.rotation_matrix(torch.tensor(CAM[1], dtype=torch.float32)),
        cfg.cam_size, cfg.focal_length, height / float(width))
    o = torch.tensor(CAM[0], dtype=torch.float32).expand(d.shape)
    return o, d


def test_object_counters_equal_jax_walk(forest):
    """Each object walked alone from MISS: the port's plain walk gives the
    box tests and leaf visits of the JAX package's `_traverse_object` (the
    root not counted, 2 box tests an internal node, 1 a leaf) on every
    ray; `walk_object` walks this forest too, small as it is (trace_forest
    would take brute_kernel, which counts no walk)."""
    dev, info, sc, pinfo = forest
    assert pinfo.num_objects == 2 and wavefront.use_brute(pinfo)
    o, d = _primary(32, 24, RenderConfig())
    on = o + np.float32(1e-4) * d
    for k in range(pinfo.num_objects):
        box, leaf = traverse.object_heat_counts(o.unbind(-1), d.unbind(-1),
                                                sc, pinfo, k)

        def walk(o1, d1, k=k):
            return jtraverse._traverse_object(
                o1, d1, dev.roots[k], jtraverse.MISS, dev, 64,
                max(info.max_leaf_size, 1))[4]

        bj, lj = jax.vmap(walk)(jnp.asarray(on.numpy()),
                                jnp.asarray(d.numpy()))
        np.testing.assert_array_equal(box.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(lj))
        assert int(box.max()) > 0 and int(leaf.max()) > 0
        # the plain walk of that object is the kernel's plain version
        out = wavefront.walk_object(
            tuple(on.unbind(-1)), d.unbind(-1),
            torch.full((32 * 24,), float(MISS)), sc, pinfo, k)
        assert torch.equal(out[4], box) and torch.equal(out[5], leaf)


def test_heat_color_matches_jax():
    """Every even box count to 4,000 and leaf count to 600."""
    box = np.arange(0, 4001, 2, dtype=np.int32)
    leaf = np.arange(box.size, dtype=np.int32) % 601
    cj = np.asarray(_heat_color(jnp.asarray(box), jnp.asarray(leaf)))
    ct = heat_color(torch.from_numpy(box), torch.from_numpy(leaf)).numpy()
    np.testing.assert_array_equal(ct[:, :2], cj[:, :2])
    arg = (np.float32(0.01) * (box.astype(np.float32) - np.float32(200.0))
           ).astype(np.float32)
    rounded = np.exp(arg.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ct[:, 2], rounded)
    xla_rounds = cj[:, 2] == rounded
    np.testing.assert_array_equal(ct[xla_rounds, 2], cj[xla_rounds, 2])
    ulps = np.abs(ct[:, 2].view(np.int32) - cj[:, 2].view(np.int32))
    assert ulps.max() <= 1 and xla_rounds.mean() > 0.8


def test_debug_frame_matches_jax(forest):
    """The two-object forest at 32x24: the port's frame (one walk per
    object) against the JAX package's per-object XLA path, within 1e-6;
    green 0, every ray at least the constant red term."""
    dev, info, sc, pinfo = forest
    cfg = RenderConfig(width=32, height=24, debug=True, auto_focus=False)
    jimg = np.asarray(jdebug(
        dev, jnp.asarray(CAM[0]), jnp.asarray(CAM[1]), info=info,
        params=_frame_params(JConfig(debug=True)), width=32, height=24,
        cam_size=cfg.cam_size, focal_length=cfg.focal_length))
    timg = render_debug_frame(sc, pinfo, cfg, *CAM, device="cpu").numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-6)
    assert (timg[..., 1] == 0).all()
    assert (timg[..., 0] >= np.exp(-3.0) / 2 - 1e-6).all()
    assert timg[..., 2].max() > timg[..., 2].min()
    assert timg[..., 0].max() > np.exp(-3.0) / 2 + 0.01


def test_renderer_debug_matches_jax(forest):
    """Renderer with debug=True: two heatmap frames accumulate as the JAX
    Renderer's do (the same seed draws, no queries counted)."""
    dev, info, sc, pinfo = forest
    kw = dict(width=16, height=12, debug=True, auto_focus=False)
    jr = JRenderer(dev, info, JConfig(**kw), cam_pos=CAM[0],
                   cam_rot=CAM[1], seed=3)
    tr = Renderer(sc, pinfo, RenderConfig(**kw), cam_pos=CAM[0],
                  cam_rot=CAM[1], seed=3, device="cpu")
    jimg, timg = np.asarray(jr.render(2)), tr.render(2).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-6)
    tr.step()
    jr.step()
    np.testing.assert_allclose(tr.display_image().numpy(),
                               np.asarray(jr.display_image()), atol=1e-6)
    assert tr._count == jr._count == 3
    assert tr._seed_draws == jr._seed_draws == 3
    assert tr.rays_traced == 0


def test_no_objects_give_zeros():
    """Analytic primitives alone: a black frame, as in the JAX package."""
    sc = Scene()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_sphere((0.0, 0.0, 3.0), 1.0, m=0)
    s, i = sc.build(device="cpu")
    js = JScene()
    js.set_constant_sky((0.3, 0.3, 0.3))
    js.add_material("m")
    js.add_sphere((0.0, 0.0, 3.0), 1.0, m=0)
    dev, info = js.build()
    cfg = RenderConfig(width=8, height=6, debug=True)
    timg = render_debug_frame(s, i, cfg, (0, 0, 0), (0, 0, 0), device="cpu")
    jimg = jdebug(dev, jnp.zeros(3), jnp.zeros(3), info=info,
                  params=_frame_params(JConfig()), width=8, height=6,
                  cam_size=cfg.cam_size, focal_length=cfg.focal_length)
    assert timg.shape == (6, 8, 3) and not timg.any()
    assert not np.asarray(jimg).any()


def test_streamed_counters_per_ray(tmp_path):
    """tests/test_debug_tools.py::test_heatmap_streamed's scene (a 10x10
    grid streamed): the frame is the colour of the port's plain walker's
    per-ray counters, unsorted, over the object count, to every bit; the
    JAX package's per-block frame has the same scale."""
    from tests.test_wavefront import _tri_grid_obj

    path = str(tmp_path / "g.obj")
    _tri_grid_obj(path, 10, 10)
    sc = Scene()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_object(path, material=0)
    cfg = RenderConfig(width=48, height=32, debug=True, auto_focus=False,
                       stream_threshold=0, max_tris_in_leaf=4)
    s, i = sc.build(cfg, device="cpu")
    assert i.streamed and i.num_objects == 0 and i.num_tri_objects == 1
    cam = ((3.0, 2.0, -6.0), (0.0, 0.0, 0.0))
    timg = render_debug_frame(s, i, cfg, *cam, device="cpu")
    uv, _ = camera.pixel_centers(48, 32, "cpu")
    d = camera.primary_directions(uv, vm.rotation_matrix(torch.zeros(3)),
                                  cfg.cam_size, cfg.focal_length,
                                  32 / 48.0)
    o = torch.tensor(cam[0]).expand(d.shape)
    on = traverse.nudged(o.unbind(-1), d.unbind(-1))
    out = wavefront.streamed_reference(on, d.unbind(-1),
                                       torch.full((48 * 32,), float(MISS)),
                                       s, i)
    want = heat_color(out[4], out[5]).reshape(32, 48, 3)
    assert torch.equal(timg, want)
    assert int(out[5].max()) > 0 and float(timg[..., 2].max()) > 0.0

    js = JScene()
    js.set_constant_sky((0.3, 0.3, 0.3))
    js.add_material("m")
    js.add_object(path, material=0)
    dev, info = js.build(JConfig(stream_threshold=0, max_tris_in_leaf=4))
    jimg = np.asarray(jdebug(
        dev, jnp.asarray(cam[0]), jnp.zeros(3), info=info,
        params=_frame_params(JConfig(debug=True)), width=48, height=32,
        cam_size=cfg.cam_size, focal_length=cfg.focal_length))
    assert np.isfinite(jimg).all() and jimg[..., 2].max() > 0
    # per block the count is the block's busiest ray's or more
    assert float(timg[..., 0].max()) <= jimg[..., 0].max() + 1e-6
