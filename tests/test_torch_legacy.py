"""The port's legacy modes (pathtracer0_tpu_torch.shade.arealights, the
legacy records and disk lights of Scene and packing, rng.uniform_cube_vec
and disk_sample) against the JAX package on the CPU.

Tolerances: RNG draws and states bit-equal; the legacy records bit-equal;
shadePoint colour within 1e-5 and pathTrace colour within 1e-4 of the JAX
package's (float32 libm ulps in pow and exp, no knife edge in these
scenes); whole frames through Renderer within 1e-4; glossy refraction, whose
hash fract(sin(s) 47678.786234) turns one ulp of sin into a different
number, bit for bit where the two sines agree and otherwise under the
golden image budget, RMSE < 0.05.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Renderer as JRenderer
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.core import rng as jrng
from pathtracer0_tpu.render.renderer import _frame_params
from pathtracer0_tpu.shade import arealights as jarea
from pathtracer0_tpu.shade import mtl as jmtl
from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.render.renderer import render_frame
from pathtracer0_tpu_torch.scene import packing
from pathtracer0_tpu_torch.shade import arealights as tarea
from pathtracer0_tpu_torch.shade import mtl as tmtl
from pathtracer0_tpu_torch.utils import image as img_util

torch.set_num_threads(1)

SKY = (0.18, 0.24, 0.32)


def _soa(a):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return (t[:, 0], t[:, 1], t[:, 2])


def _states(n, seed=7):
    return (jrng.seed(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(seed)),
            trng.seed(torch.arange(n), seed))


def _same_state(js, ts):
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())


def _both(build, cfg_kw=None, **kw):
    """(JAX DeviceScene, info, port scene, info) of build(cls, **kw)."""
    cfg_kw = cfg_kw or {}
    dev, info = build(JScene, **kw).build(JConfig(**cfg_kw))
    sc, pinfo = build(Scene, **kw).build(RenderConfig(**cfg_kw),
                                         device="cpu")
    return dev, info, sc, pinfo


# ---------------------------------------------------------------- rng --

def test_uniform_cube_and_disk_draws_bit_equal():
    """4,096 seeded states: the cube vector, the disk point on random
    normals (one in eight with a zero component) and the states after."""
    js, ts = _states(4096, 1234)
    vj, js2 = jrng.uniform_cube_vec(js)
    vt, ts2 = trng.uniform_cube_vec(ts)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    _same_state(js2, ts2)
    n = np.random.RandomState(3).randn(4096, 3).astype(np.float32)
    n[::8, 1] = 0.0
    pj, js3 = jrng.disk_sample(js2, jnp.asarray(n))
    pt, ts3 = trng.disk_sample(ts2, torch.from_numpy(n))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    _same_state(js3, ts3)


# --------------------------------------------------- legacy materials --

def _with_legacy(cls, records=True):
    sc = cls()
    sc.set_constant_sky((0.1, 0.1, 0.1))
    sc.add_material("m0")
    sc.add_sphere((0.0, 0.0, 5.0), 1.0, m=0)
    if records:
        sc.add_mat(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                   32.0, 0.25, 0.75, 1.5, 2.0, 0.33, 1.0, 0.05, 3.0)
        sc.add_mat(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0,
                   8.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, -1.0)
    return sc


def _lit_scene(cls, illum=2, blocker=True, density=None):
    """tests/test_arealights.py's scene: a ground sphere, a blocker and an
    emissive sphere with its disk light."""
    sc = cls()
    sc.set_constant_sky((0.0, 0.0, 0.0))
    sc.add_material("ground")
    sc.set_last_mtl("Kd", (0.6, 0.6, 0.6))
    sc.set_last_mtl("Ka", (0.02, 0.02, 0.02))
    sc.set_last_mtl("Ks", (0.4, 0.4, 0.4))
    sc.set_last_mtl("Ns", 16.0)
    sc.set_last_mtl("illum", illum)
    sc.add_material("blocker")
    sc.set_last_mtl("Kd", (0.4, 0.2, 0.2))
    sc.set_last_mtl("illum", 0)
    sc.add_material("light")
    sc.set_last_mtl("Ke", (4.0, 3.6, 3.0))
    if density is not None:
        sc.set_last_mtl("Density", density)
    sc.add_sphere((0.0, -100.5, 5.0), 100.0, m=0)
    if blocker:
        sc.add_sphere((0.8, 0.7, 5.0), 0.8, m=1)
    sc.add_emissive_sphere((0.8, 2.2, 5.0), 0.5, m=2)
    return sc


@pytest.mark.parametrize("case", ["layout", "placeholder", "decode",
                                  "emission_strength"])
def test_legacy_mats_against_jax(case):
    """The four cases of tests/test_legacy_mats.py, each held against the
    JAX package: the packed records, the placeholder of no records, the
    decode, and Density scaling the emissive return and the grid's
    intensity in legacy shading (frames within 1e-5)."""
    if case == "emission_strength":
        imgs = {}
        for density in (1.0, 3.0):
            dev, info, sc, pinfo = _both(_lit_scene, illum=0, blocker=False,
                                         density=density)
            imgs[density] = _legacy_frames(dev, info, sc, pinfo, spp=4,
                                           raytracing=False, w=64, h=48)
        for jimg, timg in imgs.values():
            np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-5)
        img1, img3 = imgs[1.0][1], imgs[3.0][1]
        assert img3.max() > img1.max() * 2.5
        assert img3[:16].mean() > img1[:16].mean() * 1.5
        return
    dev, info, sc, pinfo = _both(_with_legacy,
                                 records=case != "placeholder")
    assert pinfo.n_legacy_mats == info.n_legacy_mats
    np.testing.assert_array_equal(sc.legacy_mats.numpy(),
                                  np.asarray(dev.legacy_mats))
    if case == "placeholder":
        assert tuple(sc.legacy_mats.shape) == (1, 18)
        assert not sc.legacy_mats.any()
    if case == "decode":
        mj = jmtl.decode_legacy(dev.legacy_mats,
                                jnp.asarray([0, 1, -1], jnp.int32))
        mt = tmtl.decode_legacy(sc.legacy_mats, torch.tensor([0, 1, -1]))
        for name in jmtl.LegacyMat._fields:
            np.testing.assert_array_equal(
                getattr(mt, name).numpy(),
                np.asarray(getattr(mj, name)).astype(
                    getattr(mt, name).numpy().dtype), name)
        assert int(mt.texture_id[0]) == 3 and int(mt.texture_id[1]) == -1


def test_scene_from_numpy_carries_records_and_lights():
    dev, info, sc, pinfo = _both(_lit_scene)
    dev2, info2 = _both(_with_legacy)[:2]
    for d, i, want in ((dev, info, pinfo), (dev2, info2, None)):
        got, ginfo = packing.scene_from_numpy(
            {k: np.asarray(getattr(d, k)) for k in d._fields}, i._asdict(),
            device="cpu")
        np.testing.assert_array_equal(got.legacy_mats.numpy(),
                                      np.asarray(d.legacy_mats))
        for key in ("lights", "light_centers", "light_radii",
                    "n_legacy_mats"):
            assert getattr(ginfo, key) == getattr(i, key), key
        if want is not None:
            assert ginfo == want


# ------------------------------------------------------------ shading --

def _rays(nx=12, ny=9):
    """A 12 x 9 fan of rays from (0, 0.5, 0), as the tests of the JAX
    package aim theirs."""
    x = np.linspace(-0.8, 0.8, nx)
    y = np.linspace(-0.55, 0.55, ny)
    X, Y = np.meshgrid(x, y)
    v = np.stack([X.ravel(), Y.ravel(), np.ones(nx * ny)], -1)
    d = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros_like(d)
    o[:, 1] = 0.5
    return o, d


@pytest.mark.parametrize("illum", [0, 2])
@pytest.mark.parametrize("sample_res", [0, 1, 2, 3])
def test_shade_point_matches_jax(sample_res, illum):
    """shadePoint on tests/test_arealights.py's scene: the emissive
    sphere (its raw Ke x Density), lit and shadowed ground, the sky; colour
    within 1e-5, the state bit-equal (3 draws a grid point, none at S =
    0)."""
    dev, info, sc, pinfo = _both(_lit_scene, illum=illum)
    o, d = _rays()
    js, ts = _states(o.shape[0])
    cj, sj = jarea.shade_point(jnp.asarray(o), jnp.asarray(d), js, dev, info,
                               _frame_params(JConfig()), sample_res)
    ct, st = tarea.shade_point(_soa(o), _soa(d), ts, sc, pinfo, sample_res)
    ct = torch.stack(ct, -1).numpy()
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=0, atol=1e-5)
    _same_state(sj, st)
    if sample_res == 0:
        _same_state(js, st)
    assert ct.max() >= 4.0           # the emissive sphere's raw Ke


def test_shade_point_queries_once_per_light():
    """The S = 3 grid's 12 shadow rays a light go out as one query."""
    from pathtracer0_tpu_torch.kernels import traverse

    dev, info, sc, pinfo = _both(_lit_scene)
    o, d = _rays(4, 3)
    calls = []
    real = traverse.ray_scene

    def counting(*a, **k):
        calls.append(a[0][0].shape[0])
        return real(*a, **k)

    traverse.ray_scene = counting
    try:
        tarea.shade_point(_soa(o), _soa(d), _states(12)[1], sc, pinfo, 3)
    finally:
        traverse.ray_scene = real
    assert calls == [12, 12 * len(tarea.grid_points(3))]
    assert len(tarea.grid_points(3)) == 12 and len(tarea.grid_points(4)) == 21
    assert tarea.draws_per_shade(pinfo, 4) == 63


def _pt_scene(cls, glossy=0.0):
    """tests/test_legacy_pathtrace.py's scene: Phong ground, absorbing
    glass, a Fresnel mirror and an emissive sphere light; `glossy` is the
    glass's Pr (0: sharp refraction)."""
    sc = cls()
    sc.set_constant_sky(SKY)
    sc.add_material("ground")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Kd", (0.55, 0.5, 0.45))
    sc.set_last_mtl("Ka", (0.03, 0.03, 0.03))
    sc.set_last_mtl("Ks", (0.3, 0.3, 0.3))
    sc.set_last_mtl("Ns", 24.0)
    sc.set_last_mtl("illum", 2)
    sc.add_material("glass")
    sc.set_last_mtl("Pr", glossy)
    sc.set_last_mtl("Kd", (0.1, 0.1, 0.1))
    sc.set_last_mtl("Tr", 0.92)
    sc.set_last_mtl("Ni", 1.5)
    sc.set_last_mtl("Tf", (0.9, 0.75, 0.85))
    sc.set_last_mtl("illum", 1)
    sc.add_material("metal")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Kd", (0.2, 0.2, 0.25))
    sc.set_last_mtl("Ks", (0.5, 0.5, 0.5))
    sc.set_last_mtl("Ns", 64.0)
    sc.set_last_mtl("Pm", 0.7)
    sc.set_last_mtl("illum", 2)
    sc.add_material("light")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Ke", (4.0, 3.6, 3.0))
    sc.add_sphere((0.0, -100.6, 5.0), 100.0, m=0)
    sc.add_sphere((-0.9, 0.1, 4.0), 0.7, m=1)
    sc.add_sphere((1.0, 0.2, 5.0), 0.8, m=2)
    sc.add_emissive_sphere((0.0, 2.6, 4.5), 0.5, m=3)
    return sc


def _mesh_obj(path):
    """Two objects in one OBJ file: a 6x6 metal-like ground grid and a
    slanted quad, 74 triangles."""
    lines, faces = [], []
    rs = np.random.RandomState(4)
    lines.append("o ground")
    for i in range(6):
        for k in range(6):
            x, z = -3.0 + i, 2.5 + k
            y = -0.6 + rs.rand() * 0.1
            base = len([ln for ln in lines if ln.startswith("v ")])
            lines += ["v %.4f %.4f %.4f" % p for p in (
                (x, y, z), (x + 1, y, z), (x, y, z + 1), (x + 1, y, z + 1))]
            faces += [f"f {base + 1} {base + 2} {base + 3}",
                      f"f {base + 2} {base + 4} {base + 3}"]
    lines += faces
    base = 4 * 36
    lines += ["o panel", "v 0.6 -0.6 4.6", "v 1.6 -0.6 4.2",
              "v 0.6 0.9 4.9", "v 1.6 0.9 4.5",
              f"f {base + 1} {base + 2} {base + 3}",
              f"f {base + 2} {base + 4} {base + 3}"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _mesh_scene(cls, obj=None):
    sc = cls()
    sc.set_constant_sky(SKY)
    sc.add_material("shiny")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Kd", (0.5, 0.45, 0.4))
    sc.set_last_mtl("Ks", (0.4, 0.4, 0.4))
    sc.set_last_mtl("Ns", 12.5)
    sc.set_last_mtl("Pm", 0.35)
    sc.set_last_mtl("illum", 2)
    sc.add_material("glass")
    sc.set_last_mtl("Pr", 0.0)
    sc.set_last_mtl("Tr", 0.9)
    sc.set_last_mtl("Ni", 1.45)
    sc.set_last_mtl("illum", 1)
    sc.add_material("light")
    sc.set_last_mtl("Ke", (3.0, 3.0, 2.6))
    sc.add_object(obj, material=0)
    sc.add_sphere((-0.8, 0.0, 4.2), 0.5, m=1)
    sc.add_emissive_sphere((0.3, 2.4, 4.8), 0.4, m=2)
    return sc


@pytest.fixture(scope="module")
def mesh_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("legacy") / "two.obj")
    _mesh_obj(path)
    return path


@pytest.mark.parametrize("scene,sample_res", [("spheres", 0),
                                              ("spheres", 2),
                                              ("mesh", 0), ("mesh", 1)])
def test_path_trace_matches_jax(scene, sample_res, mesh_obj):
    """pathTrace, 4 bounces: tests/test_legacy_pathtrace.py's spheres and
    a two-object OBJ mesh (the forest route) with a light; colour within
    1e-4, the state and the counted queries equal. (The JAX package's
    grid of shadow queries costs it over a minute on the mesh, so the mesh
    takes the one-ray shadow, S = 1.)"""
    if scene == "mesh":
        dev, info, sc, pinfo = _both(_mesh_scene, cfg_kw=dict(
            max_tris_in_leaf=2), obj=mesh_obj)
        assert pinfo.num_objects == 2 and pinfo.lights == info.lights
    else:
        dev, info, sc, pinfo = _both(_pt_scene)
    o, d = _rays()
    js, ts = _states(o.shape[0])
    params = _frame_params(JConfig(max_bounces=4))
    cj, sj, rj = jarea.path_trace(jnp.asarray(o), jnp.asarray(d), js, dev,
                                  info, params, sample_res=sample_res,
                                  max_bounces=4)
    ct, st, rt = tarea.path_trace(_soa(o), _soa(d), ts, sc, pinfo,
                                  sample_res, 4)
    ct = torch.stack(ct, -1).numpy()
    assert np.isfinite(ct).all()
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=0, atol=1e-4)
    _same_state(sj, st)
    assert int(rt) == int(float(rj)) > o.shape[0]


def _glass(cls):
    """A glossy glass sphere (Pr defaults to 1) under an emissive one."""
    sc = cls()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("glass")
    sc.set_last_mtl("Tr", 0.92)
    sc.set_last_mtl("Ni", 1.5)
    sc.set_last_mtl("illum", 7)
    sc.set_last_mtl("Tf", (0.05, 0.22, 0.25))
    sc.add_material("light")
    sc.set_last_mtl("Ke", (6.0, 5.5, 5.0))
    sc.add_sphere((0.0, 0.0, 5.0), 1.5, m=0)
    sc.add_emissive_sphere((0.0, 6.0, 4.0), 1.0, m=1)
    return sc


def test_drained_stack_gives_nan_as_in_jax():
    """A path that leaves glass with its refraction stack drained by the
    second mutation divides 0 by 0 in eta and Fresnel: NaN, in the JAX
    package as in the port, on the same rays; the others within 1e-4."""
    dev, info, sc, pinfo = _both(_glass)
    o, d = _rays(24, 18)
    o[:, 1] = 0.0
    js, ts = _states(o.shape[0])
    cj, sj, _ = jarea.path_trace(jnp.asarray(o), jnp.asarray(d), js, dev,
                                 info, _frame_params(JConfig()),
                                 sample_res=0, max_bounces=6)
    ct, st, _ = tarea.path_trace(_soa(o), _soa(d), ts, sc, pinfo, 0, 6)
    cj, ct = np.asarray(cj), torch.stack(ct, -1).numpy()
    nan = np.isnan(cj).any(-1)
    np.testing.assert_array_equal(np.isnan(ct).any(-1), nan)
    assert 0 < nan.sum() < nan.size // 4
    np.testing.assert_allclose(ct[~nan], cj[~nan], rtol=0, atol=1e-4)
    _same_state(sj, st)


def test_glsl_rand_bit_equal_where_the_sines_agree():
    """The hash at 65,536 points of the scenes' range: bit-equal wherever
    torch's float32 sine, rounded from float64, is XLA's float32 sine; the
    share where they agree is recorded (>= 95%)."""
    v = np.random.RandomState(5).uniform(-8.0, 8.0, (65536, 3)).astype(
        np.float32)
    hj = np.asarray(jarea._glsl_rand(jnp.asarray(v)))
    ht = tarea._glsl_rand(_soa(v)).numpy()
    s = (np.float32(47.57891) * v[:, 0] + v[:, 1]
         + np.float32(425.0) * v[:, 2]).astype(np.float32)
    agree = (np.asarray(jnp.sin(jnp.asarray(s)))
             == np.sin(s.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(ht[agree], hj[agree])
    assert agree.mean() >= 0.95
    assert ((ht >= 0.0) & (ht < 1.0)).all()


def test_glossy_refraction_under_the_image_budget():
    """Glossy glass (Pr 0.3) at S = 0, 32x24: the hash decides where the
    refraction goes, so the frames agree under the golden budget."""
    dev, info, sc, pinfo = _both(_pt_scene, glossy=0.3)
    jimg, timg = _legacy_frames(dev, info, sc, pinfo, spp=0,
                                raytracing=True, w=32, h=24, bounces=4)
    err = img_util.rmse(np.clip(timg, 0, 1), np.clip(jimg, 0, 1))
    assert err < 0.05, err
    assert np.isfinite(timg).all()


# ------------------------------------------------------------ frames --

def _legacy_frames(dev, info, sc, pinfo, spp, raytracing, w, h, bounces=3,
                   seed=5):
    """One legacy frame of each package through render_frame (no
    autofocus, blur 0): (JAX image, port image)."""
    from pathtracer0_tpu.render.renderer import render_frame as jrender

    kw = dict(width=w, height=h, samples_per_frame=spp, max_bounces=bounces,
              raytracing=raytracing, legacy_shading=True,
              legacy_pathtrace=True, auto_focus=False, blur=0.0)
    jcfg = JConfig(**kw)
    jimg, _ = jrender(
        dev, jnp.asarray([0.0, 0.5, 0.0]), jnp.zeros(3), jnp.uint32(seed),
        info=info, params=_frame_params(jcfg), width=w, height=h, spp=spp,
        raytracing=raytracing, auto_focus=False, cam_size=jcfg.cam_size,
        focal_length=jcfg.focal_length, blur=0.0,
        focal_distance=jcfg.focal_distance)
    timg, _ = render_frame(sc, pinfo, RenderConfig(**kw), (0.0, 0.5, 0.0),
                           (0.0, 0.0, 0.0), seed, device="cpu")
    return np.asarray(jimg), timg.numpy()


@pytest.mark.parametrize("mode", ["legacy_shading", "legacy_pathtrace"])
def test_renderer_matches_jax(mode):
    """Renderer of each package, same seed, two frames at 16x12 with
    autofocus and blur (S = 2): display images within 1e-4, the counted
    queries equal, and the Whitted frame path is not taken."""
    dev, info, sc, pinfo = _both(_pt_scene)
    kw = dict(width=16, height=12, samples_per_frame=2, max_bounces=3,
              raytracing=mode == "legacy_pathtrace", **{mode: True})
    jr = JRenderer(dev, info, JConfig(**kw), cam_pos=(0.0, 0.5, 0.0),
                   seed=11)
    tr = Renderer(sc, pinfo, RenderConfig(**kw), cam_pos=(0.0, 0.5, 0.0),
                  seed=11, device="cpu")
    jimg, timg = np.asarray(jr.render(2)), tr.render(2).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=1e-4)
    assert tr.rays_traced == int(jr.rays_traced)
    if mode == "legacy_shading":
        assert tr.rays_traced == 2 * 16 * 12
    assert timg.max() > 1.0          # the light's raw Ke is in view


def test_legacy_modes_apply_as_in_jax():
    """legacy_pathtrace applies in path mode, legacy_shading in Whitted
    mode on a scene with lights; a Whitted scene without lights renders
    as plain Whitted (the frame path being skipped all the same)."""
    dev, info, sc, pinfo = _both(_with_legacy)
    kw = dict(width=8, height=6, samples_per_frame=1, raytracing=False,
              legacy_shading=True, auto_focus=False, blur=0.0)
    plain, _ = render_frame(sc, pinfo, RenderConfig(**{**kw, "legacy_shading":
                                                       False}),
                            (0, 0, 0), (0, 0, 0), 3, device="cpu")
    legacy, _ = render_frame(sc, pinfo, RenderConfig(**kw), (0, 0, 0),
                             (0, 0, 0), 3, device="cpu")
    assert not pinfo.lights
    np.testing.assert_allclose(legacy.numpy(), plain.numpy(), atol=1e-6)
