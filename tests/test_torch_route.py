"""The port's per-bounce route as a whole (OBJ -> SAH forest -> ray_scene ->
bounce loop -> frame) against the JAX package's, on the CPU: the same OBJ
and the same seed through JAX `render_frame(fused="off",
pallas="interpret")` and the port's `render_frame(device="cpu",
fused="off")`; the block path (`trace_fused`, plain version) against JAX
`fused="interpret"`; Whitted shading with the thickness probe; and the
port's routes against each other.

Tolerances are those of tests/test_fused.py: RNG state bit-equal on >= 99%
of the rays, per-pixel max-abs radiance difference < 1e-4 on >= 99% of the
pixels, mean abs difference < 5e-3, ray count within 1% + 16. Route
against route (two triangle tests that differ in ulps) is held to the
golden budget, RMSE < 0.05.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu import scenes as jscenes
from pathtracer0_tpu.core import camera as jcamera
from pathtracer0_tpu.core import rng as jrng
from pathtracer0_tpu.render import integrator as jintegrator
from pathtracer0_tpu.render import renderer as jrenderer
from pathtracer0_tpu_torch import (RenderConfig, Renderer, Scene, render_frame,
                                   scenes)
from pathtracer0_tpu_torch import scenes as tscenes
from pathtracer0_tpu_torch.core import camera as tcamera
from pathtracer0_tpu_torch.core import math as tmath
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import fused as tfused
from pathtracer0_tpu_torch.kernels import wavefront as twavefront
from pathtracer0_tpu_torch.render import integrator as tintegrator
from pathtracer0_tpu_torch.render.renderer import render_rays
from pathtracer0_tpu_torch.scene.packing import MAX_TRIS, scene_from_numpy
from pathtracer0_tpu_torch.utils import image as img_util

torch.set_num_threads(1)

W, H, SPP, BOUNCES, SEED = 32, 24, 2, 3, 4321
CAM, ROT = (4.2, 3.2, -1.5), (0.55, 0.0, 0.0)


def _grid_obj(path, nx=12, nz=12, seed=0):
    """The jittered triangle grid of tests/test_wavefront.py, plus a closed
    box (its own object and material) standing on it."""
    rng = np.random.RandomState(seed)
    lines = ["o grid", "usemtl ground"]
    faces = []
    vid = 0
    for i in range(nx):
        for k in range(nz):
            bx, bz = i * 0.7, k * 0.7
            by = rng.rand() * 1.5
            p = np.array([[bx, by, bz],
                          [bx + 0.6, by + rng.randn() * 0.3, bz],
                          [bx, by + rng.randn() * 0.3, bz + 0.6]])
            for v in p:
                lines.append(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}")
            faces.append(f"f {vid + 1} {vid + 2} {vid + 3}")
            vid += 3
    lines += faces
    lines += ["o box", "usemtl wax"]
    c = np.array([4.2, 2.2, 3.0])
    corners = [c + 0.6 * np.array([sx, sy, sz])
               for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    for v in corners:
        lines.append(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}")
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    for a, b, cc, d in quads:
        lines.append(f"f {vid + a + 1} {vid + b + 1} {vid + cc + 1}")
        lines.append(f"f {vid + a + 1} {vid + cc + 1} {vid + d + 1}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fill(sc, path, subsurface):
    """The same scene through either package's Scene API: the OBJ, a metal
    and a glass sphere, a gradient sky."""
    sky = np.zeros((16, 32, 3), np.float32)
    for row in range(16):
        sky[row] = (0.4 + 0.02 * row, 0.5 + 0.02 * row, 0.9 - 0.01 * row)
    sc.set_sky(sky, "sky")
    sc.add_material("ground")
    sc.set_last_mtl("Kd", (0.6, 0.55, 0.4))
    sc.set_last_mtl("Ka", (0.05, 0.02, 0.0))
    sc.set_last_mtl("Pr", 0.9)
    sc.add_material("wax")
    sc.set_last_mtl("Kd", (0.8, 0.3, 0.3))
    sc.set_last_mtl("Pr", 0.7)
    if subsurface:
        sc.set_last_mtl("subsurface", 0.7)
        sc.set_last_mtl("subsurfaceColor", (0.9, 0.5, 0.3))
        sc.set_last_mtl("subsurfaceRadius", (0.8, 0.4, 0.3))
    sc.add_material("metal")
    sc.set_last_mtl("Pm", 1.0)
    sc.set_last_mtl("Pr", 0.05)
    sc.set_last_mtl("Ks", (0.9, 0.85, 0.7))
    sc.set_last_mtl("Kd", (0.9, 0.85, 0.7))
    sc.add_material("glass")
    sc.set_last_mtl("Tr", 0.92)
    sc.set_last_mtl("Ni", 1.5)
    sc.set_last_mtl("illum", 7)
    sc.set_last_mtl("Tf", (0.05, 0.22, 0.25))
    sc.set_last_mtl("Density", 0.8)
    sc.add_object(path, material=0)
    sc.add_sphere((2.0, 2.2, 2.0), 0.7, m=2)
    sc.add_sphere((6.3, 2.0, 2.5), 0.8, m=3)
    return sc


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX scene, info), (port scene, info), per `subsurface`."""
    path = str(tmp_path_factory.mktemp("objs") / "grid_box.obj")
    _grid_obj(path)
    cache = {}

    def get(subsurface=False):
        if subsurface not in cache:
            dev, info = _fill(JScene(), path, subsurface).build(
                JConfig(max_tris_in_leaf=4))
            sc, pinfo = _fill(Scene(), path, subsurface).build(
                device="cpu", config=RenderConfig(max_tris_in_leaf=4))
            cache[subsurface] = (dev, info, sc, pinfo)
        return cache[subsurface]
    return get


def _jax_frame(dev, info, *, raytracing=True, fused="off",
               pallas="interpret", ifd=None):
    cfg = JConfig(width=W, height=H, samples_per_frame=SPP,
                  max_bounces=BOUNCES, auto_focus=False, focal_distance=6.0,
                  blur=0.001, fused=fused, pallas=pallas,
                  raytracing=raytracing)
    return jrenderer.render_frame(
        dev, jnp.asarray(CAM, jnp.float32), jnp.asarray(ROT, jnp.float32),
        jnp.uint32(SEED), info=info, params=jrenderer._frame_params(cfg),
        width=W, height=H, spp=SPP, raytracing=raytracing, auto_focus=False,
        cam_size=cfg.cam_size, focal_length=cfg.focal_length, blur=cfg.blur,
        focal_distance=cfg.focal_distance)


def _port_cfg(**kw):
    cfg = dict(width=W, height=H, samples_per_frame=SPP, max_bounces=BOUNCES,
               auto_focus=False, focal_distance=6.0, blur=0.001, fused="off")
    cfg.update(kw)
    return RenderConfig(**cfg)


def _assert_frames(a, b, rays_a, rays_b):
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, (diff.max(), (diff < 1e-4).mean())
    assert np.abs(a - b).mean() < 5e-3
    assert abs(float(rays_a) - float(rays_b)) <= 0.01 * float(rays_a) + 16


def test_scene_takes_the_brute_kernel_and_has_both_objects(pair):
    dev, info, sc, pinfo = pair()
    assert pinfo.num_objects == info.num_objects == 2
    assert pinfo.num_tris == 156 and twavefront.use_brute(pinfo)
    assert pinfo.num_ellipsoids == 2


def test_route_frame_matches_jax(pair):
    """The slice end to end: path mode."""
    dev, info, sc, pinfo = pair()
    img_j, rays_j = _jax_frame(dev, info)
    img_t, rays_t = render_frame(sc, pinfo, _port_cfg(), CAM, ROT, SEED,
                                 device="cpu")
    a, b = np.asarray(img_j), img_t.numpy()
    _assert_frames(a, b, rays_j, int(rays_t))
    # the picture shows the mesh, the spheres and the sky
    assert b.std() > 0.05


def test_route_frame_matches_jax_vmapped(pair):
    """Against the JAX package's other traversal (pallas="off")."""
    dev, info, sc, pinfo = pair()
    img_j, rays_j = _jax_frame(dev, info, pallas="off")
    img_t, rays_t = render_frame(sc, pinfo, _port_cfg(pallas="off"), CAM,
                                 ROT, SEED, device="cpu")
    _assert_frames(np.asarray(img_j), img_t.numpy(), rays_j, int(rays_t))


def _primary_rays(n_pix_w=W, n_pix_h=H, cam=CAM, rot=ROT, seed=SEED):
    """One sample's rays and RNG state as both packages make them."""
    uv, index = jcamera.pixel_centers(n_pix_w, n_pix_h)
    state = jrng.seed(index, jnp.uint32(seed))
    d = jcamera.primary_directions(uv, jnp.asarray(rot, jnp.float32), 1.5,
                                   1.0, n_pix_h / float(n_pix_w))
    o = jnp.broadcast_to(jnp.asarray(cam, jnp.float32), d.shape)
    ifd = jnp.full(d.shape[:-1], 6.0, jnp.float32)
    o, d, state = jcamera.dof_ray(o, d, jnp.asarray(rot, jnp.float32),
                                  jnp.float32(0.001), ifd, state)
    return o, d, state


def _soa(a):
    t = torch.tensor(np.asarray(a))
    return tuple(t[:, i].contiguous() for i in range(3))


def _assert_trace(out_j, out_t):
    inc_j, st_j, rays_j = out_j
    rad_t, st_t, q_t = out_t
    a = np.asarray(inc_j)
    b = torch.stack(list(rad_t), dim=-1).numpy()
    state_eq = (np.asarray(st_j).astype(np.int64) == st_t.numpy()).mean()
    assert state_eq >= 0.99, state_eq
    _assert_frames(a, b, rays_j, int(q_t))


def test_trace_bounces_state_and_radiance_match_jax(pair):
    """`integrator.trace` on one sample's rays: the RNG streams stay
    bit-equal (the state advances only for rays that hit), radiance and
    query count agree."""
    dev, info, sc, pinfo = pair()
    o, d, state = _primary_rays()
    params = jintegrator.TraceParams(max_bounces=BOUNCES, fused="off",
                                     pallas="interpret")
    out_j = jintegrator.trace(o, d, state, dev, info, params)
    st = torch.tensor(np.asarray(state).astype(np.int64))
    alive = torch.ones(st.shape, dtype=torch.bool)
    out_t = tintegrator.trace(sc, pinfo, _soa(o), _soa(d), alive, st,
                              max_bounces=BOUNCES, fused="off")
    _assert_trace(out_j, out_t)
    assert int(out_t[2]) > W * H


FS_FIELDS = ("fs_tris", "fs_attr", "fs_uvt", "fs_maps", "fs_sky",
             "materials", "ell_tab", "imp_tab", "tex_data", "tex_sizes")


def test_trace_fused_plain_matches_jax_interpret():
    """The block path on config 6's rays: the plain version of the block
    kernel against the Pallas `_fused_kernel` in interpret mode."""
    dev, info = jscenes.BUILDERS[6]().build(max_leaf=4)
    sc, pinfo = scene_from_numpy(
        {k: np.asarray(getattr(dev, k)) for k in FS_FIELDS}, info._asdict(),
        device="cpu")
    cam, rot = jscenes.CAMERAS[6]
    o, d, state = _primary_rays(cam=cam, rot=rot)
    params = jintegrator.TraceParams(max_bounces=BOUNCES, fused="interpret")
    out_j = jintegrator.trace(o, d, state, dev, info, params)
    st = torch.tensor(np.asarray(state).astype(np.int64))
    alive = torch.ones(st.shape, dtype=torch.bool)
    before = tfused.trace_block.launches
    out_t = tfused.trace_fused(sc, pinfo, _soa(o), _soa(d), alive, st,
                               max_bounces=BOUNCES)
    assert tfused.trace_block.launches == before    # CPU: the plain version
    _assert_trace(out_j, out_t)
    # rays not alive keep their state, give no radiance, count no query
    half = torch.arange(st.shape[0]) % 2 == 0
    rad_h, st_h, q_h = tfused.trace_fused(sc, pinfo, _soa(o), _soa(d), half,
                                          st, max_bounces=BOUNCES)
    assert torch.equal(st_h[~half], st[~half])
    assert float(torch.stack(list(rad_h), -1)[~half].abs().max()) == 0.0
    assert torch.equal(st_h[half], out_t[1][half])
    assert 0 < int(q_h) < int(out_t[2])


@pytest.mark.parametrize("check", ["lanes", "phases", "cycles"])
def test_block_check_instantiations_measure_the_card(check):
    """trace_block(check=...): the block kernel's check-only
    instantiations (lanes of a bounce step, cycles by part of a scene
    query) measure the card, so CPU tensors are refused, as is a name that
    is none of them; without `check` the same call runs the plain
    version."""
    sc, info = tscenes.BUILDERS[6]().build(device="cpu")
    o = (torch.zeros(4), torch.zeros(4), torch.zeros(4))
    d = (torch.zeros(4), torch.zeros(4), torch.ones(4))
    state = trng.seed(torch.arange(4), 3)
    alive = torch.ones(4, dtype=torch.bool)
    match = "card" if check in tfused.CHECKS else "check must be one of"
    with pytest.raises(ValueError, match=match):
        tfused.trace_block(sc, info, o, d, alive, state, max_bounces=2,
                           check=check)
    before = tfused.trace_block.launches
    rad, st, q = tfused.trace_block(sc, info, o, d, alive, state,
                                    max_bounces=2)
    assert tfused.trace_block.launches == before and int(q) >= 4
    assert tfused.PHASES[-1] == "warp" and len(tfused.PHASES) == \
        tfused.CHECKS["phases"][1]


def test_whitted_with_thickness_probe_matches_jax(pair):
    """Whitted mode on a mesh with a subsurface material: the thickness
    probe through the whole forest, as the JAX package's packet path."""
    dev, info, sc, pinfo = pair(subsurface=True)
    assert pinfo.mat_gates[0]
    img_j, rays_j = _jax_frame(dev, info, raytracing=False)
    img_t, rays_t = render_frame(sc, pinfo, _port_cfg(raytracing=False), CAM,
                                 ROT, SEED, device="cpu")
    a, b = np.asarray(img_j), img_t.numpy()
    _assert_frames(a, b, rays_j, int(rays_t))
    # the probe changed the picture: the box is shaded by its thickness
    plain, _ = render_frame(*pair()[2:], _port_cfg(raytracing=False), CAM,
                            ROT, SEED, device="cpu")
    assert np.abs(plain.numpy() - b).max() > 0.05


@pytest.mark.parametrize("n", [2, 6])
def test_route_matches_frame_path(n):
    """The port's two routes on a small scene: the forest kernels' dividing
    triangle test against the frame path's division-free one."""
    sc, info = scenes.BUILDERS[n]().build(device="cpu")
    cam, rot = scenes.CAMERAS[n]
    kw = dict(width=48, height=36, samples_per_frame=4, max_bounces=4)
    a, ra = render_frame(sc, info, RenderConfig(**kw), cam, rot, 9,
                         device="cpu")
    b, rb = render_frame(sc, info, RenderConfig(fused="off", **kw), cam, rot,
                         9, device="cpu")
    assert img_util.rmse(a.numpy(), b.numpy()) < 0.05
    assert abs(int(ra) - int(rb)) <= 0.01 * int(ra) + 16


def test_render_rays_goes_to_the_block_path():
    """`render_rays` with fused="on" sends each sample's rays to
    `trace_fused`; with the plain versions on the CPU that equals the
    frame path bit for bit, and stays within budget of fused="off"."""
    sc, info = scenes.BUILDERS[6]().build(device="cpu")
    cam, rot = (torch.tensor(v, dtype=torch.float32)
                for v in scenes.CAMERAS[6])
    cfg = dict(width=40, height=30, samples_per_frame=3, max_bounces=4,
               auto_focus=False, focal_distance=4.0)
    uv, index = tcamera.pixel_centers(40, 30, "cpu")
    ifd = torch.tensor(4.0)
    on, q_on = render_rays(sc, info, uv, index, cam, rot, 17, ifd,
                           config=RenderConfig(fused="on", **cfg))
    off, q_off = render_rays(sc, info, uv, index, cam, rot, 17, ifd,
                             config=RenderConfig(fused="off", **cfg))
    frame, q_f = render_frame(sc, info, RenderConfig(**cfg), cam, rot, 17,
                              device="cpu")
    torch.testing.assert_close(on, frame.reshape(-1, 3), rtol=0, atol=1e-6)
    assert int(q_on) == int(q_f)
    assert img_util.rmse(on.numpy(), off.numpy()) < 0.05
    assert abs(int(q_on) - int(q_off)) <= 0.01 * int(q_on) + 16


def test_render_rays_on_a_shard_of_the_image(pair):
    """A subset of the pixels renders as it does inside the whole frame."""
    dev, info, sc, pinfo = pair()
    cfg = _port_cfg()
    cam, rot = (torch.tensor(v, dtype=torch.float32) for v in (CAM, ROT))
    uv, index = tcamera.pixel_centers(W, H, "cpu")
    ifd = torch.tensor(6.0)
    whole, _ = render_rays(sc, pinfo, uv, index, cam, rot, SEED, ifd,
                           config=cfg)
    part, _ = render_rays(sc, pinfo, uv[100:300], index[100:300], cam, rot,
                          SEED, ifd, config=cfg)
    torch.testing.assert_close(part, whole[100:300], rtol=0, atol=0)


def _terrain(n):
    xs = np.linspace(-3.0, 3.0, n)
    X, Z = np.meshgrid(xs, xs)
    Y = np.sin(X * 1.3) * np.cos(Z * 1.1) * 0.4
    P = np.stack([X, Y, Z + 6.0], axis=-1)
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]
    v1 = np.concatenate([a.reshape(-1, 3), d.reshape(-1, 3)])
    v2 = np.concatenate([b.reshape(-1, 3), b.reshape(-1, 3)])
    v3 = np.concatenate([c.reshape(-1, 3), c.reshape(-1, 3)])
    return v1, v2, v3


def test_mesh_past_the_frame_path_renders_through_the_forest():
    """More than MAX_TRIS triangles: built, walked by the stack-walk plain
    version and rendered through `Renderer`, in both modes."""
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("terrain")
    sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_mesh(*_terrain(34), 0)
    scene, info = sc.build(device="cpu",
                           config=RenderConfig(max_tris_in_leaf=4))
    assert info.num_tris == 2 * 33 * 33 > MAX_TRIS
    assert not tfused.eligible(info) and not twavefront.use_brute(info)
    for raytracing in (True, False):
        cfg = RenderConfig(width=16, height=12, samples_per_frame=1,
                           max_bounces=2, raytracing=raytracing)
        r = Renderer(scene, info, cfg, cam_pos=(0.0, 2.0, 0.0),
                     cam_rot=(0.3, 0.0, 0.0), device="cpu")
        img = r.render(1)
        assert bool(torch.isfinite(img).all())
        # the terrain covers part of the picture, the sky the rest
        sky = torch.tensor([0.5, 0.6, 0.9])
        covered = float(((img - sky).abs().amax(-1) > 0.05).float().mean())
        assert 0.03 < covered < 0.9
        assert r.rays_traced >= 16 * 12
    assert float(r._ifd) != cfg.focal_distance   # autofocus hit the mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sc.build()
        with pytest.raises(RuntimeError, match="CUDA"):
            Renderer(scene, info, cfg)


def test_routing_options():
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("a")
    v1, v2, v3 = _terrain(8)
    sc.add_mesh(v1, v2, v3, 0)
    cam = torch.zeros(3)
    # a streamed scene renders through the per-bounce route alone
    scene, info = sc.build(device="cpu",
                           config=RenderConfig(stream_threshold=50))
    assert info.streamed and not tfused.eligible(info)
    with pytest.raises(ValueError, match="streamed"):
        render_frame(scene, info, RenderConfig(width=4, height=4, fused="on"),
                     cam, cam, 1, device="cpu")
    scene, info = sc.build(device="cpu")
    for bad in (dict(fused="interpret"), dict(pallas="interpret")):
        with pytest.raises(ValueError, match="interpret"):
            render_frame(scene, info, RenderConfig(width=4, height=4, **bad),
                         cam, cam, 1, device="cpu")
    # fused="on" on a scene the block kernel does not take: warns, then
    # goes the per-bounce route
    info_big = info._replace(num_materials=40)
    o = tuple(torch.zeros(4) for _ in range(3))
    d = (torch.zeros(4), torch.zeros(4), torch.ones(4))
    state = trng.seed(torch.arange(4), 1)
    alive = torch.ones(4, dtype=torch.bool)
    with pytest.warns(UserWarning, match="per-bounce"):
        on = tintegrator.trace(scene, info_big, o, d, alive, state,
                               max_bounces=2, fused="on")
    off = tintegrator.trace(scene, info_big, o, d, alive, state,
                            max_bounces=2, fused="off")
    for x, y in zip(on[0], off[0]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tfused.trace_fused(scene, info_big, o, d, alive, state, max_bounces=2)
    assert tmath.rotation_matrix(cam).shape == (3, 3)


def test_plain_forest_route_is_no_renderer_option_on_the_card():
    """pallas="off" (the plain versions of the forest kernels) renders on
    the CPU only: the renderer's check refuses it for any other device,
    so no setting takes a mesh on the card past the kernels."""
    from pathtracer0_tpu_torch.render import renderer as trenderer

    off = RenderConfig(width=4, height=4, pallas="off")
    trenderer._check(off, torch.device("cpu"))
    trenderer._check(RenderConfig(width=4, height=4), torch.device("cuda"))
    with pytest.raises(ValueError, match="pallas='off'"):
        trenderer._check(off, torch.device("cuda"))
