"""Card-only tests of the port: each CUDA kernel (frame in both schedules,
block, brute, traverse, streamed with the route's ray sort, the five of
the group-test diagnostic,
the small-K product probe) against its plain PyTorch version, the
diagnostic and the probe end to end, the renderer's routes through the
kernels, the port's spans and tools/profile's busy share in the card's
trace, and the native LBVH builder built there.

They skip without a CUDA card. This file imports neither jax nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene, scenes
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import frame as tframe

W, H, SPP, SEED, IFD, BLUR = 64, 48, 2, 777, 3.0, 0.001


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_kernel_matches_plain_on_card(n):
    """Tolerances of tests/test_fused.py: knife-edge pixels may diverge."""
    _card()
    sc, info = scenes.BUILDERS[n]().build(device="cuda")
    cam, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in scenes.CAMERAS[n])
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    kw = dict(width=W, height=H, spp=SPP, max_bounces=6, blur=BLUR,
              whitted=n == 1)
    ifd = torch.tensor(IFD, device="cuda")
    before = tframe.trace_frame.launches
    rk, sk, qk = tframe.trace_frame(sc, info, cam, rot, ifd, state, **kw)
    assert tframe.trace_frame.launches == before + 1
    rp, sp, qp = tframe.trace_frame_reference(sc, info, cam, rot, ifd,
                                              state, **kw)
    diff = (rk - rp).abs().max(dim=-1).values
    assert bool(torch.isfinite(rk).all())
    assert float((sk == sp).float().mean()) >= 0.99
    assert float((diff < 1e-4).float().mean()) >= 0.99
    assert float((rk - rp).abs().mean()) < 5e-3
    assert abs(int(qk) - int(qp)) <= 0.01 * int(qp) + 16


@pytest.mark.cuda
def test_renderer_goes_through_the_kernel():
    _card()
    sc, info = scenes.BUILDERS[6]().build()
    cam, rot = scenes.CAMERAS[6]
    r = Renderer(sc, info, RenderConfig(width=W, height=H,
                                        samples_per_frame=2),
                 cam_pos=cam, cam_rot=rot)
    before = tframe.trace_frame.launches
    img = r.render(3)
    assert tframe.trace_frame.launches == before + 3
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert r.rays_traced >= W * H * 2 * 3


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _card()
    sc, info = scenes.BUILDERS[2]().build()
    cam = torch.zeros(3, device="cuda")
    state = trng.seed(torch.arange(W * H, device="cuda"), 1)
    with pytest.raises(ValueError):
        tframe.trace_frame(sc, info, cam, cam, torch.tensor(1.0, device="cuda"),
                           state, width=W, height=H, spp=1, max_bounces=2,
                           stack_size=64)
    with pytest.raises(ValueError):
        tframe.trace_frame(sc, info, cam, cam, torch.tensor(1.0, device="cuda"),
                           state[:-1], width=W, height=H, spp=1,
                           max_bounces=2)


# fn id -> (shift, uniform scale) that brings the surface into the view of
# a camera at the origin looking down +z, thicker along the rays than the
# marcher's coarse step (100/256)
IMPLICIT_VIEWS = {
    1: ((0.0, 0.0, 3.0), 0.4), 2: ((0.0, 0.0, 6.0), 0.1),
    3: ((0.0, 0.0, 3.0), 1.0), 4: ((0.0, 1.0, 6.0), 0.3),
    5: ((0.0, 0.0, 6.0), 0.5), 6: ((0.0, 0.0, 3.0), 0.5),
    7: ((0.0, -1.25, 3.0), 1.0), 8: ((0.0, -3.0, 6.0), 1.0),
    9: ((0.0, 5.0, 6.0), 1.0), 10: ((0.0, -4.5, 6.0), 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("fn", sorted(IMPLICIT_VIEWS))
def test_every_implicit_on_card(fn):
    """Each of the 10 implicit surfaces, rotated, through the kernel and
    the plain version: Whitted shading Ka + Kd (0.2 + N.y) with Ka red
    marks the hits and Kd green carries the gradient normal.

    The hits (the march's roots) must agree. The shading is held at 1e-2,
    not 1e-4: the normal is a float32 forward difference with h = 1e-4,
    so one ulp of f at |f| ~ 10 (a libm ulp of sin or pow between the
    card and PyTorch) is ~1e-2 of a gradient component. Kernel and plain
    version on an H100 differed by at most 5.4e-3 (fn 2) on hit pixels;
    the plain version on the card and on the CPU differ as often."""
    _card()
    shift, s = IMPLICIT_VIEWS[fn]
    sc = Scene()
    sc.set_constant_sky((0.2, 0.3, 0.9))
    sc.add_material("probe")
    sc.set_last_mtl("Ka", (1.0, 0.0, 0.0))
    sc.set_last_mtl("Kd", (0.0, 0.5, 0.0))
    sc.add_implicit(fn, shift, (s, s, s), (0.1, 0.2, 0.0), 0)
    scene, info = sc.build()
    zero = torch.zeros(3, device="cuda")
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    kw = dict(width=W, height=H, spp=1, max_bounces=6, whitted=True)
    ifd = torch.tensor(IFD, device="cuda")
    rk, _, _ = tframe.trace_frame(scene, info, zero, zero, ifd, state, **kw)
    rp, _, _ = tframe.trace_frame_reference(scene, info, zero, zero, ifd,
                                            state, **kw)
    hits_k, hits_p = rk[:, 0] == 1.0, rp[:, 0] == 1.0
    assert float(hits_p.float().mean()) > 0.01, "surface not in view"
    assert float((hits_k != hits_p).float().mean()) <= 0.01
    diff = (rk - rp).abs().max(dim=-1).values
    assert bool((diff[~hits_k & ~hits_p] < 1e-4).all())
    assert float((diff[hits_k & hits_p] < 1e-2).float().mean()) >= 0.99
    assert float((rk - rp).abs().mean()) < 5e-3


# ---- the per-bounce route: forest kernels and the block kernel ------------

def _terrain_scene(n, max_leaf, stream_threshold=1 << 16):
    """A height-field mesh of 2 (n - 1)^2 triangles under a sphere."""
    import numpy as np

    xs = np.linspace(-6.0, 6.0, n)
    X, Z = np.meshgrid(xs, xs)
    Y = np.sin(X * 1.3) * np.cos(Z * 1.1) * 0.6
    P = np.stack([X, Y, Z + 8.0], axis=-1)
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]
    v1 = np.concatenate([a.reshape(-1, 3), d.reshape(-1, 3)])
    v2 = np.concatenate([b.reshape(-1, 3), b.reshape(-1, 3)])
    v3 = np.concatenate([c.reshape(-1, 3), c.reshape(-1, 3)])
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("terrain")
    sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_material("glass")
    sc.set_last_mtl("Tr", 0.92)
    sc.set_last_mtl("Ni", 1.5)
    sc.set_last_mtl("illum", 7)
    sc.add_mesh(v1, v2, v3, 0)
    sc.add_sphere((0.0, 1.6, 6.0), 0.8, m=1)
    return sc.build(config=RenderConfig(max_tris_in_leaf=max_leaf,
                                        stream_threshold=stream_threshold))


def _forest_rays(n):
    g = torch.Generator().manual_seed(5)
    o = torch.randn(n, 3, generator=g) * torch.tensor([4.0, 0.5, 2.0]) \
        + torch.tensor([0.0, 2.5, 1.0])
    d = torch.randn(n, 3, generator=g) * 0.5 + torch.tensor([0.0, -0.4, 1.0])
    d = d / d.norm(dim=1, keepdim=True)
    t_init = torch.where(torch.arange(n) % 7 == 0, 0.0, 1e30)
    o, d = (tuple(v[:, i].contiguous().cuda() for i in range(3))
            for v in (o, d))
    return o, d, t_init.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n,kernel", [(9, "brute_kernel"),
                                      (40, "traverse_kernel")])
def test_forest_kernels_match_plain_on_card(n, kernel):
    """t, u, v within 1e-5, the row hit equal on >= 99.9% of the rays,
    switched-off rays exact, the walk's per-ray counters equal."""
    _card()
    from pathtracer0_tpu_torch.kernels import wavefront

    sc, info = _terrain_scene(n, 4)
    assert wavefront.use_brute(info) == (kernel == "brute_kernel")
    o, d, t_init = _forest_rays(8192)
    before = dict(wavefront.launches)
    out_k = wavefront.trace_forest(o, d, t_init, sc, info)
    assert wavefront.launches[kernel] == before[kernel] + 1
    out_p = wavefront.trace_forest_reference(o, d, t_init, sc, info)
    assert wavefront.launches[kernel] == before[kernel] + 1
    same = out_k[3] == out_p[3]
    assert float(same.float().mean()) >= 0.999
    for a, b in zip(out_k[:3], out_p[:3]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out_k[0], out_p[0], rtol=1e-5, atol=1e-5)
    dead = t_init == 0.0
    assert bool((out_k[0][dead] == 0.0).all())
    assert bool((out_k[3][dead] == -1).all())
    assert 0.1 < float((out_k[3] >= 0).float().mean()) < 0.95
    assert float((out_k[4] == out_p[4]).float().mean()) >= 0.999
    assert float((out_k[5] == out_p[5]).float().mean()) >= 0.999
    assert bool((out_k[5][dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("check", [None, "lanes", "phases"])
def test_block_kernel_staged_rows_on_card(check):
    """A 98-triangle mesh, past the block kernel's STAGE_MIN, so each block
    stages its rows in shared memory: the kernel against the plain version,
    and each check-only instantiation's outputs equal the kernel's."""
    _card()
    import numpy as np

    from pathtracer0_tpu_torch.core import math as tmath
    from pathtracer0_tpu_torch.kernels import fused
    from pathtracer0_tpu_torch.render import integrator

    xs = np.linspace(-2, 2, 8)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X) * np.cos(Z) * 0.4, Z + 4], -1)
    a, b, c, d4 = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]
    scn = Scene()
    scn.set_constant_sky((0.5, 0.6, 0.9))
    scn.add_material("m")
    scn.set_last_mtl("Pr", 0.5)
    scn.add_mesh(np.concatenate([a.reshape(-1, 3), d4.reshape(-1, 3)]),
                 np.concatenate([b.reshape(-1, 3)] * 2),
                 np.concatenate([c.reshape(-1, 3)] * 2), 0)
    sc, info = scn.build(config=RenderConfig(max_tris_in_leaf=4))
    assert info.num_tris == 98 and fused.eligible(info)
    assert info.num_tris >= fused.STAGE_MIN
    cam, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in ((0.0, 2.0, 0.0), (0.3, 0.0, 0.0)))
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    o, d, state = tframe._raygen(
        cam, tmath.rotation_matrix(rot), torch.tensor(IFD, device="cuda"),
        state, W, H, cam_size=1.5, focal_length=1.0, blur=BLUR)
    alive = torch.arange(W * H, device="cuda") % 5 != 0
    rad_k, st_k, q_k = fused.trace_block(sc, info, o, d, alive, state,
                                         max_bounces=6)
    inc, skyc, st_p, q_p = integrator.trace_plain(
        sc, info, o, d, alive, state, max_bounces=6)
    rk = torch.stack(list(rad_k), -1)
    rp = torch.stack([inc[i] + skyc[i] for i in range(3)], -1)
    assert float((st_k == st_p).float().mean()) >= 0.99
    assert float(((rk - rp).abs().amax(-1) < 1e-4).float().mean()) >= 0.99
    if check is None:
        return
    before = fused.trace_block.launches
    *out, counted = fused.trace_block(sc, info, o, d, alive, state,
                                      max_bounces=6, check=check)
    assert fused.trace_block.launches == before
    assert torch.equal(torch.stack(list(out[0]), -1), rk)
    assert torch.equal(out[1], st_k) and int(out[2]) == int(q_k)
    if check == "lanes":
        assert int(counted[0]) == int(q_k) and int(counted[1]) > 0
    else:
        assert counted["warp"] > 0 and counted["triangles"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 6])
def test_block_kernel_matches_plain_on_card(n):
    """One sample's rays through csrc/block_kernel.cu and through
    integrator.trace_plain, some rays not alive."""
    _card()
    from pathtracer0_tpu_torch.core import math as tmath
    from pathtracer0_tpu_torch.kernels import fused
    from pathtracer0_tpu_torch.render import integrator

    sc, info = scenes.BUILDERS[n]().build()
    cam, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in scenes.CAMERAS[n])
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    o, d, state = tframe._raygen(
        cam, tmath.rotation_matrix(rot), torch.tensor(IFD, device="cuda"),
        state, W, H, cam_size=1.5, focal_length=1.0, blur=BLUR)
    alive = torch.arange(W * H, device="cuda") % 5 != 0
    before = fused.trace_block.launches
    rad_k, st_k, q_k = fused.trace_block(sc, info, o, d, alive, state,
                                         max_bounces=6)
    assert fused.trace_block.launches == before + 1
    inc, skyc, st_p, q_p = integrator.trace_plain(
        sc, info, o, d, alive, state, max_bounces=6)
    rk = torch.stack(list(rad_k), -1)
    rp = torch.stack([inc[i] + skyc[i] for i in range(3)], -1)
    diff = (rk - rp).abs().amax(-1)
    assert bool(torch.isfinite(rk).all())
    assert float((st_k == st_p).float().mean()) >= 0.99
    assert float((diff < 1e-4).float().mean()) >= 0.99
    assert abs(int(q_k) - int(q_p.sum())) <= 0.01 * int(q_p.sum()) + 16
    assert torch.equal(st_k[~alive], state[~alive])
    assert float(rk[~alive].abs().max()) == 0.0


@pytest.mark.cuda
def test_routes_go_through_their_kernels():
    """A mesh past the frame path renders through traverse_kernel; a small
    one with fused="off" through brute_kernel; render_rays with fused="on"
    through block_kernel. The routes agree within the golden budget."""
    _card()
    from pathtracer0_tpu_torch.core import camera
    from pathtracer0_tpu_torch.core import math as tmath
    from pathtracer0_tpu_torch.kernels import fused, wavefront
    from pathtracer0_tpu_torch.render import integrator
    from pathtracer0_tpu_torch.render.renderer import render_rays
    from pathtracer0_tpu_torch.utils import image as img_util

    cam, rot = (0.0, 2.5, 0.0), (0.3, 0.0, 0.0)
    kw = dict(width=W, height=H, samples_per_frame=4, max_bounces=4)
    big, big_info = _terrain_scene(40, 4)
    small, small_info = _terrain_scene(9, 4)
    before = dict(wavefront.launches)
    r = Renderer(big, big_info, RenderConfig(**kw), cam_pos=cam, cam_rot=rot)
    img = r.render(2)
    assert wavefront.launches["traverse_kernel"] > before["traverse_kernel"]
    assert bool(torch.isfinite(img).all())
    # the plain route is no renderer option on the card: hold the kernels'
    # route against it on one sample's rays
    with pytest.raises(ValueError, match="pallas='off'"):
        Renderer(big, big_info, RenderConfig(pallas="off", **kw),
                 cam_pos=cam, cam_rot=rot)
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    o, d, state = tframe._raygen(
        torch.tensor(cam, device="cuda"),
        tmath.rotation_matrix(torch.tensor(rot, device="cuda")),
        torch.tensor(IFD, device="cuda"), state, W, H, cam_size=1.5,
        focal_length=1.0, blur=BLUR)
    alive = torch.ones(W * H, dtype=torch.bool, device="cuda")
    out = {p: trace(big, big_info, o, d, alive, state, max_bounces=4)
           for p, trace in (("auto", integrator.trace_bounces),
                            ("off", integrator.trace_bounces_reference))}
    rad = {p: torch.stack([v[0][i] + v[1][i] for i in range(3)], -1)
           for p, v in out.items()}
    diff = (rad["auto"] - rad["off"]).abs().amax(-1)
    assert float((out["auto"][2] == out["off"][2]).float().mean()) >= 0.99
    assert float((diff < 1e-4).float().mean()) >= 0.99

    frames = {}
    for fused_opt in ("auto", "off"):
        r = Renderer(small, small_info, RenderConfig(fused=fused_opt, **kw),
                     cam_pos=cam, cam_rot=rot, seed=3)
        frames[fused_opt] = r.render(2).cpu().numpy()
    assert wavefront.launches["brute_kernel"] > before["brute_kernel"]
    assert img_util.rmse(frames["auto"], frames["off"]) < 0.05
    uv, index = camera.pixel_centers(W, H, "cuda")
    n0 = fused.trace_block.launches
    col, _ = render_rays(
        small, small_info, uv, index, torch.tensor(cam, device="cuda"),
        torch.tensor(rot, device="cuda"), 11,
        torch.tensor(IFD, device="cuda"),
        config=RenderConfig(fused="on", **kw))
    assert fused.trace_block.launches == n0 + 4
    assert bool(torch.isfinite(col).all())


@pytest.mark.cuda
def test_deep_forest_takes_a_larger_stack_on_card():
    """Triangles shrinking geometrically towards x = 0 give, with one SAH
    plane, a tree some 43 levels deep: traverse_kernel walks it and
    agrees with its plain version and with brute force."""
    _card()
    import numpy as np

    from pathtracer0_tpu_torch.kernels import wavefront

    n = 200
    x = 1e5 * 0.88 ** np.arange(n)
    s, zero = 0.1 * x, np.zeros(n)
    v1 = np.stack([x, zero, zero + 3.0], 1)
    v2 = v1 + np.stack([s, zero, zero], 1)
    v3 = v1 + np.stack([zero, s, zero], 1)
    sc = Scene()
    sc.set_constant_sky((0.3, 0.3, 0.3))
    sc.add_material("m")
    sc.add_mesh(v1, v2, v3, 0)
    scene, info = sc.build(config=RenderConfig(sah_planes=1))
    assert 32 < info.forest_depth + 1 <= wavefront.TRAVERSE_MAX_STACK
    rng = np.random.RandomState(4)
    k = rng.randint(0, n, 4096)
    o = v1[k] + np.stack([s[k] * rng.rand(4096) * 1.2,
                          s[k] * rng.rand(4096) * 1.2, -s[k] * 3], 1)
    o = tuple(torch.tensor(o[:, i], dtype=torch.float32, device="cuda")
              for i in range(3))
    zeros = torch.zeros(4096, device="cuda")
    d = (zeros, zeros, zeros + 1.0)
    t_init = torch.full((4096,), 1e30, device="cuda")
    out_k = wavefront.trace_forest(o, d, t_init, scene, info)
    out_p = wavefront.traverse_reference(o, d, t_init, scene, info)
    out_b = wavefront.brute_reference(o, d, t_init, scene, info)
    for a, b, c in zip(out_k[:4], out_p[:4], out_b[:4]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(out_k[4], out_p[4]) and torch.equal(out_k[5], out_p[5])
    assert 0.2 < float((out_k[3] >= 0).float().mean()) < 0.9
    assert int(out_k[3].unique().numel()) > 80



@pytest.mark.cuda
@pytest.mark.parametrize("n,leaf", [(40, 4), (40, 1), (24, 2)])
def test_traverse_kernel_equals_the_plain_walk_on_card(n, leaf):
    """traverse_kernel, which walks nodes_w, against traverse_reference,
    which walks nodes_f and nodes_i: t, u, v, the row and both counters
    equal on every ray, switched-off rays included."""
    _card()
    from pathtracer0_tpu_torch.kernels import wavefront

    sc, info = _terrain_scene(n, leaf)
    assert not wavefront.use_brute(info)
    o, d, t_init = _forest_rays(8192)
    out_k = wavefront.trace_forest(o, d, t_init, sc, info)
    out_p = wavefront.traverse_reference(o, d, t_init, sc, info)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    assert 0.1 < float((out_k[3] >= 0).float().mean()) < 0.95


@pytest.mark.cuda
def test_walk_object_equals_the_plain_walk_per_root_on_card():
    """The heatmap's walks: walk_object of each root of a forest of a
    terrain, a second mesh and a one-triangle object (a root that is a
    leaf) equals traverse_reference of that object alone in all six
    outputs."""
    _card()
    import numpy as np

    from pathtracer0_tpu_torch.kernels import wavefront

    xs = np.linspace(-6.0, 6.0, 30)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X) * np.cos(Z) * 0.5, Z + 8.0], axis=-1)
    a, b, c, d_ = P[:-1, :-1], P[1:, :-1], P[:-1, 1:], P[1:, 1:]
    v1 = np.concatenate([a.reshape(-1, 3), d_.reshape(-1, 3)])
    v2 = np.concatenate([b.reshape(-1, 3)] * 2)
    v3 = np.concatenate([c.reshape(-1, 3)] * 2)
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    sc.add_tri((-1.0, 1.5, 6.0), (1.0, 1.5, 6.0), (0.0, 2.5, 6.0), 0)
    sc.add_mesh(v1, v2, v3, 0)
    sc.add_mesh(v1 + (0.0, 1.0, 0.0), v2 + (0.0, 1.0, 0.0),
                v3 + (0.0, 1.0, 0.0), 0)
    scene, info = sc.build(config=RenderConfig(max_tris_in_leaf=2))
    assert info.num_objects == 3
    assert int(scene.root_links[0, 0]) < 0   # the triangle's root is a leaf
    o, d, t_init = _forest_rays(8192)
    for k in range(info.num_objects):
        out_k = wavefront.walk_object(o, d, t_init, scene, info, k)
        out_p = wavefront.traverse_reference(o, d, t_init, scene, info,
                                             objects=(k,))
        for x, y in zip(out_k, out_p):
            assert torch.equal(x, y)
        assert int((out_k[5] > 0).sum()) > 0

# ---- the streamed route: the LBVH kernel -----------------------------------

def _assert_streamed(out_k, out_p, t_init):
    same = out_k[3] == out_p[3]
    assert float(same.float().mean()) >= 0.999
    for a, b in zip(out_k[:3], out_p[:3]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
    dead = t_init == 0.0
    for x, off in zip(out_k, (0.0, 0.0, 0.0, -1, 0, 0)):
        assert bool((x[dead] == off).all())
    assert float((out_k[4] == out_p[4]).float().mean()) >= 0.999
    assert float((out_k[5] == out_p[5]).float().mean()) >= 0.999


# 128 triangles: one treelet; 3,042: two; 8,978: 642 rows in 6 treelets of
# a top tree of 8, the last two empty
@pytest.mark.cuda
@pytest.mark.parametrize("n,treelets", [(9, 1), (40, 2), (68, 8)])
def test_streamed_kernel_matches_plain_on_card(n, treelets):
    """idx equal on >= 99.9% of the rays, t, u, v within 1e-5, switched-off
    rays exact, the per-ray counters equal on >= 99.9%."""
    _card()
    from pathtracer0_tpu_torch.kernels import wavefront

    sc, info = _terrain_scene(n, 4, stream_threshold=0)
    assert info.streamed and info.st_n_treelets == treelets
    assert info.num_objects == 0
    o, d, t_init = _forest_rays(8192)
    before = wavefront.launches["streamed_kernel"]
    out_k = wavefront.trace_streamed(o, d, t_init, sc, info)
    torch.cuda.synchronize()
    assert wavefront.launches["streamed_kernel"] == before + 1
    out_p = wavefront.streamed_reference(o, d, t_init, sc, info)
    assert wavefront.launches["streamed_kernel"] == before + 1
    _assert_streamed(out_k, out_p, t_init)
    assert 0.1 < float((out_k[3] >= 0).float().mean()) < 0.95
    # the same triangles as the SAH forest's walk finds
    forest, finfo = _terrain_scene(n, 4)
    out_f = wavefront.trace_forest(o, d, t_init, forest, finfo)
    tri_s = torch.where(out_k[3] >= 0,
                        sc.st_perm[out_k[3].clamp(min=0).long()], -1)
    tri_f = torch.where(out_f[3] >= 0,
                        forest.wf_perm[out_f[3].clamp(min=0).long()], -1)
    assert float((tri_s == tri_f).float().mean()) >= 0.999
    torch.testing.assert_close(out_k[0], out_f[0], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_streamed_kernel_edge_cases_on_card():
    """All lanes off; rays with zero direction components (straight down,
    along an axis) through a top tree with empty treelets; a short t_init."""
    _card()
    from pathtracer0_tpu_torch.kernels import wavefront

    sc, info = _terrain_scene(68, 4, stream_threshold=0)
    o, d, t_init = _forest_rays(2048)
    off = wavefront.trace_streamed(o, d, torch.zeros_like(t_init), sc, info)
    for x, want in zip(off, (0.0, 0.0, 0.0, -1, 0, 0)):
        assert bool((x == want).all())
    zero = torch.zeros(2048, device="cuda")
    one = torch.ones(2048, device="cuda")
    high = tuple(c if i != 1 else c.abs() + 3.0 for i, c in enumerate(o))
    for direction in ((zero, -one, zero), (zero, zero, one),
                      (one * 0.6, -one * 0.8, zero)):
        for ti in (t_init, torch.where(t_init > 0, 2.5, 0.0)):
            out_k = wavefront.trace_streamed(high, direction, ti, sc, info)
            out_p = wavefront.streamed_reference(high, direction, ti, sc,
                                                 info)
            assert bool(torch.isfinite(out_k[0]).all())
            _assert_streamed(out_k, out_p, ti)
    down = wavefront.trace_streamed(high, (zero, -one, zero), t_init, sc, info)
    assert float((down[3] >= 0).float().mean()) > 0.1
    with pytest.raises(ValueError):
        wavefront.trace_streamed(o, d, t_init[:-1], sc, info)
    forest, finfo = _terrain_scene(9, 4)
    with pytest.raises(ValueError, match="streamed"):
        wavefront.trace_streamed(o, d, t_init, forest, finfo)


@pytest.mark.cuda
def test_streamed_route_goes_through_its_kernel():
    """A scene past stream_threshold renders through Renderer in path and
    Whitted mode with one streamed_kernel launch per scene query and no
    other kernel; fused="on" refuses it."""
    _card()
    from pathtracer0_tpu_torch.kernels import fused, wavefront

    cam, rot = (0.0, 2.5, 0.0), (0.3, 0.0, 0.0)
    sc, info = _terrain_scene(40, 4, stream_threshold=1000)
    assert info.streamed
    for raytracing in (True, False):
        cfg = RenderConfig(width=W, height=H, samples_per_frame=3,
                           max_bounces=4, raytracing=raytracing,
                           auto_focus=False)
        before = dict(wavefront.launches)
        others = (tframe.trace_frame.launches, fused.trace_block.launches)
        r = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot)
        img = r.render(2)
        after = dict(wavefront.launches)
        got = after.pop("streamed_kernel") - before.pop("streamed_kernel")
        assert 2 * 3 <= got <= 2 * 3 * (4 if raytracing else 1)
        # W x H >= SORT_MIN_RAYS rays a query: each the sorted query's
        keyed = after.pop("sort_key_kernel") - before.pop("sort_key_kernel")
        assert keyed == got
        assert after == before
        assert others == (tframe.trace_frame.launches,
                          fused.trace_block.launches)
        assert bool(torch.isfinite(img).all()) and float(img.std()) > 0.02
    with pytest.raises(ValueError, match="streamed"):
        Renderer(sc, info, RenderConfig(width=W, height=H, fused="on"),
                 cam_pos=cam, cam_rot=rot).render(1)


def _streamed_terrain_renderer():
    """A streamed scene (2,048 triangles past a stream threshold of 1,000)
    at 32 x 32 = SORT_MIN_RAYS pixels, 2 spp, 3 bounces: the per-bounce
    route with its sorted query, every span of the port in a step."""
    from pathtracer0_tpu_torch.kernels import traverse

    cfg = RenderConfig(width=32, height=32, samples_per_frame=2,
                       max_bounces=3, blur=0.0, auto_focus=False,
                       stream_threshold=1000)
    assert cfg.width * cfg.height >= traverse.SORT_MIN_RAYS
    sc, info = scenes.terrain(33).build(cfg)
    assert info.streamed
    return Renderer(sc, info, cfg, cam_pos=(0.0, 7.0, -1.5),
                    cam_rot=(1.0, 0.0, 0.0))


@pytest.mark.cuda
def test_port_spans_on_the_streamed_route_on_card(tmp_path):
    """utils/trace.span in the card's trace, on a streamed scene of at
    least SORT_MIN_RAYS pixels: the eager route's frame (render_rays, as
    the tiles and the graph's first frame run it) holds spp x bounces
    `pt0.query` and `pt0.bounce` spans; a later step replays the frame's
    CUDA graph in one `pt0.route.replay` and no other span of the port. Both beside the
    device's streamed_kernel and bounce_kernel records, by name."""
    _card()
    import json

    from torch.profiler import ProfilerActivity, profile

    from pathtracer0_tpu_torch.render import renderer

    r = _streamed_terrain_renderer()
    r.step(1)
    torch.cuda.synchronize()

    def traced(fn, name):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        spans = {}
        for e in events:
            if (e.get("cat") == "user_annotation"
                    and e["name"].startswith("pt0.")):
                spans.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"]))
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert any("bounce_kernel" in k for k in kernels), name
        assert any("streamed_kernel" in k for k in kernels), name
        return spans

    spans = traced(lambda: renderer._route_frame(
        r.scene, r.info, r.config, r.device, 2, r.cam_pos, r.cam_rot,
        r._ifd), "eager")
    assert {n: len(v) for n, v in spans.items()} == {
        "pt0.query": 6, "pt0.bounce": 6}
    spans = traced(lambda: r.step(2), "replay")
    assert {n: len(v) for n, v in spans.items()} == {"pt0.route.replay": 1}


@pytest.mark.cuda
def test_trace_busy_share_is_over_the_traced_call_on_card():
    """tools/profile.trace_busy: the busy share is the device time over
    the wall time of the same traced call, so at most 1; the untraced
    call's wall time stays beside it."""
    _card()
    from pathtracer0_tpu_torch.tools import profile

    sc, info = scenes.BUILDERS[6]().build()
    cam, rot = scenes.CAMERAS[6]
    r = Renderer(sc, info, RenderConfig(width=W, height=H,
                                        samples_per_frame=2),
                 cam_pos=cam, cam_rot=rot)
    busy = profile.trace_busy(r.step)
    assert busy["busy_share"] == pytest.approx(
        busy["device_busy_ms"] / busy["wall_ms_traced"])
    assert 0.0 < busy["busy_share"] <= 1.0
    assert busy["wall_ms_untraced"] > 0.0


@pytest.mark.cuda
def test_trace_busy_counts_no_span_as_device_work_on_card(monkeypatch):
    """The port's spans leave ranges on the device's timeline that
    torch.profiler keys as CUDA events with device time; trace_busy counts
    none of them: a step of the streamed route (the replay of its frame's
    graph, whose capture held the other spans) has as many device
    operations and no `pt0.` entry with its spans as with them swapped
    for null contexts."""
    _card()
    import contextlib

    from pathtracer0_tpu_torch.kernels import frame, traverse
    from pathtracer0_tpu_torch.render import graph, integrator
    from pathtracer0_tpu_torch.tools import profile

    r = _streamed_terrain_renderer()
    spanned = profile.trace_busy(lambda: r.step(7))
    for module in (frame, traverse, integrator, graph):
        monkeypatch.setattr(module, "span",
                            lambda name: contextlib.nullcontext())
    plain = profile.trace_busy(lambda: r.step(7))
    assert spanned["device_kernels"] == plain["device_kernels"] > 0
    names = [e["name"] for e in spanned["top"] + spanned["ours"]]
    assert names and not any(n.startswith("pt0.") for n in names)
    assert 0.0 < spanned["busy_share"] <= 1.0


@pytest.mark.cuda
def test_brute_kernel_tiles_and_pairs_on_card():
    """brute_kernel over a table of 1,058 rows (more than one staged tile
    of 256), at odd ray counts (a block's second ray past the end), one
    ray in seven switched off: every output equal to the plain version's,
    switched-off rays exact."""
    _card()
    from pathtracer0_tpu_torch.kernels import wavefront

    sc, info = _terrain_scene(24, 8)
    assert wavefront.use_brute(info) and info.num_tris > 4 * 256
    o, d, t_init = _forest_rays(8192)
    for n in (8191, 8000, 257, 129, 1):
        args = (tuple(c[:n] for c in o), tuple(c[:n] for c in d),
                t_init[:n], sc, info)
        before = wavefront.launches["brute_kernel"]
        out_k = wavefront.trace_forest(*args)
        torch.cuda.synchronize()
        assert wavefront.launches["brute_kernel"] == before + 1
        out_p = wavefront.brute_reference(*args)
        for a, b in zip(out_k, out_p):
            assert torch.equal(a, b), n
        dead = t_init[:n] == 0.0
        assert bool((out_k[3][dead] == -1).all())
        assert bool((out_k[5][dead] == 0).all())
        assert bool((out_k[5][~dead] == info.num_leaves).all())
        if n == 8191:
            assert 0.1 < float((out_k[3] >= 0).float().mean()) < 0.95


@pytest.mark.cuda
def test_streamed_kernel_on_sorted_rays_on_card():
    """streamed_kernel on rays in the route's order (traverse.streamed_order)
    against its plain version, and the sorted query against the rays as
    given: the same bits on every ray."""
    _card()
    from pathtracer0_tpu_torch.kernels import traverse, wavefront

    sc, info = _terrain_scene(68, 4, stream_threshold=0)
    o, d, t_init = _forest_rays(8192)
    order = traverse.streamed_order(o, d, t_init, sc)
    so, sd = (tuple(c[order].contiguous() for c in v) for v in (o, d))
    st = t_init[order].contiguous()
    out_k = wavefront.trace_streamed(so, sd, st, sc, info)
    out_p = wavefront.streamed_reference(so, sd, st, sc, info)
    _assert_streamed(out_k, out_p, st)
    given = wavefront.trace_streamed(o, d, t_init, sc, info)
    sorted_ = traverse.sorted_query(wavefront.trace_streamed, o, d, t_init,
                                    sc, info)
    for a, b in zip(given, sorted_):
        assert torch.equal(a, b)
    # switched-off rays sort to the back
    assert bool((st[-int((t_init == 0.0).sum()):] == 0.0).all())


@pytest.mark.cuda
def test_streamed_query_launches_once_on_card():
    """ray_scene, probe_forest_t and heat_counts of a streamed scene sort
    their >= 1,024 rays and launch streamed_kernel once each; the check-only
    PHASES instantiation gives the same outputs and counts no launch."""
    _card()
    from pathtracer0_tpu_torch.kernels import traverse, wavefront

    sc, info = _terrain_scene(40, 4, stream_threshold=0)
    o, d, t_init = _forest_rays(4096)
    for fn in (traverse.ray_scene, traverse.probe_forest_t,
               traverse.heat_counts):
        before = wavefront.launches["streamed_kernel"]
        fn(o, d, sc, info)
        assert wavefront.launches["streamed_kernel"] == before + 1
    before = wavefront.launches["streamed_kernel"]
    *out, cyc = wavefront.streamed_phase_cycles(o, d, t_init, sc, info)
    assert wavefront.launches["streamed_kernel"] == before
    for a, b in zip(out, wavefront.trace_streamed(o, d, t_init, sc, info)):
        assert torch.equal(a, b)
    assert cyc["warp"] > cyc["group"] > 0 and cyc["group_tests"] > 0
    assert cyc["group_lanes"] >= cyc["group_distinct"] >= cyc["group_tests"]


@pytest.mark.cuda
def test_streamed_row_cull_on_card():
    """The row cull inside a group: the plain and the ORDERED form of
    streamed_kernel against the plain twin on a small terrain, and the
    check-only PHASES sums: 4 row boxes a group entered, at most 4 rows
    tested a group and fewer on average, as many as the twin tests."""
    _card()
    from pathtracer0_tpu_torch.kernels import traverse, wavefront

    sc, info = _terrain_scene(68, 4, stream_threshold=0)
    o, d, t_init = _forest_rays(8192)
    tested = torch.zeros(8192, dtype=torch.int32, device="cuda")
    out_p = wavefront.streamed_reference(o, d, t_init, sc, info,
                                         rows_tested=tested)
    _assert_streamed(wavefront.trace_streamed(o, d, t_init, sc, info),
                     out_p, t_init)
    active = t_init > 0.0
    on, out_o = wavefront.trace_sorted(o, d, active, sc, info)
    want = traverse.sorted_query(wavefront.streamed_reference, on, d,
                                 t_init, sc, info)
    _assert_streamed(out_o, want, t_init)
    *out, cyc = wavefront.streamed_phase_cycles(o, d, t_init, sc, info)
    groups = int(out[5].sum()) // 4
    assert groups > 0 and cyc["row_boxes"] == 4 * groups
    assert 0 < cyc["rows_tested"] < 4 * groups
    assert abs(cyc["rows_tested"] - int(tested.sum())) <= 0.001 * groups


def _root_rays(sc, n, seed=9):
    """n rays about the streamed scene's root box: from above it, mostly
    downwards; one in eleven upwards and one in thirteen from beside the
    box pointing away (both miss the root), a few with zero direction
    components; and the active mask, one ray in six switched off."""
    g = torch.Generator().manual_seed(seed)
    top = sc.st_top[0].cpu()
    lo, hi = top[0:3], top[3:6]
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g) \
        + torch.tensor([0.0, 1.0, 0.0]) * (hi - lo)[1] * 0.5
    d = torch.randn(n, 3, generator=g) * 0.6 + torch.tensor([0.0, -1.0, 0.0])
    d[::11, 1] = d[::11, 1].abs()
    o[3::13, 0] = hi[0] + 1.0
    d[3::13, 0] = d[3::13, 0].abs()
    d[5::17, 0] = 0.0
    d[7::19, 2] = 0.0
    d = d / d.norm(dim=1, keepdim=True)
    o, d = (tuple(v[:, i].contiguous().cuda() for i in range(3))
            for v in (o, d))
    return o, d, (torch.arange(n) % 6 != 0).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["terrain_8k", "terrain_1m"])
def test_sorted_query_matches_the_rays_as_given_on_card(scene):
    """wavefront.trace_sorted (sort_key_kernel, the argsort, the ordered
    streamed_kernel) against streamed_kernel on the nudged rays as given
    and against the PyTorch sort (`sorted_query`): all six outputs bit for
    bit, the nudged origins `nudged`'s, the keys `streamed_keys`'; with
    switched-off rays and rays that miss the root; on an 8,978-triangle
    terrain at 8,192 rays and on the 1M terrain at 480,000."""
    _card()
    from pathtracer0_tpu_torch.kernels import traverse, wavefront

    if scene == "terrain_8k":
        sc, info = _terrain_scene(68, 4, stream_threshold=0)
        n = 8192
    else:
        sc, info = scenes.terrain(708).build()
        n = 480_000
    assert info.streamed
    o, d, active = _root_rays(sc, n)
    before = dict(wavefront.launches)
    on, out = wavefront.trace_sorted(o, d, active, sc, info)
    torch.cuda.synchronize()
    assert wavefront.launches["sort_key_kernel"] == \
        before["sort_key_kernel"] + 1
    assert wavefront.launches["streamed_kernel"] == \
        before["streamed_kernel"] + 1
    want_on = traverse.nudged(o, d)
    for a, b in zip(on, want_on):
        assert torch.equal(a, b)
    t_init = traverse._t_init(want_on[0], active)
    given = wavefront.trace_streamed(want_on, d, t_init, sc, info)
    sorted_ = traverse.sorted_query(wavefront.trace_streamed, want_on, d,
                                    t_init, sc, info)
    for a, b, c in zip(out, given, sorted_):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    dead = ~active
    for x, off in zip(out, (0.0, 0.0, 0.0, -1, 0, 0)):
        assert bool((x[dead] == off).all())
    keys = traverse.streamed_keys(want_on, d, t_init, sc.st_top[0, 0:6])
    missed = float((keys == 2 ** 30).float().mean())
    assert 0.05 < missed < 0.5
    assert bool((keys[dead] == 2 ** 30 + 1).all())
    assert 0.05 < float((out[3] >= 0).float().mean()) < 0.95
    # the kernel's keys are the plain twin's (the sort's coherence), its
    # nudged origins `nudged`'s
    key_on, key = wavefront.sort_keys(o, d, active, sc, info)
    assert torch.equal(key, keys)
    for a, b in zip(key_on, want_on):
        assert torch.equal(a, b)
    # no mask: every ray on
    on_all, out_all = wavefront.trace_sorted(o, d, None, sc, info)
    full = wavefront.trace_streamed(want_on, d, torch.full_like(t_init, 1e30),
                                    sc, info)
    for a, b in zip(out_all, full):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sorted_query_takes_the_route_on_card():
    """walk_triangles' nudged origins are `nudged`'s; heat_counts' counters
    the as-given kernel's on the nudged rays (no ray nudged twice), also
    from one origin expanded over every ray;
    sort_key_kernel and streamed_kernel count one launch each for each of
    ray_scene, probe_forest_t and heat_counts, at 4,096 rays and under
    SORT_MIN_RAYS rays alike."""
    _card()
    from pathtracer0_tpu_torch.kernels import traverse, wavefront

    sc, info = _terrain_scene(40, 4, stream_threshold=0)
    o, d, active = _root_rays(sc, 4096)
    on = traverse.nudged(o, d)
    walk, got_on = traverse.walk_triangles(o, d, sc, info, active=active)
    for a, b in zip(got_on, on):
        assert torch.equal(a, b)
    given = wavefront.trace_streamed(on, d, traverse._t_init(on[0], active),
                                     sc, info)
    assert torch.equal(walk.t, given[0]) and torch.equal(walk.row, given[3])
    # under SORT_MIN_RAYS rays the card sorts too: the walk is per ray
    walk_f, _ = traverse.walk_triangles(
        tuple(c[:1000] for c in o), tuple(c[:1000] for c in d), sc, info,
        active=active[:1000])
    assert torch.equal(walk_f.t, given[0][:1000])
    assert torch.equal(walk_f.row, given[3][:1000])
    box, rows = traverse.heat_counts(o, d, sc, info)
    full = wavefront.trace_streamed(on, d, torch.full_like(on[0], 1e30), sc,
                                    info)
    assert torch.equal(box, full[4]) and torch.equal(rows, full[5])
    # one origin for every ray, expanded (stride 0) as a camera's: the
    # kernels read contiguous copies while the argsort allocates
    eye = tuple(c[:1].expand(4096) for c in o)
    walk_e, on_e = traverse.walk_triangles(eye, d, sc, info)
    want_e = traverse.nudged(tuple(c.contiguous() for c in eye), d)
    given_e = wavefront.trace_streamed(want_e, d,
                                       torch.full_like(on[0], 1e30), sc, info)
    for a, b in zip(on_e, want_e):
        assert torch.equal(a, b)
    assert torch.equal(walk_e.t, given_e[0])
    assert torch.equal(walk_e.row, given_e[3])
    box_e, rows_e = traverse.heat_counts(eye, d, sc, info)
    assert torch.equal(box_e, given_e[4]) and torch.equal(rows_e, given_e[5])
    for fn in (traverse.ray_scene, traverse.probe_forest_t,
               traverse.heat_counts):
        for n in (4096, 1000):
            before = dict(wavefront.launches)
            fn(tuple(c[:n] for c in o), tuple(c[:n] for c in d), sc, info)
            assert wavefront.launches["sort_key_kernel"] == \
                before["sort_key_kernel"] + 1, (fn, n)
            assert wavefront.launches["streamed_kernel"] == \
                before["streamed_kernel"] + 1, (fn, n)


@pytest.mark.cuda
def test_streamed_loop_bounce_device_operations_on_card():
    """A bounce of the per-bounce route's loop on a streamed scene (4,096
    rays) takes at most 25 device operations in a tools/profile.trace_busy
    trace: the key, the sort, the walk, the bounce kernel."""
    _card()
    from pathtracer0_tpu_torch.core import math as vm
    from pathtracer0_tpu_torch.kernels import frame
    from pathtracer0_tpu_torch.render import integrator
    from pathtracer0_tpu_torch.tools import profile

    sc, info = scenes.terrain(33).build(RenderConfig(stream_threshold=1000))
    assert info.streamed
    w, h = 64, 64
    state = trng.seed(torch.arange(w * h, device="cuda"), 4321)
    o, d, state = frame._raygen(
        torch.tensor([0.0, 7.0, -1.5], device="cuda"),
        vm.rotation_matrix(torch.tensor([1.0, 0.0, 0.0], device="cuda")),
        torch.tensor(20.0, device="cuda"), state, w, h, cam_size=1.5,
        focal_length=1.0, blur=0.0)
    o, d = [c.contiguous() for c in o], [c.contiguous() for c in d]
    alive = torch.ones(w * h, dtype=torch.bool, device="cuda")
    ops = {nb: profile.trace_busy(lambda nb=nb: integrator.trace_bounces(
        sc, info, o, d, alive, state, max_bounces=nb))["device_kernels"]
           for nb in (1, 3)}
    per_bounce = (ops[3] - ops[1]) / 2
    assert 0 < per_bounce <= 25, ops


@pytest.mark.cuda
def test_native_lbvh_builder_builds_beside_the_card():
    """g++ builds csrc/streambuild.cpp on the machine that holds the card;
    its Morton order is bit-equal to the NumPy builder's, and the default
    median-split order holds the same triangles."""
    _card()
    import numpy as np

    from pathtracer0_tpu_torch.accel import lbvh, native_lbvh

    assert native_lbvh.available()
    rng = np.random.RandomState(2)
    v1 = rng.rand(6000, 3) * 30.0
    v2, v3 = v1 + rng.randn(6000, 3) * 0.4, v1 + rng.randn(6000, 3) * 0.4
    nat = native_lbvh.build_streamed(v1, v2, v3, mode=0)
    ref = lbvh._build_streamed_numpy(v1, v2, v3)
    for a, b in zip(nat[:4], ref[:4]):
        assert np.array_equal(a, b)
    med = lbvh.build_streamed(v1, v2, v3)
    assert sorted(med.row_perm[:6000]) == list(range(6000))
    assert np.array_equal(med.ctree_f[0], ref.ctree_f[0])


def _group_inputs(n_groups, n_rays, aimed=False):
    """The diagnostic's synthetic data on the card, cut to `n_rays` rays:
    (tris, o, d, coef, feats, t_init). `aimed` turns the rays at the
    triangles, so that about half of them hit instead of one in twenty."""
    from pathtracer0_tpu_torch.kernels import mxu_tri
    from pathtracer0_tpu_torch.tools import diag_mxu

    data = diag_mxu.synthetic(n_groups, -(-n_rays // 1024))
    if aimed:
        data = diag_mxu.aim(data)[0]
    o, d = (tuple(c[:n_rays].contiguous() for c in data[k])
            for k in ("o", "d"))
    return (data["tris"], o, d,
            mxu_tri.coef_table(data["tris"], data["center"]),
            mxu_tri.ray_features(o, d, data["center"]),
            torch.full((n_rays,), 1e30, device="cuda"))


def _hits_idx_eq(out_k, out_p):
    """The share with idx equal of the rays that hit in either output: few
    rays hit, so a share of all rays would pass a kernel that loses hits."""
    either = (out_k[3] >= 0) | (out_p[3] >= 0)
    same = out_k[3] == out_p[3]
    return float((same & either).sum()) / max(int(either.sum()), 1)


def _assert_forms(out_k, out_p):
    """Product forms, kernel against plain version or B against C: idx
    equal on >= 99.5% of the rays that hit in either, t within 1e-4 x (1 +
    t) where idx agrees (only the order of the float32 sums differs),
    misses exact."""
    same = out_k[3] == out_p[3]
    hit = same & (out_p[3] >= 0)
    assert _hits_idx_eq(out_k, out_p) >= 0.995
    assert bool(((out_k[0] - out_p[0]).abs()[hit]
                 <= 1e-4 * (1.0 + out_p[0][hit])).all())
    assert bool((out_k[0] == out_p[0])[same & ~hit].all())
    assert bool(torch.isfinite(out_k[0]).all())


# 1,000 rays are no multiple of a warp's 16, of mxu_kernel's 128-ray block
# or of mxu_big_kernel's
@pytest.mark.cuda
@pytest.mark.parametrize("n_rays, aimed", [(16384, False), (1000, False),
                                           (16384, True), (1000, True)])
def test_group_kernels_match_plain_on_card(n_rays, aimed):
    """Each of vpu_kernel, mxu_kernel, mxu_big_kernel (with mm_only) and
    mxu_split3_kernel against its plain version at 4 groups, on the tool's
    rays and on rays aimed at the triangles: the scalar test to the
    streamed parity limits (idx equal on >= 99.9% of the rays that hit, t,
    u, v within 1e-5), the product forms to `_assert_forms`, B against C
    the same, mm_only within 1e-5 of the sum of magnitudes."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    tris, o, d, coef, feats, t_init = _group_inputs(4, n_rays, aimed)
    kw = dict(n_groups=4, reps=1)
    before = dict(mxu_group.launches)
    a_k = mxu_group.run_vpu(tris, o, d, t_init, **kw)
    a_p = mxu_group.vpu_reference(tris, o, d, t_init, **kw)
    same = a_k[3] == a_p[3]
    assert _hits_idx_eq(a_k, a_p) >= 0.999
    for x, y in zip(a_k[:3], a_p[:3]):
        assert float((x - y).abs()[same].max()) <= 1e-5
    assert float((a_k[3] >= 0).float().mean()) > (0.4 if aimed else 0.002)
    zero = torch.zeros_like(t_init)
    for precision in mxu_group.PRECISIONS:
        pkw = dict(precision=precision, **kw)
        plain = mxu_group.mxu_reference(coef, feats, t_init, **pkw)
        b = mxu_group.run_mxu(coef, feats, t_init, **pkw)
        c = mxu_group.run_mxu_big(coef, feats, t_init, **pkw)
        _assert_forms(b, plain)
        _assert_forms(c, plain)
        _assert_forms(b, c)
        m_k = mxu_group.run_mxu_big(coef, feats, zero, mm_only=True, **pkw)
        m_p = mxu_group.mm_only_reference(coef, feats, zero, **pkw)
        mag = sum(coef[g, 0].abs() @ feats.abs() for g in range(4))
        assert bool(((m_k[0] - m_p[0]).abs() <= 1e-5 * mag).all())
        assert bool((m_k[3] == -1).all())
    _assert_forms(mxu_group.run_mxu_split3(coef, feats, t_init, **kw),
                  mxu_group.split3_reference(coef, feats, t_init, **kw))
    torch.cuda.synchronize()
    got = {k: mxu_group.launches[k] - before[k] for k in before}
    assert got == {"vpu_kernel": 1, "mxu_kernel": 2, "mxu_big_kernel": 4,
                   "mxu_split3_kernel": 1, "prefilter_kernel": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, form", [
    ("mxu_kernel", "highest"), ("mxu_kernel", "default"),
    ("mxu_big_kernel", "highest"), ("mxu_big_kernel", "default"),
    ("mxu_big_kernel", "split3")])
def test_group_products_on_card(kernel, form):
    """The kernels' products themselves (mxu_split3_kernel's for "split3")
    against the float32 product of the same (rounded or split) operands:
    within 2^-20 of the sum of magnitudes, float32 accuracy. For "highest"
    that holds the three-pass TF32 split; for the bf16 forms every product
    is exact in float32 and only the order of the sums differs."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    _, _, _, coef, feats, _ = _group_inputs(4, 1000, aimed=True)
    got = mxu_group.mxu_candidates(coef, feats, n_groups=4, precision=form,
                                   kernel=kernel)
    want = mxu_group.candidates_reference(coef, feats, n_groups=4,
                                          precision=form)
    mag = coef.abs() @ feats.abs()
    assert got.shape == (4, 320, 1000)
    assert bool(((got - want).abs() <= 2.0 ** -20 * mag).all())


@pytest.mark.cuda
def test_group_kernels_repeat_and_refuse_on_card():
    """Three passes leave what one pass found (mm_only adds three times); a
    table on the CPU beside rays on the card is refused, as are wrong
    shapes."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    tris, o, d, coef, feats, t_init = _group_inputs(4, 1000)
    kw = dict(n_groups=4)
    runs = (lambda r: mxu_group.run_vpu(tris, o, d, t_init, reps=r, **kw),
            lambda r: mxu_group.run_mxu(coef, feats, t_init, reps=r, **kw),
            lambda r: mxu_group.run_mxu(coef, feats, t_init, reps=r,
                                        precision="highest", **kw),
            lambda r: mxu_group.run_mxu_big(coef, feats, t_init, reps=r,
                                            **kw),
            lambda r: mxu_group.run_mxu_split3(coef, feats, t_init, reps=r,
                                               **kw))
    for run in runs:
        for x, y in zip(run(1), run(3)):
            assert torch.equal(x, y)
    zero = torch.zeros_like(t_init)
    one, three = (mxu_group.run_mxu_big(coef, feats, zero, reps=r,
                                        mm_only=True, **kw)[0]
                  for r in (1, 3))
    assert float((three - 3.0 * one).abs().max()) \
        <= 1e-5 * float(one.abs().max())
    with pytest.raises(ValueError, match="cpu"):
        mxu_group.run_mxu(coef.cpu(), feats, t_init, reps=1, **kw)
    with pytest.raises(ValueError, match="cpu"):
        mxu_group.run_mxu_split3(coef, feats.cpu(), t_init, reps=1, **kw)
    with pytest.raises(ValueError, match="cpu"):
        mxu_group.run_vpu(tris.cpu(), o, d, t_init, reps=1, **kw)
    with pytest.raises(ValueError, match="feats"):
        mxu_group.run_mxu_big(coef, feats[:, :-1], t_init, reps=1, **kw)
    with pytest.raises(ValueError, match="precision"):
        mxu_group.run_mxu(coef, feats, t_init, reps=1, precision="tf32",
                          **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_mxu_phase_cycles_on_card(precision):
    """mxu_kernel's check-only PHASES instantiation: the kernel's outputs,
    cycles in every part, the parts within the warps' cycles, and no launch
    counted; mxu_kernel with DUMP (the pad chunk from the table) finds the
    same hits."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    _, _, _, coef, feats, t_init = _group_inputs(4, 1000, aimed=True)
    kw = dict(n_groups=4, reps=2, precision=precision)
    before = dict(mxu_group.launches)
    *out, cyc = mxu_group.mxu_phase_cycles(coef, feats, t_init, **kw)
    assert mxu_group.launches == before
    ref = mxu_group.run_mxu(coef, feats, t_init, **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    parts = ("stage", "product", "test", "commit")
    assert all(cyc[k] > 0 for k in parts)
    assert sum(cyc[k] for k in parts) <= cyc["warp"]


@pytest.mark.cuda
def test_run_vpu_refuses_tris_off_a_16_byte_boundary_on_card():
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    tris, o, d, _, _, t_init = _group_inputs(1, 1000)
    shifted = torch.zeros(tris.numel() + 1, device="cuda")[1:].view(-1, 9)
    shifted.copy_(tris)
    with pytest.raises(ValueError, match="16-byte"):
        mxu_group.run_vpu(shifted, o, d, t_init, n_groups=1, reps=1)


@pytest.mark.cuda
def test_diag_tool_on_card():
    """The diagnostic end to end on the card at a small size: eight rows,
    each with a time from the 4 x reps against reps difference, through
    all four kernels."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group
    from pathtracer0_tpu_torch.tools import diag_mxu

    before = dict(mxu_group.launches)
    rows = diag_mxu.main(4, 8, n_blocks=4, out=lambda line: None)
    assert [r["row"][0] for r in rows] == list("ABCCBCCDE")
    assert all(r["us_per_group_1024_rays"] > 0.0 for r in rows)
    assert all(mxu_group.launches[k] > before[k] for k in before)
    by = {r["row"]: r for r in rows}
    assert by["B mxu rows (highest)"]["idx_mismatch"] < 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 6])
def test_refill_matches_plain_and_default_on_card(n):
    """The refill schedule: against the plain version at 2 spp to the
    kernel-parity limits; against the default schedule at 16 spp the same
    bits (state and radiance equal on >= 99.9% of pixels, queries equal);
    the counting instantiations of both schedules count every query once
    and render the same frame."""
    _card()
    sc, info = scenes.BUILDERS[n]().build(device="cuda")
    cam, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in scenes.CAMERAS[n])
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    ifd = torch.tensor(IFD, device="cuda")
    kw = dict(width=W, height=H, max_bounces=6, blur=BLUR)
    before = (tframe.trace_frame.launches, tframe.trace_frame.refill_launches)
    rk, sk, qk = tframe.trace_frame(sc, info, cam, rot, ifd, state, spp=SPP,
                                    refill=True, **kw)
    assert (tframe.trace_frame.launches,
            tframe.trace_frame.refill_launches) == (before[0], before[1] + 1)
    rp, sp, qp = tframe.trace_frame_reference(sc, info, cam, rot, ifd,
                                              state, spp=SPP, **kw)
    diff = (rk - rp).abs().max(dim=-1).values
    assert bool(torch.isfinite(rk).all())
    assert float((sk == sp).float().mean()) >= 0.99
    assert float((diff < 1e-4).float().mean()) >= 0.99
    assert float((rk - rp).abs().mean()) < 5e-3
    assert abs(int(qk) - int(qp)) <= 0.01 * int(qp) + 16
    r16 = tframe.trace_frame(sc, info, cam, rot, ifd, state, spp=16,
                             refill=True, **kw)
    d16 = tframe.trace_frame(sc, info, cam, rot, ifd, state, spp=16, **kw)
    assert float((r16[0] == d16[0]).all(-1).float().mean()) >= 0.999
    assert float((r16[1] == d16[1]).float().mean()) >= 0.999
    assert int(r16[2]) == int(d16[2])
    use = {}
    for refill in (False, True):
        out = tframe.lane_use(sc, info, cam, rot, ifd, state, spp=16,
                              refill=refill, **kw)
        used, steps = out[3].tolist()
        assert used == int(d16[2])
        assert float((out[0] == d16[0]).all(-1).float().mean()) >= 0.999
        use[refill] = used / (32.0 * steps)
    assert 0.0 < use[False] <= use[True] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n, refill", [(1, False), (2, False), (2, True),
                                       (4, False), (4, True), (6, True)])
def test_phase_cycles_on_card(n, refill):
    """The PHASES instantiation renders the frame of the main one and adds
    the cycles of every part of a scene query; its launch is counted in
    neither launch count."""
    _card()
    sc, info = scenes.BUILDERS[n]().build(device="cuda")
    cam, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in scenes.CAMERAS[n])
    state = trng.seed(torch.arange(W * H, device="cuda"), SEED)
    ifd = torch.tensor(IFD, device="cuda")
    kw = dict(width=W, height=H, spp=4, max_bounces=6, blur=BLUR,
              whitted=n == 1, refill=refill)
    ref = tframe.trace_frame(sc, info, cam, rot, ifd, state, **kw)
    before = (tframe.trace_frame.launches, tframe.trace_frame.refill_launches)
    rad, st, q, cyc = tframe.phase_cycles(sc, info, cam, rot, ifd, state,
                                          **kw)
    assert (tframe.trace_frame.launches,
            tframe.trace_frame.refill_launches) == before
    assert torch.equal(rad, ref[0]) and torch.equal(st, ref[1])
    assert int(q) == int(ref[2])
    assert set(cyc) == set(tframe.PHASES) and cyc["warp"] > 0
    assert cyc["ellipsoids"] > 0 and cyc["sky"] > 0
    assert (cyc["choose"] == 0) == (n == 1)


@pytest.mark.cuda
def test_renderer_takes_refill_on_card(monkeypatch):
    """PT0_FUSED_REFILL=1 sends Renderer's frames through the refill
    schedule; Whitted frames and one-sample frames keep the default."""
    _card()
    monkeypatch.setenv("PT0_FUSED_REFILL", "1")
    cam, rot = scenes.CAMERAS[6]
    sc, info = scenes.BUILDERS[6]().build()
    for spp, raytracing, refilled in ((2, True, 3), (1, True, 0),
                                      (2, False, 0)):
        r = Renderer(sc, info, RenderConfig(width=W, height=H,
                                            samples_per_frame=spp,
                                            raytracing=raytracing),
                     cam_pos=cam, cam_rot=rot)
        before = (tframe.trace_frame.launches,
                  tframe.trace_frame.refill_launches)
        img = r.render(3)
        assert (tframe.trace_frame.launches - before[0],
                tframe.trace_frame.refill_launches - before[1]) \
            == (3 - refilled, refilled)
        assert bool(torch.isfinite(img).all())


def _prefilter_inputs(n_groups, n_rays, aimed):
    from pathtracer0_tpu_torch.kernels import mxu_tri

    tris, o, d, coef, feats, t_init = _group_inputs(n_groups, n_rays, aimed)
    return (tris, o, d, coef, feats, t_init,
            mxu_tri.recentre_tris(tris, (150.0, 150.0, 150.0)),
            mxu_tri.recentre_origins(o, (150.0, 150.0, 150.0)))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays, aimed", [(16384, False), (1000, False),
                                           (16384, True), (1000, True)])
def test_prefilter_matches_plain_on_card(n_rays, aimed):
    """Row E against its plain version: idx equal on >= 99.9% of the rays
    that hit in either, t, u, v within 1e-5 where idx agrees, the groups
    each warp passed equal on >= 99.9% of the warps; and no hit of row A
    lost."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    tris, o, d, coef, feats, t_init, tris_c, o_c = _prefilter_inputs(
        4, n_rays, aimed)
    kw = dict(n_groups=4, reps=1)
    before = mxu_group.launches["prefilter_kernel"]
    e_k = mxu_group.run_prefilter(coef, tris_c, feats, o_c, d, t_init, **kw)
    assert mxu_group.launches["prefilter_kernel"] == before + 1
    e_p = mxu_group.prefilter_reference(coef, tris_c, feats, o_c, d, t_init,
                                        **kw)
    same = e_k[3] == e_p[3]
    assert _hits_idx_eq(e_k, e_p) >= 0.999
    for x, y in zip(e_k[:3], e_p[:3]):
        assert float((x - y).abs()[same].max()) <= 1e-5
    assert e_k[4].shape == (-(-n_rays // 32),)
    assert float((e_k[4] == e_p[4]).float().mean()) >= 0.999
    a = mxu_group.run_vpu(tris, o, d, t_init, **kw)
    assert not bool(((a[3] >= 0) & (e_k[3] < 0)).any())
    assert mxu_group.prefilter_margin(coef, feats, a[3]) > 0.0
    # three passes find what one found; the gate counts one pass
    e3 = mxu_group.run_prefilter(coef, tris_c, feats, o_c, d, t_init,
                                 n_groups=4, reps=3)
    for x, y in zip(e_k, e3):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_prefilter_gate_leaves_at_the_first_chunk_that_passes_on_card():
    """The gate's early exit: groups whose only triangles sit in chunk 0, 3
    or 6 (the others empty) and one group all empty, so that a warp's gate
    passes at its first, fourth or last chunk or never. Kernel and plain
    version (the gate over the whole group) agree to the row-E limits and
    on the gate counts."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group, mxu_tri
    from pathtracer0_tpu_torch.tools import diag_mxu

    data = diag_mxu.synthetic(4, 2)
    tris = data["tris"].clone()
    for g, keep in enumerate((0, 3, 6, None)):
        group = tris[g * 56:(g + 1) * 56]
        for jt in range(7):
            if jt != keep:
                group[8 * jt:8 * jt + 8] = 0.0
    data = diag_mxu.aim({**data, "tris": tris})[0]
    o, d, center = data["o"], data["d"], data["center"]
    coef = mxu_tri.coef_table(tris, center)
    feats = mxu_tri.ray_features(o, d, center)
    t_init = torch.full((o[0].shape[0],), 1e30, device="cuda")
    args = (coef, mxu_tri.recentre_tris(tris, center), feats,
            mxu_tri.recentre_origins(o, center), d, t_init)
    kw = dict(n_groups=4, reps=1)
    e_k = mxu_group.run_prefilter(*args, **kw)
    plain = mxu_group.prefilter_reference(*args, **kw)
    same = e_k[3] == plain[3]
    assert _hits_idx_eq(e_k, plain) >= 0.999
    for x, y in zip(e_k[:3], plain[:3]):
        assert float((x - y).abs()[same].max()) <= 1e-5
    assert float((e_k[4] == plain[4]).float().mean()) >= 0.999
    assert int(e_k[4].max()) <= 3 and float((e_k[3] >= 0).float().mean()) \
        > 0.2
    a = mxu_group.run_vpu(tris, o, d, t_init, **kw)
    assert not bool(((a[3] >= 0) & (e_k[3] < 0)).any())


@pytest.mark.cuda
def test_prefilter_phase_cycles_on_card():
    """prefilter_kernel's check-only PHASES instantiation: the kernel's
    outputs, cycles in the stage, the products, the margin test and the
    vote (and the slot test, where a gate passes), the parts within the
    warps' cycles, and no launch counted."""
    _card()
    from pathtracer0_tpu_torch.kernels import mxu_group

    _, _, d, coef, feats, t_init, tris_c, o_c = _prefilter_inputs(
        4, 1000, True)
    args = (coef, tris_c, feats, o_c, d, t_init)
    kw = dict(n_groups=4, reps=2)
    before = dict(mxu_group.launches)
    *out, cyc = mxu_group.prefilter_phase_cycles(*args, **kw)
    assert mxu_group.launches == before
    for a, b in zip(out, mxu_group.run_prefilter(*args, **kw)):
        assert torch.equal(a, b)
    parts = ("stage", "product", "margin", "vote", "slot")
    assert all(cyc[k] > 0 for k in parts)
    assert sum(cyc[k] for k in parts) <= cyc["warp"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(10))
def test_mm_probe_matches_plain_on_card(case):
    """mm_probe_kernel against its plain version, each case of the tool, at
    1,000 columns (no multiple of a block's 64) and 8 reps: within 2^-20 of
    the sum of magnitudes |a| |b|."""
    _card()
    from pathtracer0_tpu_torch.kernels import mm_probe
    from pathtracer0_tpu_torch.tools import diag_mxu_mm

    form, precision, dtype = diag_mxu_mm.cases()[case]
    ops = diag_mxu_mm.operands(1000, "cuda")
    a, b = ops[form.split("_")[0]].to(dtype), ops["b"].to(dtype)
    kw = dict(reps=8, form=form, precision=precision)
    before = mm_probe.launches["mm_probe_kernel"]
    got = mm_probe.run(a, b, **kw)
    assert mm_probe.launches["mm_probe_kernel"] == before + 1
    want = mm_probe.mm_probe_reference(a, b, **kw)
    mag = mm_probe.magnitudes(a, b, reps=8, form=form)
    assert got.shape == (8, 1000) and got.dtype == torch.float32
    assert bool(((got.double() - want.double()).abs()
                 <= 2.0 ** -20 * mag).all())
    assert torch.equal(mm_probe.run(a, b, reps=0, form=form,
                                    precision=precision),
                       torch.zeros_like(got))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(10))
def test_mm_probe_ragged_columns_on_card(case):
    """Each case at column counts that are no multiple of a warp's 16 or 32
    columns (1, 33, 8,200 with one M tile a warp, 140,009 with two) and at
    9 reps (the "dyn" forms read slice 0 twice): within 2^-20 of the sum of
    magnitudes of the plain version, and a column's `o` does not depend on
    how many columns share the launch."""
    _card()
    from pathtracer0_tpu_torch.kernels import mm_probe
    from pathtracer0_tpu_torch.tools import diag_mxu_mm

    form, precision, dtype = diag_mxu_mm.cases()[case]
    ops = diag_mxu_mm.operands(140009, "cuda")
    a = ops[form.split("_")[0]].to(dtype)
    kw = dict(reps=9, form=form, precision=precision)
    wide = mm_probe.run(a, ops["b"].to(dtype), **kw)
    for n in (1, 33, 8200, 140009):
        b = ops["b"][:, :n].to(dtype).contiguous()
        got = mm_probe.run(a, b, **kw)
        want = mm_probe.mm_probe_reference(a, b, **kw)
        mag = mm_probe.magnitudes(a, b, reps=9, form=form)
        assert got.shape == (8, n)
        assert bool(((got.double() - want.double()).abs()
                     <= 2.0 ** -20 * mag).all())
        assert torch.equal(got, wide[:, :n])


@pytest.mark.cuda
def test_probe_tool_on_card():
    """The probe end to end at a small size: every case timed by the 4 x
    reps against reps difference, and the library's two rows."""
    _card()
    from pathtracer0_tpu_torch.kernels import mm_probe
    from pathtracer0_tpu_torch.tools import diag_mxu_mm

    before = mm_probe.launches["mm_probe_kernel"]
    rows = diag_mxu_mm.main(1024, 16, out=lambda line: None)
    assert len(rows) == len(diag_mxu_mm.cases()) + 2
    assert all(r["us_per_product"] > 0.0 for r in rows)
    assert mm_probe.launches["mm_probe_kernel"] > before
    with pytest.raises(ValueError, match="bf16"):
        mm_probe.run(*(x.to(torch.bfloat16) for x in (
            diag_mxu_mm.operands(64, "cuda")["std"],
            diag_mxu_mm.operands(64, "cuda")["b"])), reps=1, form="std_fix",
            precision="highest")
