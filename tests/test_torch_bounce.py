"""The per-bounce route's bounce step (kernels/bounce.py): the bounce
kernel's per-ray body built by g++ (`bounce_step_host`, csrc/bounce_host.cpp
over csrc/integrate.cuh `bounce_ray`) against the plain PyTorch version
(`bounce_step_plain`), the route with fused="off" against the JAX
package's, `walk_triangles` plus the merge against `ray_scene`, and on a
card the kernel on the route (stacks of any depth: test_torch_stack.py).

Limits: the kernel-parity limits of PERF.md section 2 (those of
tests/test_fused.py): the state bit-equal on >= 99% of the rays, the
radiance within 1e-4 on >= 99%, the queries equal (the g++ build and
PyTorch's CPU kernels round their transcendentals apart by an ulp at
most). The route against the JAX package's: those of
tests/test_torch_route.py, radiance within 1e-4 on >= 99% of the pixels,
mean abs difference < 5e-3, queries within 1% + 16.

The JAX package is imported by the test that compares with it alone, so
that the card-only test runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_bounce.py
"""
import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Scene, render_frame, scenes
from pathtracer0_tpu_torch.core import math as tmath
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import bounce, frame, traverse
from pathtracer0_tpu_torch.render import integrator

torch.set_num_threads(1)

W, H, BOUNCES = 24, 18, 4
SEEDS = np.random.RandomState(15).randint(1, 2 ** 31 - 1, size=8)
TERRAIN_CAM = ((0.0, 2.2, 4.0), (1.0, 0.0, 0.0))


def _terrain(sc, n=14, subsurface=False):
    """A small terrain (2 (n - 1)^2 triangles) with a metal and a glass
    sphere on it, through either package's Scene API."""
    xs = np.linspace(-3.0, 3.0, n)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X * 1.3) * np.cos(Z * 1.1) * 0.4, Z + 6.0], -1)
    a, b, c, d = (P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3),
                  P[:-1, 1:].reshape(-1, 3), P[1:, 1:].reshape(-1, 3))
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("terrain")
    sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    sc.set_last_mtl("Pr", 0.6)
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
    sc.add_mesh(np.concatenate([a, d]), np.concatenate([b, b]),
                np.concatenate([c, c]), 0)
    sc.add_sphere((-1.0, 1.0, 6.0), 0.8, m=1)
    sc.add_sphere((1.0, 1.0, 6.5), 0.8, m=2)
    return sc


def _build(name):
    """(scene, info, camera) of the five scenes."""
    if name in ("forest", "streamed", "whitted_subsurface"):
        cfg = RenderConfig(max_tris_in_leaf=4,
                           stream_threshold=0 if name == "streamed" else 1 << 16)
        sc, info = _terrain(Scene(), subsurface=name == "whitted_subsurface"
                            ).build(cfg, device="cpu")
        return sc, info, TERRAIN_CAM
    n = {"config4": 4, "config6": 6}[name]
    return (*scenes.BUILDERS[n]().build(device="cpu"), scenes.CAMERAS[n])


SCENES = ("forest", "streamed", "config4", "config6", "whitted_subsurface")


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name)
        return cache[name]
    return get


def _rays(cam, rot, seed):
    """One sample's rays of W x H pixels, every ninth switched off."""
    state = trng.seed(torch.arange(W * H), int(seed))
    o, d, state = frame._raygen(
        torch.tensor(cam, dtype=torch.float32),
        tmath.rotation_matrix(torch.tensor(rot, dtype=torch.float32)),
        torch.tensor(5.0), state, W, H, cam_size=1.5, focal_length=1.0,
        blur=0.001)
    alive = torch.arange(W * H) % 9 != 0
    return o, d, alive, state


def _walk(sc, info, st):
    return traverse.walk_triangles(tuple(st.o), tuple(st.d), sc, info,
                                   active=st.alive)[0]


def _canonical_stack(st):
    """The stack top first with entries at and past ssize 0."""
    return bounce._flip(st.stack, st.ssize)


def _assert_states(a, b):
    """Two path states after the same bounces, at the kernel-parity limits:
    the RNG state and the discrete fields bit-equal on >= 99% of the rays;
    the float vectors (the next rays, throughput, entry points, radiance)
    within 1e-4 on >= 99% (a diffuse direction draws through logf and
    cosf, which the two builds round apart by an ulp on ~1% of the rays);
    the queries equal."""
    for name in ("state", "ssize", "inobj", "alive"):
        same = getattr(a, name) == getattr(b, name)
        assert float(same.float().mean()) >= 0.99, name
    same = (_canonical_stack(a) == _canonical_stack(b)).all(0)
    assert float(same.float().mean()) >= 0.99
    for name in ("o", "d", "col", "enter", "inc", "skyc"):
        diff = (getattr(a, name) - getattr(b, name)).abs().amax(0)
        assert float((diff < 1e-4).float().mean()) >= 0.99, name
    assert torch.equal(a.queries, b.queries)
    assert a.bounce == b.bounce


@pytest.mark.parametrize("name", SCENES[:4])
def test_one_bounce_host_matches_plain(built, name):
    """(a) One bounce of the path form from the same state and walk: the
    kernel's body through g++ against the plain version, on each bounce of
    a path the plain version takes."""
    sc, info, (cam, rot) = built(name)
    o, d, alive, state = _rays(cam, rot, SEEDS[0])
    st = bounce.begin(o, d, alive, state, stack_size=10)
    hits = 0
    for _ in range(BOUNCES):
        walk = _walk(sc, info, st)
        hits += int(((walk.row >= 0) & st.alive).sum())
        host = st.clone()
        bounce.bounce_step_host(sc, info, host, walk)
        bounce.bounce_step_plain(sc, info, st, walk)
        _assert_states(host, st)
        n_host, n_plain = int(host.alive.sum()), int(st.alive.sum())
        assert abs(n_host - n_plain) <= 0.01 * n_plain + 1
        if not n_plain:
            break
    if name in ("forest", "streamed", "config6"):
        assert hits > W * H // 4        # the scene's triangles were shaded


@pytest.mark.parametrize("name", SCENES[:4])
def test_bounce_loop_host_matches_plain(built, name):
    """(a) The whole bounce loop, each step of its own state: the host
    build against the plain version."""
    sc, info, (cam, rot) = built(name)
    for seed in SEEDS[1:3]:
        o, d, alive, state = _rays(cam, rot, seed)
        out = {label: integrator._bounce_loop(
                   integrator._forest_walk(sc, info), step, sc, info,
                   o, d, alive, state, max_bounces=BOUNCES, stack_size=10)
               for label, step in (("plain", bounce.bounce_step_plain),
                                   ("host", bounce.bounce_step_host))}
        rad = {k: torch.stack([v[0][i] + v[1][i] for i in range(3)], -1)
               for k, v in out.items()}
        diff = (rad["host"] - rad["plain"]).abs().amax(-1)
        assert float((out["host"][2] == out["plain"][2]).float().mean()) \
            >= 0.99
        assert float((diff < 1e-4).float().mean()) >= 0.99
        assert torch.equal(out["host"][3], out["plain"][3])
        # rays switched off keep their state and count no query
        assert torch.equal(out["host"][2][~alive], state[~alive])
        assert int(out["host"][3][~alive].sum()) == 0


@pytest.mark.parametrize("name", SCENES)
def test_whitted_forms_host_match_plain(built, name):
    """(a) The Whitted form, and where the scene has subsurface materials
    and a tree the locate form and the thickness probe from it."""
    sc, info, (cam, rot) = built(name)
    o, d, alive, _ = _rays(cam, rot, SEEDS[3])
    probing = bool(info.mat_gates[0]) and traverse.has_tree(info)
    assert probing == (name == "whitted_subsurface")
    walk = traverse.walk_triangles(o, d, sc, info, active=alive)[0]
    out = {}
    for label, step in (("plain", bounce.bounce_step_plain),
                        ("host", bounce.bounce_step_host)):
        st = bounce.begin_whitted(o, d, alive, probe=probing)
        probe_t = None
        if probing:
            step(sc, info, st, walk, form="locate")
            out[label + "_loc"] = st.loc.clone()
            probe_t = traverse.probe_forest_t(tuple(st.loc), d, sc, info)
        step(sc, info, st, walk, form="whitted", probe_t=probe_t)
        assert st.bounce == 0
        out[label] = st.inc
    diff = (out["host"] - out["plain"]).abs().amax(0)
    assert float((diff < 1e-4).float().mean()) >= 0.99
    assert float(out["host"][:, ~alive].abs().max()) == 0.0
    if probing:
        same = (out["host_loc"] == out["plain_loc"]).all(0)
        assert float(same.float().mean()) >= 0.99
        # the probe changed the shade of the subsurface terrain
        plain_st = bounce.begin_whitted(o, d, alive)
        bounce.bounce_step_plain(sc, info, plain_st, walk, form="whitted")
        assert float((plain_st.inc - out["plain"]).abs().max()) > 0.05
    # the Whitted route through the same step
    col = integrator.direct_diffuse(sc, info, o, d, alive)
    torch.testing.assert_close(torch.stack(col), out["plain"], rtol=0,
                               atol=0)


def _jax_frame(dev, info, raytracing):
    import jax.numpy as jnp
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu.render import renderer as jrenderer

    cfg = JConfig(width=W, height=H, samples_per_frame=2,
                  max_bounces=BOUNCES, auto_focus=False, focal_distance=5.0,
                  blur=0.001, fused="off", pallas="off",
                  raytracing=raytracing)
    return jrenderer.render_frame(
        dev, jnp.asarray(TERRAIN_CAM[0], jnp.float32),
        jnp.asarray(TERRAIN_CAM[1], jnp.float32), jnp.uint32(SEEDS[4]),
        info=info, params=jrenderer._frame_params(cfg), width=W, height=H,
        spp=2, raytracing=raytracing, auto_focus=False,
        cam_size=cfg.cam_size, focal_length=cfg.focal_length, blur=cfg.blur,
        focal_distance=cfg.focal_distance)


@pytest.mark.parametrize("raytracing,subsurface", [(True, False),
                                                   (False, True)])
def test_route_matches_jax(raytracing, subsurface):
    """(b) The per-bounce route, fused="off", end to end on the terrain
    against the JAX package's render_frame(fused="off") through its plain
    walk (pallas="off"): path mode, and Whitted mode with the thickness
    probe."""
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene

    dev, jinfo = _terrain(JScene(), subsurface=subsurface).build(
        JConfig(max_tris_in_leaf=4))
    sc, info = _terrain(Scene(), subsurface=subsurface).build(
        RenderConfig(max_tris_in_leaf=4), device="cpu")
    img_j, rays_j = _jax_frame(dev, jinfo, raytracing)
    cfg = RenderConfig(width=W, height=H, samples_per_frame=2,
                       max_bounces=BOUNCES, auto_focus=False,
                       focal_distance=5.0, blur=0.001, fused="off",
                       raytracing=raytracing)
    img_t, rays_t = render_frame(sc, info, cfg, *TERRAIN_CAM, int(SEEDS[4]),
                                 device="cpu")
    a, b = np.asarray(img_j), img_t.numpy()
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, (diff.max(), (diff < 1e-4).mean())
    assert np.abs(a - b).mean() < 5e-3
    assert abs(float(rays_j) - int(rays_t)) <= 0.01 * float(rays_j) + 16
    assert b.std() > 0.05          # terrain, spheres and sky in the picture


@pytest.mark.parametrize("name", ("forest", "streamed", "config4"))
def test_walk_and_merge_equal_ray_scene(built, name):
    """(c) walk_triangles, its hit record and the analytic merge give
    ray_scene's hit, field for field."""
    sc, info, (cam, rot) = built(name)
    o, d, alive, _ = _rays(cam, rot, SEEDS[5])
    walk, on = traverse.walk_triangles(o, d, sc, info, active=alive)
    assert walk.row.dtype == torch.int32 and walk.row.shape == (W * H,)
    assert (walk.perm is None) == (not traverse.has_tree(info))
    merged = traverse._merge_analytic_batched(on, d, sc, info,
                                              traverse.walk_hit(walk, sc))
    hit, on_r = traverse.ray_scene(o, d, sc, info, active=alive)
    for a, b in zip((*merged, *on), (*hit, *on_r)):
        assert torch.equal(a, b)
    assert int((hit.kind == 1).sum()) == int((walk.row >= 0).sum()) or \
        info.num_ellipsoids + info.num_implicits > 0
    # switched-off rays: t = 0, no triangle
    assert float(hit.t[~alive].abs().max()) == 0.0
    assert int(hit.tri[~alive].max()) == -1


def test_bounce_step_refuses_what_it_does_not_take(built):
    """The kernel's launcher runs on CUDA tensors only; a form that is none
    of FORMS, a locate form without room for the locations and a walk of
    another length are refused by all three."""
    sc, info, (cam, rot) = built("forest")
    o, d, alive, state = _rays(cam, rot, SEEDS[7])
    st = bounce.begin(o, d, alive, state, stack_size=10)
    walk = _walk(sc, info, st)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.bounce_step(sc, info, st, walk)
    for step in (bounce.bounce_step_plain, bounce.bounce_step_host):
        with pytest.raises(ValueError, match="form must be"):
            step(sc, info, st, walk, form="shade")
        with pytest.raises(ValueError, match="locate"):
            step(sc, info, bounce.begin_whitted(o, d, alive), walk,
                 form="locate")
        short = traverse.Walk(*(x[:-1] for x in walk[:4]), walk.perm)
        with pytest.raises(ValueError, match="one entry per ray"):
            step(sc, info, st, short)


@pytest.mark.cuda
def test_route_launches_the_kernel_on_card(monkeypatch):
    """(e) On CUDA tensors the per-bounce route, path and Whitted, launches
    bounce_kernel once a bounce, every one of max_bounces, and never runs
    the plain step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sc, info = _terrain(Scene()).build(RenderConfig(max_tris_in_leaf=4),
                                       device="cuda")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain step ran on CUDA tensors")

    monkeypatch.setattr(bounce, "bounce_step_plain", no_plain)
    (cam, rot), n = TERRAIN_CAM, W * H
    state = trng.seed(torch.arange(n, device="cuda"), 5)
    o, d, state = frame._raygen(
        torch.tensor(cam, device="cuda"),
        tmath.rotation_matrix(torch.tensor(rot, device="cuda")),
        torch.tensor(5.0, device="cuda"), state, W, H, cam_size=1.5,
        focal_length=1.0, blur=0.001)
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    before = bounce.bounce_step.launches
    inc, skyc, st, q = integrator.trace_bounces(sc, info, o, d, alive, state,
                                                max_bounces=BOUNCES)
    launched = bounce.bounce_step.launches - before
    assert launched == BOUNCES and 1 <= int(q.max()) <= launched
    before = bounce.bounce_step.launches
    col = integrator.direct_diffuse(sc, info, o, d, alive)
    assert bounce.bounce_step.launches == before + 1
    assert bool(torch.isfinite(torch.stack(col)).all())
