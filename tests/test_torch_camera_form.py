"""The camera form of the bounce kernel (kernels/bounce.py `camera_step`):
each sample's rays with depth of field and its path state, on the rays'
state in place. Its body built by g++ (`camera_step_host`,
csrc/bounce_host.cpp over csrc/integrate.cuh `camera_ray`) against the
plain version (`camera_step_plain`: core/camera.py `dof_ray` and what
`begin` writes),
`render_rays` over it against the loop of `dof_ray` + `integrator.trace` it
replaces, and on a card the route's launches.

Limits: the RNG state and the path state bit-equal on every ray; the rays
bit-equal at blur 0 (products, sums, one square root and one division,
all correctly rounded without contraction) and within 1e-6 at blur 0.001
(g++'s logf and cosf against PyTorch's log and cos, an ulp apart at
most); `render_rays` bit-equal to the loop it replaces (the same plain
versions in the same order).

The card-only test runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_camera_form.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Scene, scenes
from pathtracer0_tpu_torch.core import camera
from pathtracer0_tpu_torch.core import math as tmath
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import bounce
from pathtracer0_tpu_torch.render import integrator
from pathtracer0_tpu_torch.render.renderer import render_rays

torch.set_num_threads(1)

W, H = 40, 30
SEED = 1606
CAM = ((0.3, 1.2, -2.0), (0.25, -0.1, 0.05))
STATE_FIELDS = ("state", "alive", "col", "inc", "skyc", "enter", "stack",
                "ssize", "inobj", "queries", "total")


def _camera(device="cpu"):
    """(primary directions (3, R), camera scalars (13,), RNG state (R,))
    of a W x H camera."""
    uv, index = camera.pixel_centers(W, H, device)
    pos, rot = (torch.tensor(v, dtype=torch.float32, device=device)
                for v in CAM)
    rotmat = tmath.rotation_matrix(rot)
    pd = camera.primary_directions(uv, rotmat, 1.5, 1.0, H / W)
    cam = bounce.camera_scalars(pos, rotmat, torch.tensor(4.0,
                                                          device=device))
    return pd.T.contiguous(), cam, trng.seed(index, SEED)


def _state(state, path, totals=True):
    st = bounce.state_for(state.clone(), path=path, stack_size=6,
                          totals=totals)
    # what a sample before left in the state
    g = torch.Generator().manual_seed(3)
    for name in ("inc", "skyc", "col", "enter", "total"):
        t = getattr(st, name)
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=g))
    if path:
        st.stack.copy_(torch.rand(st.stack.shape, generator=g))
        st.queries.fill_(5)
        st.ssize.fill_(3)
        st.inobj.fill_(True)
    return st


@pytest.mark.parametrize("path", (True, False))
@pytest.mark.parametrize("blur", (0.0, 0.001))
def test_host_matches_plain(blur, path):
    """The camera form's body through g++ against the plain version, three
    samples, the last adding the one before into the running total."""
    pd, cam, state = _camera()
    out = {}
    for label, step in (("plain", bounce.camera_step_plain),
                        ("host", bounce.camera_step_host)):
        st = _state(state, path)
        step(st, pd, cam, blur)
        step(st, pd, cam, blur, accumulate=True)
        st.inc.add_(0.25)                 # the sample's radiance
        step(st, pd, cam, blur, accumulate=True)
        out[label] = st
    a, b = out["plain"], out["host"]
    for name in STATE_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name
    for name in ("o", "d"):
        x, y = getattr(a, name), getattr(b, name)
        if blur == 0.0:
            assert torch.equal(x, y), name
        else:
            assert float((x - y).abs().max()) < 1e-6, name
    assert not torch.equal(a.state, state)       # 6 draws a sample
    assert torch.equal(a.state, trng.advance(state, 18))


@pytest.mark.parametrize("blur", (0.0, 0.001))
def test_plain_is_dof_ray_and_begin(blur):
    """The plain camera form is core/camera.py `dof_ray` and bounce.begin
    (path) or begin_whitted (Whitted), bit for bit; a running total starts
    at 0 and adds the sample before (inc + skyc) first."""
    pd, cam, state = _camera()
    o, d, state1 = camera.dof_ray(cam[:3], pd.T, cam[3:12].reshape(3, 3),
                                  blur, cam[12], state)
    o, d = o.unbind(-1), d.unbind(-1)
    alive = torch.ones(state.shape, dtype=torch.bool)
    want = bounce.begin(o, d, alive, state1, stack_size=6)
    st = _state(state, True)
    before = st.inc + st.skyc
    bounce.camera_step_plain(st, pd, cam, blur)
    assert float(st.total.abs().max()) == 0.0
    for name in ("o", "d", *STATE_FIELDS[:-1]):
        got = getattr(st, name)
        if name == "stack":               # entries past ssize are not read
            got = got[:1]
            assert torch.equal(got, want.stack[:1])
            continue
        assert torch.equal(got, getattr(want, name)), name
    total = st.total.clone()
    st.inc.copy_(before)
    bounce.camera_step_plain(st, pd, cam, blur, accumulate=True)
    assert torch.equal(st.total, total + (before + 0.0))
    w = bounce.state_for(state.clone(), path=False)
    bounce.camera_step_plain(w, pd, cam, blur)
    ww = bounce.begin_whitted(o, d, alive)
    assert torch.equal(w.o, ww.o) and torch.equal(w.d, ww.d)
    assert torch.equal(w.state, state1) and bool(w.alive.all())


def test_camera_step_refuses():
    """The launcher runs on CUDA tensors only; primary directions of
    another length are refused by all three."""
    pd, cam, state = _camera()
    st = bounce.state_for(state, path=True)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.camera_step(st, pd, cam, 0.0)
    for step in (bounce.camera_step_plain, bounce.camera_step_host):
        with pytest.raises(ValueError, match="primary directions"):
            step(st, pd[:, :-1], cam, 0.0)


def _terrain(n=10):
    xs = np.linspace(-3.0, 3.0, n)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X * 1.3) * np.cos(Z * 1.1) * 0.4, Z + 6.0], -1)
    a, b, c, d = (P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3),
                  P[:-1, 1:].reshape(-1, 3), P[1:, 1:].reshape(-1, 3))
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("terrain")
    sc.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    sc.set_last_mtl("subsurface", 0.6)
    sc.set_last_mtl("subsurfaceColor", (0.9, 0.5, 0.3))
    sc.add_material("glass")
    sc.set_last_mtl("Tr", 0.92)
    sc.set_last_mtl("Ni", 1.5)
    sc.set_last_mtl("illum", 7)
    sc.add_mesh(np.concatenate([a, d]), np.concatenate([b, b]),
                np.concatenate([c, c]), 0)
    sc.add_sphere((0.5, 1.0, 6.0), 0.8, m=1)
    return sc.build(RenderConfig(max_tris_in_leaf=4), device="cpu")


def _per_sample_loop(scene, info, uv, index, cam_pos, cam_rot, frame_seed,
                     ifd, config):
    """render_rays' loop before the camera form: per sample `dof_ray`, then
    `integrator.trace` or `direct_diffuse`, the sums in the same order."""
    rotmat = tmath.rotation_matrix(cam_rot)
    direction = camera.primary_directions(uv, rotmat, config.cam_size,
                                          config.focal_length,
                                          config.screen_h_ratio)
    state = trng.seed(index, frame_seed)
    alive = torch.ones(state.shape, dtype=torch.bool)
    zero = torch.zeros(state.shape)
    total, queries = [zero, zero, zero], torch.zeros(1, dtype=torch.int64)
    for _ in range(config.samples_per_frame):
        o, d, state = camera.dof_ray(cam_pos, direction, rotmat, config.blur,
                                     ifd, state)
        o, d = o.unbind(-1), d.unbind(-1)
        if config.raytracing:
            col, state, q = integrator.trace(
                scene, info, o, d, alive, state,
                max_bounces=config.max_bounces,
                stack_size=config.refraction_stack_depth, fused=config.fused)
            queries = queries + q
        else:
            col = integrator.direct_diffuse(scene, info, o, d, alive)
            queries = queries + state.numel()
        total = [total[i] + col[i] for i in range(3)]
    return torch.stack(total, dim=-1) / float(config.samples_per_frame), \
        queries


@pytest.mark.parametrize("mode", ("path", "whitted", "path_deep",
                                  "block"))
def test_render_rays_equals_the_loop_it_replaces(mode):
    """render_rays over one state and the camera form, on the CPU, equals
    the per-sample loop of dof_ray + trace it replaced, bit for bit: path
    and Whitted mode (with the thickness probe), a stack of 17, and the
    block kernel's route of an eligible scene."""
    if mode == "block":
        sc, info = scenes.BUILDERS[2]().build(device="cpu")
    else:
        sc, info = _terrain()
    cfg = RenderConfig(width=12, height=9, samples_per_frame=3,
                       max_bounces=3, blur=0.001,
                       raytracing=mode != "whitted",
                       refraction_stack_depth=17 if mode == "path_deep"
                       else 10, fused="auto" if mode == "block" else "off")
    uv, index = camera.pixel_centers(cfg.width, cfg.height, "cpu")
    pos, rot = (torch.tensor(v, dtype=torch.float32) for v in CAM)
    ifd = torch.tensor(4.0)
    got = render_rays(sc, info, uv, index, pos, rot, 11, ifd, config=cfg)
    want = _per_sample_loop(sc, info, uv, index, pos, rot, 11, ifd, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[0].std()) > 0.01
    if mode == "path":
        folded = render_rays(sc, info, uv, index, pos, rot, 11, ifd,
                             config=cfg, fold_spp=True)
        assert bool(torch.isfinite(folded[0]).all()) and int(folded[1]) > 0


@pytest.mark.cuda
def test_route_launches_the_camera_form_on_card(monkeypatch):
    """On the card render_rays launches the camera form once a sample and
    runs no dof_ray op: path and Whitted mode, the block kernel's route,
    fold_spp and the legacy modes' single call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def no_dof_ray(*args, **kwargs):
        raise AssertionError("camera.dof_ray ran on the card's route")

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain camera step ran on CUDA tensors")

    monkeypatch.setattr(camera, "dof_ray", no_dof_ray)
    monkeypatch.setattr(bounce, "camera_step_plain", no_plain)
    xs = np.linspace(-3.0, 3.0, 10)
    X, Z = np.meshgrid(xs, xs)
    P = np.stack([X, np.sin(X) * 0.4, Z + 6.0], -1)
    a, b, c, d = (P[:-1, :-1].reshape(-1, 3), P[1:, :-1].reshape(-1, 3),
                  P[:-1, 1:].reshape(-1, 3), P[1:, 1:].reshape(-1, 3))
    sc = Scene()
    sc.set_constant_sky((0.5, 0.6, 0.9))
    sc.add_material("m")
    sc.add_mesh(np.concatenate([a, d]), np.concatenate([b, b]),
                np.concatenate([c, c]), 0)
    terrain = sc.build(RenderConfig(max_tris_in_leaf=4), device="cuda")
    small = scenes.BUILDERS[2]().build(device="cuda")
    uv, index = camera.pixel_centers(W, H, "cuda")
    pos, rot = (torch.tensor(v, dtype=torch.float32, device="cuda")
                for v in CAM)
    ifd = torch.tensor(4.0, device="cuda")
    base = RenderConfig(width=W, height=H, samples_per_frame=3,
                        max_bounces=3, blur=0.001)
    for (sc, info), cfg, fold, want in (
            (terrain, base, False, 3),
            (terrain, dataclasses.replace(base, raytracing=False), False, 3),
            (small, dataclasses.replace(base, fused="on"), False, 3),
            (terrain, base, True, 1),
            (terrain, dataclasses.replace(base, legacy_pathtrace=True),
             False, 1)):
        before = bounce.camera_step.launches
        col, q = render_rays(sc, info, uv, index, pos, rot, 5, ifd,
                             config=cfg, fold_spp=fold)
        assert bounce.camera_step.launches - before == want
        assert bool(torch.isfinite(col).all()) and int(q) > 0
