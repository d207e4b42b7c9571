"""The port's whole-frame path (pathtracer0_tpu_torch.kernels.frame) against
the JAX package's `render_fused_frame(..., interpret=True)`, the Pallas
frame kernel run in interpret mode, on identical geometry carried across
with scene_from_numpy.

Tolerances are those of tests/test_fused.py: RNG state (here: the image
through it) equal except on knife-edge pixels, where a one-ulp difference
in a transcendental flips a comparison and the path diverges:
  per-pixel max-abs radiance difference < 1e-4 on >= 99% of pixels,
  mean abs difference < 5e-3, ray count within 1% + 16.
Whitted frames (config 1) compare sky-lit pixels at 1e-3 instead: the
TPU kernel samples the sky with polynomial atan2/asin (|err| <= 6.8e-5
rad, fused.py:266-296), the port with atan2f/asinf.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import scenes as jscenes
from pathtracer0_tpu.kernels import fused
from pathtracer0_tpu.render.integrator import TraceParams
from pathtracer0_tpu_torch import scenes as tscenes
from pathtracer0_tpu_torch.core import rng as trng
from pathtracer0_tpu_torch.kernels import frame as tframe
from pathtracer0_tpu_torch.scene.packing import scene_from_numpy

torch.set_num_threads(1)

W, H, SPP, BOUNCES, SEED, IFD, BLUR = 40, 30, 2, 4, 777, 3.0, 0.001
FS_FIELDS = ("fs_tris", "fs_attr", "fs_uvt", "fs_maps", "fs_sky",
             "materials", "ell_tab", "imp_tab", "tex_data", "tex_sizes")


def _pair(n):
    dev, info = jscenes.BUILDERS[n]().build(max_leaf=4)
    sc, pinfo = scene_from_numpy(
        {k: np.asarray(getattr(dev, k)) for k in FS_FIELDS}, info._asdict(),
        device="cpu")
    return dev, info, sc, pinfo


def _sky_lit(sc, info, cam, rot):
    """Pixels whose primary ray misses the scene in some sample."""
    from pathtracer0_tpu_torch.core import math as tmath
    from pathtracer0_tpu_torch.render import integrator

    rotmat = tmath.rotation_matrix(torch.tensor(rot, dtype=torch.float32))
    state = trng.seed(torch.arange(W * H), SEED)
    alive = torch.ones(W * H, dtype=torch.bool)
    lit = torch.zeros(W * H, dtype=torch.bool)
    for _ in range(SPP):
        o, d, state = tframe._raygen(
            torch.tensor(cam, dtype=torch.float32), rotmat, torch.tensor(IFD),
            state, W, H, cam_size=1.5, focal_length=1.0, blur=BLUR)
        on = tuple(o[i] + integrator.NUDGE * d[i] for i in range(3))
        lit |= ~integrator.closest_hit(sc, info, on, d, alive).is_hit
    return lit.numpy()


@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_frame_matches_jax_interpret(n):
    whitted = n == 1
    dev, info, sc, pinfo = _pair(n)
    cam, rot = jscenes.CAMERAS[n]
    col_j, rays_j = fused.render_fused_frame(
        dev, info, TraceParams(max_bounces=BOUNCES),
        jnp.asarray(cam, jnp.float32), jnp.asarray(rot, jnp.float32), SEED,
        jnp.float32(IFD), width=W, height=H, spp=SPP, cam_size=1.5,
        focal_length=1.0, blur=BLUR, whitted=whitted, interpret=True)
    col_t, rays_t = tframe.render_fused_frame(
        sc, pinfo, torch.tensor(cam, dtype=torch.float32),
        torch.tensor(rot, dtype=torch.float32), SEED, torch.tensor(IFD),
        width=W, height=H, spp=SPP, max_bounces=BOUNCES, blur=BLUR,
        whitted=whitted)
    a, b = np.asarray(col_j), col_t.numpy()
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    if whitted:
        # sky-lit pixels: polynomial vs libm atan2/asin (module docstring)
        sky_lit = _sky_lit(sc, pinfo, cam, rot)
        diff = np.where(sky_lit & (diff < 1e-3), 0.0, diff)
        assert 0.05 < sky_lit.mean() < 0.95
    assert (diff < 1e-4).mean() >= 0.99, diff.max()
    assert np.abs(a - b).mean() < 5e-3
    assert abs(float(rays_j) - int(rays_t)) <= 0.01 * float(rays_j) + 16


@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_autofocus_matches_jax(n):
    from pathtracer0_tpu.config import RenderConfig
    from pathtracer0_tpu.render.renderer import (_frame_params,
                                                 autofocus_distance)
    from pathtracer0_tpu_torch.render.renderer import autofocus_distance \
        as t_autofocus

    dev, info, sc, pinfo = _pair(n)
    cam, rot = jscenes.CAMERAS[n]
    ref = autofocus_distance(
        dev, jnp.asarray(cam, jnp.float32), jnp.asarray(rot, jnp.float32),
        1.0, info=info, params=_frame_params(RenderConfig()),
        auto_focus=True)
    ours = t_autofocus(sc, pinfo, torch.tensor(cam), torch.tensor(rot), 1.0,
                       True)
    assert abs(float(ours) - float(ref)) <= 1e-5 * float(ref)


def test_frame_rng_state_carried():
    """The state after a frame is the per-pixel stream advanced by every
    draw of every sample: two 1-sample frames chained equal one 2-sample
    frame, radiance and state alike."""
    sc, info = tscenes.BUILDERS[2]().build(device="cpu")
    cam, rot = (torch.tensor(v, dtype=torch.float32)
                for v in tscenes.CAMERAS[2])
    state = trng.seed(torch.arange(24 * 16), 99)
    kw = dict(width=24, height=16, max_bounces=3, blur=BLUR)
    ifd = torch.tensor(IFD)
    r2, s2, q2 = tframe.trace_frame(sc, info, cam, rot, ifd, state, spp=2,
                                    **kw)
    ra, sa, qa = tframe.trace_frame(sc, info, cam, rot, ifd, state, spp=1,
                                    **kw)
    rb, sb, qb = tframe.trace_frame(sc, info, cam, rot, ifd, sa, spp=1,
                                    **kw)
    torch.testing.assert_close(r2, ra + rb, rtol=0, atol=1e-6)
    assert torch.equal(s2, sb)
    assert int(q2) == int(qa) + int(qb)


def test_cpu_wrapper_uses_plain_version():
    """On CPU tensors trace_frame runs the plain version and counts no
    kernel launch; a device without a kernel raises."""
    sc, info = tscenes.BUILDERS[6]().build(device="cpu")
    cam, rot = (torch.tensor(v, dtype=torch.float32)
                for v in tscenes.CAMERAS[6])
    state = trng.seed(torch.arange(8 * 6), 5)
    before = tframe.trace_frame.launches
    kw = dict(width=8, height=6, spp=1, max_bounces=2)
    out = tframe.trace_frame(sc, info, cam, rot, torch.tensor(IFD), state,
                             **kw)
    ref = tframe.trace_frame_reference(sc, info, cam, rot,
                                       torch.tensor(IFD), state, **kw)
    assert tframe.trace_frame.launches == before
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tframe.trace_frame(sc, info, cam, rot, torch.tensor(IFD),
                           state.to("meta"), **kw)


@pytest.mark.parametrize("check", ["lane_use", "phase_cycles"])
def test_check_instantiations_measure_the_card(check):
    """The check-only instantiations (lanes of a bounce step, cycles by part
    of a scene query) are measurements of the card: they have no plain
    version and refuse CPU tensors; lane_use refuses Whitted mode."""
    sc, info = tscenes.BUILDERS[2]().build(device="cpu")
    cam, rot = (torch.tensor(v, dtype=torch.float32)
                for v in tscenes.CAMERAS[2])
    state = trng.seed(torch.arange(8 * 6), 5)
    with pytest.raises(ValueError, match="card"):
        getattr(tframe, check)(sc, info, cam, rot, torch.tensor(IFD), state,
                               width=8, height=6, spp=1, max_bounces=2,
                               refill=False)
    assert tframe.PHASES[-1] == "warp" and len(set(tframe.PHASES)) == 7


RW, RH, RSPP = 32, 16, 4


@pytest.mark.parametrize("n", [2, 4, 6])
def test_refill_frame_matches_jax_refill(n, monkeypatch):
    """PT0_FUSED_REFILL=1 on both sides: the port's Renderer (its frame
    path, on the CPU the plain version, whose function the refill schedule
    does not change) against the JAX frame through the refill schedule of
    the Pallas kernel in interpret mode, with depth of field on, at the
    module's tolerances."""
    from pathtracer0_tpu_torch import RenderConfig, Renderer

    monkeypatch.setenv("PT0_FUSED_REFILL", "1")
    dev, info, sc, pinfo = _pair(n)
    cam, rot = jscenes.CAMERAS[n]
    col_j, rays_j = fused.render_fused_frame(
        dev, info, TraceParams(max_bounces=BOUNCES),
        jnp.asarray(cam, jnp.float32), jnp.asarray(rot, jnp.float32), SEED,
        jnp.float32(IFD), width=RW, height=RH, spp=RSPP, cam_size=1.5,
        focal_length=1.0, blur=BLUR, interpret=True)
    cfg = RenderConfig(width=RW, height=RH, samples_per_frame=RSPP,
                       max_bounces=BOUNCES, blur=BLUR, auto_focus=False,
                       focal_distance=IFD)
    before = (tframe.trace_frame.launches, tframe.trace_frame.refill_launches)
    r = Renderer(sc, pinfo, cfg, cam_pos=cam, cam_rot=rot, device="cpu")
    img = r.step(frame_seed=SEED)
    assert (tframe.trace_frame.launches,
            tframe.trace_frame.refill_launches) == before
    a, b = np.asarray(col_j), img.reshape(-1, 3).numpy()
    assert np.isfinite(b).all()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, diff.max()
    assert np.abs(a - b).mean() < 5e-3
    assert abs(float(rays_j) - r.rays_traced) <= 0.01 * float(rays_j) + 16


@pytest.mark.parametrize("whitted, spp, taken", [
    (False, 4, True), (False, 2, True), (False, 1, False), (True, 4, False)])
def test_refill_only_in_path_mode_from_two_samples(whitted, spp, taken,
                                                   monkeypatch):
    """As fused.py:1772-1774: refill in path mode with two samples or more,
    ignored in Whitted mode and at one sample, where the frame is the
    default schedule's whatever PT0_FUSED_REFILL says."""
    assert tframe.use_refill(True, whitted, spp) is taken
    assert tframe.use_refill(False, whitted, spp) is False
    sc, info = tscenes.BUILDERS[2]().build(device="cpu")
    cam, rot = (torch.tensor(v, dtype=torch.float32)
                for v in tscenes.CAMERAS[2])
    kw = dict(width=8, height=6, spp=spp, max_bounces=3, blur=BLUR,
              whitted=whitted)
    frames = []
    for env in ("0", "1"):
        monkeypatch.setenv("PT0_FUSED_REFILL", env)
        frames.append(tframe.render_fused_frame(
            sc, info, cam, rot, 3, torch.tensor(IFD), **kw))
    for x, y in zip(*frames):
        assert torch.equal(x, y)
