"""Refraction stacks of any depth (the port's fault C4): the port renders
`refraction_stack_depth` 1, 17 and 32 as the JAX package's XLA route
(`render_frame(fused="off", pallas="off")`) renders them, on the forest
terrain and on config 2 (glass, so the stack fills); a depth outside the
frame and block kernels' 2..MAX_STACK leaves them for the per-bounce route;
the bounce kernel's body (g++) equals the plain version at those depths.

Limits: the route limits of PERF.md section 2, RMSE < 0.05 and the queries
equal; the bounce step at the kernel-parity limits of
tests/test_torch_bounce.py. At depth 1 the reference's stack has no second
entry: its index past the one entry clamps to it, and both packages read
the first entry there (csrc/integrate.cuh `path_shade`).
"""
import warnings

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Scene, render_frame, scenes
from pathtracer0_tpu_torch.kernels import bounce, frame, fused
from pathtracer0_tpu_torch.render import integrator
from tests.test_torch_bounce import (BOUNCES, SEEDS, TERRAIN_CAM,
                                     _assert_states, _rays, _terrain, _walk)

torch.set_num_threads(1)

W, H = 8, 6
DEPTHS = (1, 17, 32)
CAMS = {"forest": TERRAIN_CAM, "config2": scenes.CAMERAS[2]}


def _port(name, depth, bounces, fused_mode="off"):
    cfg = RenderConfig(width=W, height=H, samples_per_frame=1,
                       max_bounces=bounces, refraction_stack_depth=depth,
                       auto_focus=False, focal_distance=5.0, blur=0.001,
                       fused=fused_mode, max_tris_in_leaf=4)
    if name == "forest":
        sc, info = _terrain(Scene()).build(cfg, device="cpu")
    else:
        sc, info = scenes.BUILDERS[2]().build(cfg, device="cpu")
    img, q = render_frame(sc, info, cfg, *CAMS[name], int(SEEDS[2]),
                          device="cpu")
    return img.numpy(), int(q)


def _jax(name, depth, bounces):
    import jax.numpy as jnp
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu import scenes as jscenes
    from pathtracer0_tpu.render import renderer as jrenderer

    cfg = JConfig(width=W, height=H, samples_per_frame=1,
                  max_bounces=bounces, refraction_stack_depth=depth,
                  auto_focus=False, focal_distance=5.0, blur=0.001,
                  fused="off", pallas="off", max_tris_in_leaf=4)
    if name == "forest":
        dev, info = _terrain(JScene()).build(cfg)
    else:
        dev, info = jscenes.BUILDERS[2]().build(cfg)
    cam, rot = CAMS[name]
    img, rays = jrenderer.render_frame(
        dev, jnp.asarray(cam, jnp.float32), jnp.asarray(rot, jnp.float32),
        jnp.uint32(SEEDS[2]), info=info, params=jrenderer._frame_params(cfg),
        width=W, height=H, spp=1, raytracing=True, auto_focus=False,
        cam_size=cfg.cam_size, focal_length=cfg.focal_length, blur=cfg.blur,
        focal_distance=cfg.focal_distance)
    return np.asarray(img), int(rays)


@pytest.mark.parametrize("name", ("forest", "config2"))
@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_renders_as_jax(name, depth):
    """The port's per-bounce route at stack depths 1, 17 and 32 against the
    JAX package's XLA route, which takes any depth."""
    bounces = 4 if name == "config2" else 2
    got, q_got = _port(name, depth, bounces)
    want, q_want = _jax(name, depth, bounces)
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(((got - want) ** 2).mean()))
    assert rmse < 0.05, rmse
    assert q_got == q_want
    assert got.std() > 0.02


def test_deep_stack_leaves_the_frame_and_block_kernels():
    """Config 2 at depth 17: no frame path, no block kernel; fused="auto"
    renders through the per-bounce route, bit for bit as fused="off", and
    fused="on" warns and does the same. Depth 16 keeps both."""
    _, info = scenes.BUILDERS[2]().build(device="cpu")
    assert frame.eligible(info, stack_size=16)
    assert fused.eligible(info, stack_size=16)
    for depth in (1, 17, 32):
        assert not frame.eligible(info, stack_size=depth)
        assert not fused.eligible(info, stack_size=depth)
        assert not integrator.takes_block(info, "auto", depth)
    off, q_off = _port("config2", 17, 3)
    auto, q_auto = _port("config2", 17, 3, fused_mode="auto")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        on, q_on = _port("config2", 17, 3, fused_mode="on")
    assert any("outside the block kernel" in str(w.message) for w in caught)
    assert np.array_equal(off, auto) and np.array_equal(off, on)
    assert q_off == q_auto == q_on


@pytest.mark.parametrize("depth", DEPTHS)
def test_bounce_host_matches_plain_at_depth(depth):
    """The bounce kernel's body through g++ against the plain version on
    config 2's glass at stack depths 1, 17 and 32, bounce after bounce."""
    sc, info = scenes.BUILDERS[2]().build(device="cpu")
    cam, rot = CAMS["config2"]
    o, d, alive, state = _rays(cam, rot, SEEDS[0])
    st = bounce.begin(o, d, alive, state, stack_size=depth)
    assert st.stack.shape[0] == depth
    deepest = 0
    for _ in range(BOUNCES):
        walk = _walk(sc, info, st)
        host = st.clone()
        bounce.bounce_step_host(sc, info, host, walk)
        bounce.bounce_step_plain(sc, info, st, walk)
        _assert_states(host, st)
        n_host, n_plain = int(host.alive.sum()), int(st.alive.sum())
        assert abs(n_host - n_plain) <= 0.01 * n_plain + 1
        deepest = max(deepest, int(st.ssize.max()))
        if not n_plain:
            break
    assert deepest >= min(depth, 2)     # the glass pushed its index


@pytest.mark.parametrize("hash_", ("own", "shared"))
@pytest.mark.parametrize("depth", (1, 17))
def test_legacy_pathtrace_at_depth_as_jax(depth, hash_, monkeypatch):
    """The legacy pathTrace (shade/arealights.py) at stack depths 1 and 17
    against the JAX package's, on a glossy glass sphere under a light, as
    tests/test_torch_legacy.py holds it: NaN on the same rays (a drained
    stack), the RNG state equal, the colour within 1e-4 where finite and
    the queries equal. A glossy refraction turns on the location hash,
    fract(sin(s) 47678.786234), where one ulp of the sine is another
    direction; with the hash shared ("shared": one constant in both
    packages) every depth is held so. With each package's own hash, depth
    1 (eta 1 inside the glass, so the paths go elsewhere than at 17) lands
    two glossy rays on points whose sines part by an ulp: 0.0162 apart,
    queries 356 against 352; with the hash shared the colours agree within
    1.2e-10 and the queries (334) are equal. There the rays that followed
    no glossy refraction stay within 1e-4, the glossy ones under the image
    budget (RMSE < 0.05), the queries within 1% + 16."""
    import jax.numpy as jnp
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu.render.renderer import _frame_params
    from pathtracer0_tpu.shade import arealights as jarea
    from pathtracer0_tpu_torch.shade import arealights as tarea
    from tests.test_torch_legacy import (_both, _glass, _rays, _same_state,
                                         _soa, _states)

    if hash_ == "shared":
        monkeypatch.setattr(jarea, "_glsl_rand", lambda v: jnp.full(
            v.shape[:-1], 0.3, jnp.float32))
        monkeypatch.setattr(tarea, "_glsl_rand",
                            lambda v: torch.full_like(v[0], 0.3))
    dev, info, sc, pinfo = _both(_glass)
    o, d = _rays(16, 12)
    js, ts = _states(o.shape[0])
    cj, sj, rj = jarea.path_trace(
        jnp.asarray(o), jnp.asarray(d), js, dev, info,
        _frame_params(JConfig(refraction_stack_depth=depth)), sample_res=0,
        max_bounces=4)
    glossy = torch.zeros(o.shape[0], dtype=torch.bool)
    ct, st, rt = tarea.path_trace(_soa(o), _soa(d), ts, sc, pinfo, 0, 4,
                                  stack_size=depth, glossy=glossy)
    cj, ct = np.asarray(cj), torch.stack(ct, -1).numpy()
    nan = np.isnan(cj).any(-1)
    np.testing.assert_array_equal(np.isnan(ct).any(-1), nan)
    _same_state(sj, st)
    glossy = glossy.numpy()
    assert glossy.any()
    if depth == 1 and hash_ == "own":
        sharp, turned = ~nan & ~glossy, ~nan & glossy
        np.testing.assert_allclose(ct[sharp], cj[sharp], rtol=0, atol=1e-4)
        assert float(np.sqrt(((ct[turned] - cj[turned]) ** 2).mean())) < 0.05
        assert abs(int(rt) - int(float(rj))) <= 0.01 * int(rt) + 16
        return
    np.testing.assert_allclose(ct[~nan], cj[~nan], rtol=0, atol=1e-4)
    assert int(rt) == int(float(rj))
