"""The port's `render_rays(fold_spp=True)` against the JAX package's
`render_rays(params=TraceParams(fold_spp=True, fused="off"))` on the CPU:
the samples folded into the ray axis, sample k of pixel i seeded
i + k * 2654435769 (mod 2^32) + the frame seed.

Tolerances: the seeds and the counted queries equal; the colour within
1e-4 at 16x12x4, path and Whitted mode.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu.core import camera as jcamera
from pathtracer0_tpu.core import rng as jrng
from pathtracer0_tpu.render import renderer as jrenderer
from pathtracer0_tpu.render.integrator import TraceParams
from pathtracer0_tpu_torch import RenderConfig, Scene
from pathtracer0_tpu_torch.core import camera as tcamera
from pathtracer0_tpu_torch.render import renderer as trenderer

from .test_torch_route import _fill, _grid_obj

torch.set_num_threads(1)

W, H, SPP, BOUNCES, SEED = 16, 12, 4, 3, 77
CAM, ROT = (4.2, 3.2, -1.5), (0.55, 0.0, 0.0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fold") / "grid_box.obj")
    _grid_obj(path)
    dev, info = _fill(JScene(), path, False).build(
        JConfig(max_tris_in_leaf=4))
    sc, pinfo = _fill(Scene(), path, False).build(
        RenderConfig(max_tris_in_leaf=4), device="cpu")
    return dev, info, sc, pinfo


def test_folded_seeds_equal_jax():
    """The JAX package's folded streams (its uint32 arithmetic, written
    out) against the port's, for a frame seed that wraps."""
    _, index = jcamera.pixel_centers(W, H)
    stride = jnp.uint32(trenderer.FOLD_STRIDE)
    idx_f = (index[None, :].astype(jnp.uint32)
             + (jnp.arange(SPP, dtype=jnp.uint32) * stride)[:, None]
             ).reshape(-1)
    for seed in (SEED, 4294967000):
        want = np.asarray(jrng.seed(idx_f, jnp.uint32(seed)))
        got = trenderer.fold_seeds(torch.arange(W * H), SPP, seed)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("raytracing", [True, False])
def test_fold_spp_matches_jax(pair, raytracing):
    dev, info, sc, pinfo = pair
    uv, index = jcamera.pixel_centers(W, H)
    params = TraceParams(max_bounces=BOUNCES, fused="off", pallas="off",
                         fold_spp=True, ray_batch_size=0)
    cj, rj = jrenderer.render_rays(
        dev, uv, index, jnp.asarray(CAM, jnp.float32),
        jnp.asarray(ROT, jnp.float32), jnp.uint32(SEED), jnp.float32(6.0),
        info=info, params=params, spp=SPP, raytracing=raytracing,
        cam_size=1.5, focal_length=1.0, screen_h_ratio=H / float(W),
        blur=0.001)
    cfg = RenderConfig(width=W, height=H, samples_per_frame=SPP,
                       max_bounces=BOUNCES, raytracing=raytracing,
                       fused="off", pallas="off", blur=0.001)
    uv_t, index_t = tcamera.pixel_centers(W, H, "cpu")
    ct, rt = trenderer.render_rays(
        sc, pinfo, uv_t, index_t, torch.tensor(CAM), torch.tensor(ROT),
        SEED, torch.tensor(6.0), config=cfg, fold_spp=True)
    ct = ct.numpy()
    assert ct.shape == (W * H, 3) and np.isfinite(ct).all()
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=0, atol=1e-4)
    assert int(rt) == int(float(rj))
    # a different estimator from the sample-by-sample one, of the same
    # picture
    plain, _ = trenderer.render_rays(
        sc, pinfo, uv_t, index_t, torch.tensor(CAM), torch.tensor(ROT),
        SEED, torch.tensor(6.0), config=cfg)
    assert not np.array_equal(plain.numpy(), ct) or not raytracing
    assert abs(float(plain.mean()) - float(ct.mean())) < 0.05


def test_fold_chunks_as_one_batch(pair):
    """ray_batch_size splits the pixels before the fold: the same colour
    as one batch, and spp = 1 is the unfolded frame."""
    _, _, sc, pinfo = pair
    uv, index = tcamera.pixel_centers(W, H, "cpu")
    args = (sc, pinfo, uv, index, torch.tensor(CAM), torch.tensor(ROT), SEED,
            torch.tensor(6.0))
    kw = dict(width=W, height=H, samples_per_frame=SPP, max_bounces=BOUNCES,
              fused="off")
    whole, q1 = trenderer.render_rays(
        *args, config=RenderConfig(ray_batch_size=0, **kw), fold_spp=True)
    chunked, q2 = trenderer.render_rays(
        *args, config=RenderConfig(ray_batch_size=50, **kw), fold_spp=True)
    assert torch.equal(whole, chunked) and int(q1) == int(q2)
    one = dict(kw, samples_per_frame=1)
    a, _ = trenderer.render_rays(*args, config=RenderConfig(**one),
                                 fold_spp=True)
    b, _ = trenderer.render_rays(*args, config=RenderConfig(**one))
    assert torch.equal(a, b)
