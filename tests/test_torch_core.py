"""Port core (pathtracer0_tpu_torch.core) against the JAX package and the
scalar GLSL oracle: RNG draw for draw, rotations and camera rays to 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pathtracer0_tpu.core import camera as jcam
from pathtracer0_tpu.core import math as jmath
from pathtracer0_tpu.core import rng as jrng
from pathtracer0_tpu_torch.core import camera as tcam
from pathtracer0_tpu_torch.core import math as tmath
from pathtracer0_tpu_torch.core import rng as trng

from . import glsl_ref

torch.set_num_threads(1)


def _states(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 2, 6, 7, 8, 1000])
def test_advance_matches_jax(n):
    s = _states()
    ours = trng.advance(_t(s), n).numpy()
    ref = np.asarray(jrng.advance(jnp.asarray(s), n)).astype(np.int64)
    np.testing.assert_array_equal(ours, ref)


def test_uniform_stream_bit_exact():
    """Eight draws per lane: bits and float32 uniforms equal to the JAX
    package, uniforms equal to the float64 GLSL oracle to float32."""
    s = _states(512, 1)
    st_t, st_j = _t(s), jnp.asarray(s)
    for _ in range(8):
        u_t, st_t = trng.uniform(st_t)
        u_j, st_j = jrng.uniform(st_j)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_array_equal(st_t.numpy(),
                                      np.asarray(st_j).astype(np.int64))
    st = _t(s[:16])
    for k in range(8):
        u, st = trng.uniform(st)
        for lane in range(16):
            ref_state = int(s[lane])
            for _ in range(k + 1):
                ref, ref_state = glsl_ref.random(ref_state)
            assert abs(float(u[lane]) - ref) < 2e-7


def test_seed_wraps_and_peek_equals_draw():
    idx = np.arange(1000, dtype=np.uint32) * 977
    seeded = trng.seed(torch.from_numpy(idx.astype(np.int64)), 2 ** 32 - 5)
    ref = np.asarray(jrng.seed(jnp.asarray(idx), np.uint32(2 ** 32 - 5)))
    np.testing.assert_array_equal(seeded.numpy(), ref.astype(np.int64))
    st = seeded
    for off in range(1, 9):
        u, st = trng.uniform(st)
        np.testing.assert_array_equal(
            u.numpy(), trng.peek_uniform(seeded, off).numpy())


def test_advance_select_and_lambertian():
    s = _states(256, 2)
    counts = np.arange(256) % 9
    ours = trng.advance_select(_t(s), torch.from_numpy(counts), 8).numpy()
    ref = np.asarray(jrng.advance_select(jnp.asarray(s), jnp.asarray(counts),
                                         8)).astype(np.int64)
    np.testing.assert_array_equal(ours, ref)
    v_t, st_t = trng.lambertian_vec(_t(s))
    v_j, st_j = jrng.lambertian_vec(jnp.asarray(s))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(st_t.numpy(),
                                  np.asarray(st_j).astype(np.int64))
    np.testing.assert_array_equal(
        trng.peek_lambertian_vec(_t(s), 0).numpy(), v_t.numpy())


def test_rotation_and_rotate():
    rs = np.random.RandomState(3)
    rot = rs.uniform(-3, 3, (64, 3)).astype(np.float32)
    p = rs.randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(
        tmath.rotation_matrix(torch.from_numpy(rot)).numpy(),
        np.asarray(jmath.rotation_matrix(jnp.asarray(rot))), atol=1e-6)
    np.testing.assert_allclose(
        tmath.rotate(torch.from_numpy(p), torch.from_numpy(rot)).numpy(),
        np.asarray(jmath.rotate(jnp.asarray(p), jnp.asarray(rot))),
        atol=1e-6)
    back = tmath.rotate_back(
        tmath.rotate(torch.from_numpy(p), torch.from_numpy(rot)),
        torch.from_numpy(rot))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-5)


def test_primary_directions_and_dof():
    """The frame path's raygen (rotation as a matrix) against the JAX
    camera (rotation as Euler angles)."""
    W, H = 13, 7
    uv_t, idx_t = tcam.pixel_centers(W, H, "cpu")
    uv_j, idx_j = jcam.pixel_centers(W, H)
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(idx_t.numpy(),
                                  np.asarray(idx_j).astype(np.int64))
    rot = np.array([0.1, -0.3, 0.05], np.float32)
    rotmat = tmath.rotation_matrix(torch.from_numpy(rot))
    d_t = tcam.primary_directions(uv_t, rotmat, 1.5, 1.0, H / W)
    d_j = jcam.primary_directions(uv_j, jnp.asarray(rot), 1.5, 1.0, H / W)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    org = np.array([0.2, 0.5, -1.0], np.float32)
    s = _states(W * H, 4)
    for blur in (0.05, 0.0):
        o_t, dd_t, st_t = tcam.dof_ray(torch.from_numpy(org), d_t, rotmat,
                                       blur, torch.tensor(3.0), _t(s))
        o_j, dd_j, st_j = jcam.dof_ray(
            jnp.asarray(np.tile(org, (W * H, 1))), d_j, jnp.asarray(rot),
            jnp.float32(blur), jnp.full(W * H, 3.0, jnp.float32),
            jnp.asarray(s))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6)
        np.testing.assert_allclose(dd_t.numpy(), np.asarray(dd_j),
                                   atol=1e-6)
        np.testing.assert_array_equal(st_t.numpy(),
                                      np.asarray(st_j).astype(np.int64))
    np.testing.assert_allclose(
        tcam.center_probe_direction(torch.from_numpy(rot)).numpy(),
        np.asarray(jcam.center_probe_direction(jnp.asarray(rot))),
        atol=1e-6)
