"""brute_kernel's division-free pre-reject and its triangle test
(csrc/tri_divide.cuh, built by g++ through kernels/build.py and loaded
with ctypes) against the plain version kernels/intersect.py `tri_divide`,
on the CPU.

The pre-reject may only drop pairs that the dividing test rejects: its
answer is checked against u = un * (1 / det) computed in float32 on
adversarial (un, det) pairs (u and v at 0 and 1, det at +-1e-10, u
underflowing to -0.0, inf and NaN), and the whole test, with and without
it, must equal `tri_divide` bit for bit on seeded and adversarial rays
and triangles.
"""
import ctypes

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch.kernels import build, intersect

EPS = np.float32(1e-10)
F32 = np.float32


@pytest.fixture(scope="module")
def lib():
    return build.load("tri_divide")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _rejected(lib, un, det):
    un, det = (np.ascontiguousarray(x, F32) for x in (un, det))
    out = np.zeros(un.shape, np.uint8)
    lib.pt_surely_rejected.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
    lib.pt_surely_rejected(_ptr(un), _ptr(det), un.size, _ptr(out))
    return out.astype(bool)


def _u_passes(un, det):
    """Where the dividing test's first clauses hold: |det| >= 1e-10 and
    0 <= u <= 1 with u = un * (1 / det) in float32."""
    un, det = torch.tensor(un, dtype=torch.float32), torch.tensor(
        det, dtype=torch.float32)
    u = un * (1.0 / det)
    return ((det.abs() >= float(EPS)) & (u >= 0.0) & (u <= 1.0)).numpy()


def _adversarial_pairs():
    big = F32(3e38)
    tiny = np.finfo(F32).tiny
    dets = [EPS, np.nextafter(EPS, F32(0)), np.nextafter(EPS, F32(1)),
            F32(1e-9), F32(1.0), F32(0.75), F32(2.0 ** 20), F32(2.0 ** 126),
            F32(2.0 ** 127), big, np.finfo(F32).max, F32(0.0), F32(5e-11),
            F32(np.inf), F32(np.nan)]
    dets = dets + [-x for x in dets]
    pairs = []
    for det in dets:
        a = abs(det)
        uns = [F32(0.0), F32(-0.0), F32(np.inf), F32(-np.inf), F32(np.nan),
               tiny, -tiny, F32(1e-45), F32(-1e-45), F32(-1e-30), F32(1e-30)]
        if np.isfinite(a):
            with np.errstate(over="ignore", under="ignore"):
                for scale in (1.0, 1 + 2.0 ** -23, 1 - 2.0 ** -24,
                              1 + 2.0 ** -21, 1 + 2.0 ** -20,
                              1 + 2.0 ** -19, 2.0, 0.5, 2.0 ** -100,
                              2.0 ** -99, 2.0 ** -101, 2.0 ** -126,
                              2.0 ** -140, 1e-30):
                    x = F32(a * F32(scale))
                    for y in (x, np.nextafter(x, F32(np.inf)),
                              np.nextafter(x, F32(0))):
                        uns += [y, -y]
        for un in uns:
            sign = F32(-1.0) if np.signbit(det) else F32(1.0)
            pairs.append((F32(un) * sign, det))
    un, det = np.array(pairs, F32).T
    return un, det


def test_pre_reject_only_drops_what_the_division_rejects(lib):
    un, det = _adversarial_pairs()
    rej = _rejected(lib, un, det)
    passes = _u_passes(un, det)
    assert not (rej & passes).any(), list(zip(un[rej & passes],
                                              det[rej & passes]))
    # it does decide: the first clause exactly, and clear misses
    assert rej[~(np.abs(det) >= EPS)].all()
    sure = (np.abs(det) >= EPS) & (np.abs(det) < 1e30)
    with np.errstate(invalid="ignore", over="ignore"):
        uc = un * np.sign(det)
        for clear in (uc == -np.abs(det), uc == 2 * np.abs(det)):
            assert (sure & clear).sum() > 10 and rej[sure & clear].all()
    # u underflowing to -0.0 passes u >= 0: never dropped
    with np.errstate(under="ignore"):
        dets = np.array([3e38, -3e38, 1e20, 2.0 ** 126], F32)
        uns = -np.sign(dets).astype(F32) * np.array([1e-30, 1e-30, 1e-45,
                                                     1e-45], F32)
    assert _u_passes(uns, dets).all()
    assert not _rejected(lib, uns, dets).any()


def test_pre_reject_on_seeded_pairs(lib):
    """Pairs drawn around the edges of the accepted range: u at 0 and 1
    within a few ulps, det over 60 binary orders of magnitude."""
    rng = np.random.RandomState(0)
    n = 200000
    det = (rng.choice([-1, 1], n) * 2.0 ** rng.uniform(-40, 40, n)).astype(F32)
    u = np.concatenate([rng.uniform(-1e-6, 1e-6, n // 4),
                        1 + rng.uniform(-1e-6, 1e-6, n // 4),
                        rng.uniform(-2, 3, n // 2)])
    un = (u * det).astype(F32)
    steps = rng.randint(-3, 4, n)
    un = np.array([np.nextafter(x, F32(np.inf) if s > 0 else F32(-np.inf))
                   if s else x for x, s in zip(un[:2000], steps[:2000])]
                  + list(un[2000:]), F32)
    rej = _rejected(lib, un, det)
    passes = _u_passes(un, det)
    assert not (rej & passes).any()
    assert rej.mean() > 0.3


def _test_pairs(lib, rays, tris, pre):
    n = rays.shape[0]
    ok = np.zeros(n, np.uint8)
    t, u, v = (np.full(n, -7.0, F32) for _ in range(3))
    lib.pt_tri_divide.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    lib.pt_tri_divide(_ptr(np.ascontiguousarray(rays, F32)),
                      _ptr(np.ascontiguousarray(tris, F32)), n, int(pre),
                      _ptr(ok), _ptr(t), _ptr(u), _ptr(v))
    return ok.astype(bool), t, u, v


def _rays_and_rows(n, seed):
    """Rays aimed near the triangles' edges and corners, degenerate and
    tiny triangles, and NaN and inf entries."""
    rng = np.random.RandomState(seed)
    v1 = rng.randn(n, 3)
    e1 = rng.randn(n, 3) * 10.0 ** rng.uniform(-6, 2, (n, 1))
    e2 = rng.randn(n, 3) * 10.0 ** rng.uniform(-6, 2, (n, 1))
    e2[::13] = e1[::13] * 3.0                  # degenerate: det 0
    e2[5::17] = e1[5::17] * (1.0 + 1e-7)       # nearly so
    # target points at barycentrics on and around the edges
    bu = rng.choice([0.0, 1.0, 0.5, 1e-8, -1e-8, 1 + 1e-7], n)
    bv = rng.choice([0.0, 1e-8, -1e-8, 0.3], n) * (1 - np.abs(bu))
    target = v1 + bu[:, None] * e1 + bv[:, None] * e2
    o = target + rng.randn(n, 3) * 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::29, 0] = 0.0
    rays = np.concatenate([o, d], 1).astype(F32)
    tris = np.concatenate([v1, e1, e2], 1).astype(F32)
    tris[3::101, 4] = np.nan
    tris[7::103, 0] = np.inf
    rays[11::107, 1] = np.nan
    return rays, tris


@pytest.mark.parametrize("seed", [0, 1])
def test_row_test_matches_tri_divide(lib, seed):
    """brute_kernel's test with the pre-reject, the walk's without, and
    the plain tri_divide: the same pairs pass, with the same t, u, v."""
    rays, tris = _rays_and_rows(40000, seed)
    ok_pre, t_pre, u_pre, v_pre = _test_pairs(lib, rays, tris, True)
    ok, t, u, v = _test_pairs(lib, rays, tris, False)
    assert np.array_equal(ok_pre, ok)
    for a, b in ((t_pre, t), (u_pre, u), (v_pre, v)):
        assert np.array_equal(a[ok], b[ok])
    col = [torch.tensor(c) for c in np.concatenate([rays, tris], 1).T]
    okp, tp, up, vp = intersect.tri_divide(col[0:3], col[3:6], col[6:9],
                                           col[9:12], col[12:15])
    okp = okp.numpy()
    assert np.array_equal(ok, okp)
    for a, b in ((t, tp), (u, up), (v, vp)):
        assert np.array_equal(a[ok], b.numpy()[ok])
    assert 0.05 < ok.mean() < 0.95
