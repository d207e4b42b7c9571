"""The block kernel's dense triangle loop with its early exit and staged
rows (csrc/pathtrace.cuh `dense_closest`, built by g++ through kernels/build.py
and loaded with ctypes) against the plain version, kernels/intersect.py
`tri_candidate` with the closest-so-far rule (the first row in table order
at the least t, compared as tc * td < tn * adet), on the CPU, bit for bit.

The early exit skips a row once det and u's numerator show that the ray
cannot accept it (adet >= 1e-10, 0 <= uc <= adet). It may only skip rows
the full test rejects; the rays here land on the edges where a stricter
guard would skip a row the test accepts: u and v at exactly 0 and 1, u + v
at exactly 1, det at exactly +-1e-10 and one ulp either side, and NaN and
inf entries.
"""
import ctypes

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch.kernels import build, intersect

F32 = np.float32
EPS = F32(1e-10)
MISS = F32(1e30)


@pytest.fixture(scope="module")
def lib():
    lib = build.load("dense_hit")
    lib.pt_dense_closest.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int] + [ctypes.c_void_p] * 5
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _kernel(lib, tris, rays, n_staged=0):
    """The block kernel's loop over `tris`, its first `n_staged` rows read
    as it stages them."""
    tris, rays = (np.ascontiguousarray(x, F32) for x in (tris, rays))
    n = rays.shape[0]
    hid = np.zeros(n, np.int32)
    tn, td, un, vn = (np.zeros(n, F32) for _ in range(4))
    lib.pt_dense_closest(_ptr(tris), tris.shape[0], min(n_staged, len(tris)),
                         _ptr(rays), n, _ptr(hid), _ptr(tn), _ptr(td),
                         _ptr(un), _ptr(vn))
    return hid, tn, td, un, vn


def _plain(tris, rays):
    """tri_candidate over every (ray, row) pair, then the rows in order:
    accept where ok and tc * td < tn * adet."""
    r = [torch.tensor(c)[:, None] for c in np.asarray(rays, F32).T]
    t = [torch.tensor(c)[None, :] for c in np.asarray(tris, F32).T]
    ok, tc, adet, uc, vc = intersect.tri_candidate(r[0:3], r[3:6], t[0:3],
                                                   t[3:6], t[6:9])
    n = rays.shape[0]
    hid = torch.full((n,), -1, dtype=torch.int32)
    tn = torch.full((n,), float(MISS))
    td, un, vn = torch.ones(n), torch.zeros(n), torch.zeros(n)
    for k in range(tris.shape[0]):
        acc = ok[:, k] & (tc[:, k] * td < tn * adet[:, k])
        hid = torch.where(acc, k, hid)
        tn = torch.where(acc, tc[:, k], tn)
        td = torch.where(acc, adet[:, k], td)
        un = torch.where(acc, uc[:, k], un)
        vn = torch.where(acc, vc[:, k], vn)
    return tuple(x.numpy() for x in (hid, tn, td, un, vn))


def _assert_same(got, want):
    for name, a, b in zip(("hid", "tn", "td", "un", "vn"), got, want):
        assert np.array_equal(a, b, equal_nan=True), (
            name, np.flatnonzero(~((a == b) | (np.isnan(a) & np.isnan(b)))
                                 )[:10])


def _seeded(seed, n_tris, n_rays):
    """A table of small triangles, some degenerate or nearly so, and rays
    aimed at their edges and corners, a few with NaN or inf entries."""
    rng = np.random.RandomState(seed)
    v1 = rng.randn(n_tris, 3) * 3.0
    e1 = rng.randn(n_tris, 3) * 10.0 ** rng.uniform(-4, 0.5, (n_tris, 1))
    e2 = rng.randn(n_tris, 3) * 10.0 ** rng.uniform(-4, 0.5, (n_tris, 1))
    e2[::11] = e1[::11] * 2.0
    e2[3::13] = e1[3::13] * (1.0 + 1e-7)
    tris = np.concatenate([v1, e1, e2], 1).astype(F32)
    tris[5::29, 4] = np.nan
    tris[7::31, 0] = np.inf
    k = rng.randint(0, n_tris, n_rays)
    bu = rng.choice([0.0, 1.0, 0.5, 1e-8, -1e-8, 1 + 1e-7, 0.3], n_rays)
    bv = rng.choice([0.0, 1e-8, -1e-8, 0.3, 1.0], n_rays) * (1 - np.abs(bu))
    target = v1[k] + bu[:, None] * e1[k] + bv[:, None] * e2[k]
    o = target + rng.randn(n_rays, 3) * 4.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::37, 1] = 0.0
    rays = np.concatenate([o, d], 1).astype(F32)
    rays[17::97, 2] = np.nan
    rays[19::101, 4] = np.inf
    return tris, rays


def _exact():
    """Rows and rays whose u, v and det come out exact in float32: a row
    in the plane z = z0 with e1 = (a, 0, 0), e2 = (0, b, 0), a ray along
    +-z from (x, y, -1), so det = -+a b, u = x / a and v = y / b exactly
    (dyadic a, b, x, y). The rays sit at u and v of 0, 1 and one ulp
    either side, on u + v = 1, and det runs through +-1e-10, one ulp either
    side, 0, inf and NaN."""
    rows, rays = [], []
    one_m, one_p = F32(1) - F32(2.0 ** -24), F32(1) + F32(2.0 ** -23)
    tiny = F32(2.0 ** -140)
    coords = [F32(0.0), F32(-0.0), tiny, -tiny, F32(0.5), F32(0.25),
              F32(0.75), one_m, F32(1.0), one_p, F32(-2.0 ** -24)]
    pairs = [(x, y) for x in coords for y in coords]
    pairs += [(F32(0.5) + F32(2.0 ** -k), F32(0.5) - F32(2.0 ** -k))
              for k in range(2, 25)]
    pairs += [(F32(np.nan), F32(0.5)), (F32(0.5), F32(np.inf))]
    dets = [F32(1.0), F32(2.0 ** 10), F32(2.0 ** -20), EPS,
            np.nextafter(EPS, F32(1)), np.nextafter(EPS, F32(0)),
            F32(0.0), F32(np.inf), F32(np.nan)]
    for k, det in enumerate(dets):
        for sign in (F32(1.0), F32(-1.0)):
            # e1 = (det, 0, 0) and e2 = (0, 1, 0): det of a ray along
            # (0, 0, s) is -s det, u = x / det exactly; rows stacked in z
            z0 = F32(0.25 * (len(rows) % 7))
            rows.append([0.0, 0.0, z0, det, 0.0, 0.0, 0.0, 1.0, 0.0])
            for x, y in pairs:
                with np.errstate(invalid="ignore", over="ignore"):
                    xo = F32(x * det) if np.isfinite(det) else x
                rays.append([xo, y, z0 - sign * F32(1.0), 0.0, 0.0, sign])
    return np.array(rows, F32), np.array(rays, F32)


@pytest.mark.parametrize("seed,n_staged", [(0, 0), (1, 40), (2, 96),
                                           (3, 17)])
def test_dense_loop_matches_tri_candidate(lib, seed, n_staged):
    """Seeded rows, none, some or all of them staged."""
    tris, rays = _seeded(seed, 96, 6000)
    got = _kernel(lib, tris, rays, n_staged)
    _assert_same(got, _plain(tris, rays))
    hit = got[0] >= 0
    assert 0.1 < hit.mean() < 0.95


def test_dense_loop_on_exact_edges(lib):
    """Each exact row alone (so every ray meets its own row first) and all
    of them as one table: the kernel's loop equals the plain version, and
    the edge cases do occur: rays accepted with u or v exactly 0 or 1 and
    with u + v exactly 1, where u <= 1 holds with equality."""
    tris, rays = _exact()
    per_row = len(rays) // len(tris)
    for k in range(len(tris)):
        sub = rays[k * per_row:(k + 1) * per_row]
        got = _kernel(lib, tris[k:k + 1], sub)
        want = _plain(tris[k:k + 1], sub)
        _assert_same(got, want)
    for n_staged in (0, 7, len(tris)):
        _assert_same(_kernel(lib, tris, rays, n_staged), _plain(tris, rays))
    hid, tn, td, un, vn = _kernel(lib, tris[:1], rays[:per_row])
    hit = hid >= 0
    assert (hit & (un == td) & (vn == 0)).any()       # u = 1
    assert (hit & (un == 0) & (vn == td)).any()       # v = 1
    assert (hit & (un == 0) & (vn == 0)).any()        # the corner v1
    assert (hit & (un != 0) & (vn != 0) & (un + vn == td)).any()
    # |det| exactly 1e-10 accepted, one ulp below refused
    k_eps = 2 * 3
    assert (_kernel(lib, tris[k_eps:k_eps + 1],
                    rays[k_eps * per_row:(k_eps + 1) * per_row])[0]
            >= 0).any()
    k_below = 2 * 5
    assert not (_kernel(lib, tris[k_below:k_below + 1],
                        rays[k_below * per_row:(k_below + 1) * per_row])[0]
                >= 0).any()
