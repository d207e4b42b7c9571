"""The group-test kernels' per-ray code (csrc/group_test.cuh, the product
forms' candidate test, and csrc/tri_free.cuh `group`, vpu_kernel's group
loop), built by g++ through kernels/build.py and loaded with ctypes,
against the plain versions of kernels/mxu_group.py on the CPU; and
mxu_kernel's B operand, kernels/mxu_tri.py `frag_image`.

The candidate test must equal `_commit` bit for bit (NaN equal to NaN) on
seeded products with adversarial entries: D at +-1e-10, +-0.0 and
subnormal, t within a few ulps of 1e-10 and of the limit, the limit at BIG
and at inf, NaN and inf in each quantity (a NaN fails the sign test, as in
the JAX reference).
"""
import ctypes

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch.kernels import build, mxu_group, mxu_tri

EPS = np.float32(1e-10)
BIG = np.float32(1e33)
F32 = np.float32
QP = mxu_tri.QUANT_PAD


@pytest.fixture(scope="module")
def lib():
    return build.load("group_test")


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _commit_host(lib, cand, g, form, best):
    t, u, v, idx = (np.ascontiguousarray(x.numpy()).copy() for x in best)
    cand = np.ascontiguousarray(cand.numpy(), F32)
    lib.pt_group_commit.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 4
    lib.pt_group_commit.restype = None
    lib.pt_group_commit(_ptr(cand), cand.shape[1], g, form, _ptr(t),
                        _ptr(u), _ptr(v), _ptr(idx))
    return t, u, v, idx


def _products(seed, n_rays):
    """(320, R) products of one group: the 56 candidates of each ray share a
    sign pattern often enough to pass the sign test, with t spread around
    the rays' limits; then adversarial entries: D at +-1e-10, +-0.0 and
    subnormal, t within a few ulps of 1e-10 and of the limit, NaN and inf in
    each quantity."""
    rng = np.random.RandomState(seed)
    cand = np.zeros((320, n_rays), F32)
    D = rng.choice([-1.0, 1.0], (56, n_rays)) * 2.0 ** rng.uniform(
        -20, 10, (56, n_rays))
    frac = rng.uniform(-0.2, 1.1, (3, 56, n_rays))
    U, V = D * frac[0], D * frac[1] * (1 - frac[0])
    W = D - U - V
    t = 2.0 ** rng.uniform(-36, 8, (56, n_rays)) * rng.choice(
        [1.0, 1.0, 1.0, -1.0], (56, n_rays))
    Tn = t * D
    for q, x in enumerate((D, U, V, W, Tn)):
        cand[q * QP:q * QP + 56] = x.astype(F32)
    limit = np.where(rng.rand(n_rays) < 0.3, 1e30,
                     2.0 ** rng.uniform(-30, 6, n_rays)).astype(F32)
    limit[::17] = np.inf
    limit[5::17] = BIG
    # adversarial slots on every ray
    j = rng.randint(0, 56, (16, n_rays))
    cols = np.arange(n_rays)
    tiny = np.finfo(F32).tiny
    for k, Dv in enumerate((EPS, -EPS, np.nextafter(EPS, F32(0)), F32(0.0),
                            F32(-0.0), tiny / 4, -tiny / 4, F32(3e38))):
        cand[j[k], cols] = Dv
    for k, target in ((8, "eps"), (9, "eps"), (10, "limit"), (11, "limit")):
        jj = j[k]
        Dj = cand[jj, cols]
        base = EPS if target == "eps" else np.where(np.isfinite(limit),
                                                     limit, F32(1.0))
        with np.errstate(over="ignore"):
            tcs = (np.abs(Dj).astype(np.float64) * base).astype(F32)
        steps = rng.randint(-3, 4, n_rays)
        tcs = np.array([np.nextafter(x, F32(np.inf) if s > 0
                                     else F32(-np.inf)) if s else x
                        for x, s in zip(tcs, steps)], F32)
        cand[4 * QP + jj, cols] = tcs * np.sign(Dj)
    for k, q in zip(range(12, 16), range(5)):
        for start, x in enumerate((np.nan, np.inf, -np.inf)):
            sel = cols[start::3]
            cand[((q + start) % 5) * QP + j[k][sel], sel] = x
    return torch.from_numpy(cand), torch.from_numpy(limit)


# 0: `candidate` (mxu_kernel's "default", the big form); 1: `signs_agree`
# then `closer` (mxu_kernel's "highest"), the same test in two parts
@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_test_matches_plain_commit(lib, seed, form):
    """Three groups after one another, as a kernel's thread tests them, the
    closest hit carried over: t, u, v, idx equal `_commit`'s to the bit,
    through each form of the test."""
    n = 3000
    best = None
    hits = 0
    for g in range(3):
        cand, limit = _products(seed * 10 + g, n)
        if best is None:
            best = mxu_group._start(limit)
        want = mxu_group._commit(cand, g, best)
        got = _commit_host(lib, cand, g, form, best)
        for a, b in zip(got, want):
            assert np.array_equal(a, b.numpy(), equal_nan=True)
        hits += int((want[3] != best[3]).sum())
        best = tuple(torch.from_numpy(x) for x in got)
    assert hits > n // 4


def _vpu_host(lib, tris, o, d, t_init, n_groups):
    n = t_init.shape[0]
    rays = np.ascontiguousarray(np.stack([c.numpy() for c in (*o, *d)]), F32)
    outs = [np.zeros(n, F32) for _ in range(3)] + [np.zeros(n, np.int32)]
    lib.pt_vpu_groups.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.pt_vpu_groups.restype = None
    lib.pt_vpu_groups(_ptr(rays), _ptr(np.ascontiguousarray(tris.numpy())),
                      _ptr(np.ascontiguousarray(t_init.numpy())), n,
                      n_groups, *(_ptr(x) for x in outs))
    return outs


@pytest.mark.parametrize("aimed", [False, True])
def test_vpu_group_loop_matches_vpu_reference(lib, aimed):
    """vpu_kernel's loop (tri_free.cuh `group`, four slots a load) against
    `vpu_reference`, bit for bit, on the tool's rays and on rays aimed at
    its triangles (about half hit)."""
    from pathtracer0_tpu_torch.tools import diag_mxu

    n_groups = 3
    data = diag_mxu.synthetic(n_groups, 2, "cpu")
    if aimed:
        data = diag_mxu.aim(data)[0]
    tris, o, d = data["tris"][:n_groups * 56].contiguous(), data["o"], \
        data["d"]
    t_init = torch.full((o[0].shape[0],), 1e30)
    t_init[::7] = 5.0                     # a closer start prunes
    got = _vpu_host(lib, tris, o, d, t_init, n_groups)
    want = mxu_group.vpu_reference(tris, o, d, t_init, n_groups=n_groups,
                                   reps=1)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    assert (got[3] >= 0).mean() > (0.3 if aimed else 0.002)


def test_run_vpu_refuses_tris_off_a_16_byte_boundary():
    from pathtracer0_tpu_torch.tools import diag_mxu

    data = diag_mxu.synthetic(1, 1, "cpu")
    tris = data["tris"]
    t_init = torch.full((data["o"][0].shape[0],), 1e30)
    kw = dict(n_groups=1, reps=1)
    shifted = torch.zeros(tris.numel() + 1)[1:].view(-1, 9)
    shifted.copy_(tris)
    assert shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte"):
        mxu_group.run_vpu(shifted, data["o"], data["d"], t_init, **kw)
    mxu_group.run_vpu(tris, data["o"], data["d"], t_init, **kw)


def _table(seed=0, n_groups=2):
    from pathtracer0_tpu_torch.tools import diag_mxu

    data = diag_mxu.synthetic(n_groups, 1, "cpu")
    coef = mxu_tri.coef_table(data["tris"][:n_groups * 56], data["center"])
    feats = mxu_tri.ray_features(data["o"], data["d"], data["center"])
    return coef, feats


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_frag_image_is_the_tables_real_candidates(precision):
    """mxu_kernel's B operand (mxu_tri.frag_image): each element of a
    group's image is the (rounded or split) table's entry that `mma.sync`'s
    B fragment of its lane and tile needs (candidate 64 k + 8 jt + lane / 4,
    features 2q, 2q + 1, 2q + 8, 2q + 9 at bf16; q, q + 4, 8 + q, 12 + q at
    TF32, q = lane % 4), each of the 56 real candidates' entries once and
    no pad candidate's; its TF32 parts are `round_tf32`'s; read back it is
    the table the plain version reads, and so are its products."""
    coef, feats = _table()
    img = mxu_tri.frag_image(coef, precision)
    cand, feature, part = mxu_tri.frag_layout(precision)
    real = torch.tensor([q * 64 + j for q in range(5) for j in range(56)])
    keys = (cand * 16 + feature) * 2 + part
    n_parts = 1 if precision == "default" else 2
    assert keys.unique().numel() == keys.numel() == 280 * 16 * n_parts
    assert torch.isin(cand, real).all()
    if precision == "default":
        parts = [coef.to(torch.bfloat16)]
        dtype, size, chunk = torch.bfloat16, 2, 1280
    else:
        big = mxu_tri.round_tf32(coef)
        parts = [big, mxu_tri.round_tf32(coef - big)]
        dtype, size, chunk = torch.float32, 4, 5120
    assert img.dtype == torch.uint8
    assert img.shape == (coef.shape[0], 7 * chunk)
    words = img.view(dtype)
    want = torch.stack(parts)[part, :, cand, feature].T
    assert torch.equal(words, want.to(dtype))
    # at the byte offsets the kernel's loads read (csrc/mxu_group_kernel.cu
    # chunk_tiles): lane L's (b0, b1) of tile k in chunk jt
    raw = img.numpy()
    for jt in range(7):
        for k in range(5):
            for L in range(32):
                n, q = 64 * k + 8 * jt + L // 4, L % 4
                for p, table in enumerate(parts):
                    if precision == "default":
                        at = jt * chunk + (k // 2 * 512 + 16 * L + 8 * (k % 2)
                                           if k < 4 else 1024 + 8 * L)
                        feats_of = [2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9]
                    else:
                        at = jt * chunk + (2 * k + p) * 512 + 16 * L
                        feats_of = [q, q + 4, 8 + q, 12 + q]
                    got = torch.from_numpy(
                        raw[:, at:at + size * 4].copy()).view(dtype)
                    assert torch.equal(got, table[:, n, feats_of].to(dtype))
    tables = mxu_tri.frag_image_tables(img, precision)
    pad = torch.ones(320, dtype=torch.bool)
    pad[real] = False
    for got, want_t in zip(tables, parts):
        assert torch.isnan(got[:, pad]).all()
        assert torch.equal(got[:, ~pad], want_t.to(torch.float32)[:, ~pad])
    plain = mxu_group.candidates_reference(coef, feats, n_groups=2,
                                           precision=precision)[:, real]
    if precision == "default":
        prod = tables[0][:, real] @ mxu_group._rounded(feats, "default")
        assert torch.equal(prod, plain)
    else:
        prod = tables[0][:, real] @ feats + tables[1][:, real] @ feats
        mag = coef[:, real].abs() @ feats.abs()
        assert bool(((prod - plain).abs() <= 2.0 ** -20 * mag).all())


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_frag_image_is_made_once_a_table(precision):
    """mxu_tri.frag_image_of makes a table's image at its first call and
    returns that image while the table is neither another tensor nor
    written in place, apart from the big form's B image of the same table."""
    coef = _table()[0].clone()
    first = mxu_tri.frag_image_of(coef, 2, precision)
    assert torch.equal(first, mxu_tri.frag_image(coef[:2], precision))
    assert mxu_tri.frag_image_of(coef, 2, precision) is first
    b_img = mxu_tri.b_image_of(coef, 2, precision)
    assert b_img.shape != first.shape
    assert mxu_tri.frag_image_of(coef, 2, precision) is first
    coef[0, 0, 0] += 1.0
    written = mxu_tri.frag_image_of(coef, 2, precision)
    assert written is not first and not torch.equal(written, first)
    assert torch.equal(written, mxu_tri.frag_image(coef[:2], precision))
    other = coef.clone()
    again = mxu_tri.frag_image_of(other, 2, precision)
    assert again is not written and torch.equal(again, written)
    assert torch.equal(mxu_tri.frag_image_of(other, 1, precision),
                       written[:1])
