"""The port's group-test diagnostic (kernels/mxu_tri.py, kernels/mxu_group.py,
tools/diag_mxu.py) against the JAX package's, on the CPU.

The JAX side is tools/diag_mxu.py, imported by path (`tools/` is no
package). Its launchers take no `interpret` argument, so the module fixture
wraps `jax.experimental.pallas.pallas_call` with `interpret=True` while they
trace, and restores it. On the CPU JAX computes `precision=None` in full
float32, so for "default" the JAX kernels are fed operands already rounded
to bf16. `_to_jax` / `_from_jax` carry the arrays across: the port's
(slots, 9) triangles to 128-lane rows, flat (R,) rays to (R / 128, 128) and
(R / 1024, 1, 1024) tiles and back, the coefficient table through
`mxu_tri.jax_layout`.

Tolerances. Host tables: `coef_table_np` bit-equal, the torch twin within
1e-6 of the table's largest entry (as the JAX package says of its twin),
features bit-equal; the kernels of both sides then get the very same
table and features. Scalar test (A): idx equal on >= 99.9% of the rays, t
within 1e-5 x (1 + t), u and v within 1e-4 (coordinates of 100 to 200: one
ulp of a product o . e is 1.5e-5, and XLA orders the sums its own way;
1.6e-5 was read). Product forms (B, C, D): idx equal, t within 1e-4 x (1 +
t) and u, v within 1e-3 on >= 99.5% of the rays: both sides multiply the
same float32 (or bf16-rounded) operands and only the order of the float32
sums differs, which a grazing hit (|D| small against its terms) amplifies:
one ray in 3,072 was read at 1.5e-4 x (1 + t), so the limit holds a share
of the rays, and every ray 100 times the limit. `mm_only`: within 1e-5 of
the sum of magnitudes.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pathtracer0_tpu.kernels import mxu_tri as jmxu
from pathtracer0_tpu_torch.kernels import mxu_group, mxu_tri
from pathtracer0_tpu_torch.tools import diag_mxu

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GROUPS, N_RAYS = 2, 1024
CENTER = (150.0, 150.0, 150.0)
CASES = ("tool", "aimed", "edge")


def _case(name):
    """Inputs from a numpy seed: `tool` is the tool's own synthetic recipe;
    `aimed` sends each ray at a triangle's centroid so that about half the rays hit;
    `edge` adds rays along the axes (zero direction components) and makes
    group 1 all padding."""
    data = diag_mxu.synthetic(N_GROUPS, N_RAYS // 1024, "cpu")
    tris = data["tris"].numpy().copy()
    o = np.stack([c.numpy() for c in data["o"]], 1)
    d = np.stack([c.numpy() for c in data["d"]], 1)
    if name != "tool":
        if name == "edge":
            tris[mxu_tri.GROUP_TRIS:] = 0.0
        aimed, centroid = diag_mxu.aim({**data,
                                        "tris": torch.from_numpy(tris)})
        d = np.stack([c.numpy() for c in aimed["d"]], 1)
        if name == "edge":
            # every fourth ray along an axis, from 5 units before a centroid
            axis = np.eye(3, dtype=np.float32)[np.arange(N_RAYS) % 3]
            along = np.arange(N_RAYS) % 4 == 0
            o = np.where(along[:, None], centroid - 5.0 * axis, o)
            d = np.where(along[:, None], axis, d)
    return {"tris": tris.astype(np.float32), "o": o.astype(np.float32),
            "d": d.astype(np.float32),
            "t_init": np.full(N_RAYS, 1e30, np.float32)}


def _torch_inputs(case):
    o, d = (tuple(torch.from_numpy(case[k][:, i].copy()) for i in range(3))
            for k in ("o", "d"))
    return torch.from_numpy(case["tris"]), o, d, \
        torch.from_numpy(case["t_init"])


def _to_jax(case):
    """The port's arrays in the JAX tool's layouts."""
    tris, n = case["tris"], case["o"].shape[0]
    rows = tris.shape[0] // 14
    tris128 = np.zeros((rows, 128), np.float32)
    tris128[:, :126] = tris.reshape(rows, 126)
    o3, d3 = case["o"].T.copy(), case["d"].T.copy()
    # row E's inputs, re-centred as the JAX tool does (:646-650)
    center = np.asarray(CENTER, np.float32)
    tris_c = tris128.copy()
    for j in range(14):
        tris_c[:, 9 * j:9 * j + 3] -= center[None, :]
    return {"tris": tris128, "o3": o3, "d3": d3, "tris_c": tris_c,
            "o_bc": (o3 - center[:, None]).reshape(3, n // 128, 128),
            "o_b": o3.reshape(3, n // 128, 128),
            "d_b": d3.reshape(3, n // 128, 128),
            "t_b": case["t_init"].reshape(n // 128, 128),
            "t_b1": case["t_init"].reshape(n // 1024, 1, 1024)}


def _from_jax(outs):
    """(t, u, v, idx) tiles of either JAX layout as flat (R,) arrays."""
    return tuple(np.asarray(x).reshape(-1) for x in outs)


def _bf16(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16) \
        .to(torch.float32).numpy()


@pytest.fixture(scope="module")
def jtool():
    """tools/diag_mxu.py of the JAX package with its kernels in interpret
    mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_mxu", os.path.join(ROOT, "tools", "diag_mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    pl.pallas_call = interpreted
    try:
        yield mod
    finally:
        pl.pallas_call = real


@pytest.fixture(scope="module")
def jax_runs(jtool):
    """Every JAX launcher on every case, once: {case: {row: (t, u, v, idx)}}
    as flat arrays."""
    kw = dict(n_groups=N_GROUPS, reps=1)
    highest = jax.lax.Precision.HIGHEST
    runs = {}
    for name in CASES:
        case = _case(name)
        j = _to_jax(case)
        coef = jmxu.coef_table_np(j["tris"], CENTER)
        feats = np.asarray(jmxu.ray_features(jnp.asarray(j["o3"]),
                                             jnp.asarray(j["d3"]), CENTER))
        coef_r, feats_r = _bf16(coef), _bf16(feats)
        zero_b1 = np.zeros_like(j["t_b1"])
        runs[name] = {k: _from_jax(v) for k, v in {
            "A": jtool.run_vpu(j["tris"], j["o_b"], j["d_b"], j["t_b"], **kw),
            "B highest": jtool.run_mxu(coef, feats, j["t_b"], prec=highest,
                                       **kw),
            "B default": jtool.run_mxu(coef_r, feats_r, j["t_b"], **kw),
            "C highest": jtool.run_mxu_big(coef, feats, j["t_b1"],
                                           prec=highest, **kw),
            "C default": jtool.run_mxu_big(coef_r, feats_r, j["t_b1"], **kw),
            "C mm_only": jtool.run_mxu_big(coef, feats, zero_b1, prec=highest,
                                           mm_only=True, **kw),
            "D": jtool.run_mxu_split3(coef, feats, j["t_b1"], **kw),
            "E": jtool.run_prefilter(coef, j["tris_c"], feats, j["o_bc"],
                                     j["d_b"], j["t_b"], **kw),
        }.items()}
        runs[name]["coef"], runs[name]["feats"] = coef, feats
    return runs


def _tables(case):
    """(coef, feats, t_init) of the port, bit-equal to the JAX side's."""
    _, o, d, t_init = _torch_inputs(case)
    return (torch.from_numpy(mxu_tri.coef_table_np(case["tris"], CENTER)),
            mxu_tri.ray_features(o, d, CENTER), t_init)


@pytest.mark.parametrize("name", CASES)
def test_ray_features_match(name, jax_runs):
    _, o, d, _ = _torch_inputs(_case(name))
    feats = mxu_tri.ray_features(o, d, CENTER)
    assert feats.shape == (16, N_RAYS) and feats.dtype == torch.float32
    assert np.array_equal(feats.numpy(), jax_runs[name]["feats"])
    # a (3, R) tensor is taken like a tuple
    assert torch.equal(feats, mxu_tri.ray_features(torch.stack(o),
                                                   torch.stack(d), CENTER))


@pytest.mark.parametrize("name", CASES)
def test_coef_table_np_bit_equal(name, jax_runs):
    case = _case(name)
    coef = mxu_tri.coef_table_np(case["tris"], CENTER)
    assert coef.shape == (N_GROUPS, 320, 16) and coef.dtype == np.float32
    assert np.array_equal(mxu_tri.jax_layout(coef), jax_runs[name]["coef"])
    # pad candidates and empty slots: det = +1, u = -1 on the constant
    quant = coef.reshape(N_GROUPS, 5, 64, 16)
    assert np.all(quant[:, 0, 56:, 9] == 1.0)
    assert np.all(quant[:, 1, 56:, 9] == -1.0)
    empty = np.abs(case["tris"]).max(axis=1).reshape(N_GROUPS, 56) == 0
    assert empty.any()
    assert np.all(quant[:, 0, :56, 9][empty] == 1.0)
    assert np.all(quant[:, 1, :56, 9][empty] == -1.0)


@pytest.mark.parametrize("name", CASES)
def test_coef_table_torch_twin(name, jax_runs):
    case = _case(name)
    want = mxu_tri.coef_table_np(case["tris"], CENTER)
    got = mxu_tri.coef_table(torch.from_numpy(case["tris"]), CENTER)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # one layout function for NumPy and torch tables
    assert torch.equal(mxu_tri.jax_layout(torch.from_numpy(want)),
                       torch.from_numpy(mxu_tri.jax_layout(want)))
    # the JAX package's device twin is held to the same limit
    jdev = np.asarray(jmxu.coef_table_device(
        jnp.asarray(_to_jax(case)["tris"]), jnp.asarray(CENTER, jnp.float32)))
    assert np.abs(mxu_tri.jax_layout(got).numpy() - jdev).max() \
        <= 1e-6 * np.abs(want).max()


def test_expansion_against_direct_forms():
    """coef . feats in float64 against the direct Möller-Trumbore forms
    (`candidates_np`): the expansion's error is float32 rounding of the
    table and the features, 2^-22 of the sum of magnitudes and a margin."""
    case = _case("aimed")
    center = np.asarray(CENTER)
    det, u, v, t = mxu_tri.candidates_np(case["tris"], case["o"] - center,
                                         case["d"])
    shifted = case["tris"].copy()
    shifted[:, 0:3] -= center.astype(np.float32)
    direct = mxu_tri.candidates_np(shifted, case["o"] - center, case["d"])
    jdirect = jmxu.candidates_np(_to_jax({**case, "tris": shifted})["tris"],
                                 case["o"] - center, case["d"], (0, 0, 0))
    for a, b in zip(direct, jdirect):
        assert np.array_equal(a, b)
    coef, feats, _ = _tables(case)
    c64, f64 = coef.numpy().astype(np.float64), feats.numpy().astype(np.float64)
    out = (c64 @ f64).reshape(N_GROUPS, 5, 64, N_RAYS)[:, :, :56]
    mag = (np.abs(c64) @ np.abs(f64)).reshape(N_GROUPS, 5, 64,
                                              N_RAYS)[:, :, :56]
    live = (np.abs(case["tris"]).max(axis=1) > 0).reshape(N_GROUPS, 56)
    det, u, v, t = direct
    w = det - u - v
    for q, want in enumerate((det, u, v, w, t)):
        got = out[:, q].transpose(2, 0, 1).reshape(N_RAYS, -1)
        m = mag[:, q].transpose(2, 0, 1).reshape(N_RAYS, -1)
        err = np.abs(got - want)[:, live.ravel()]
        assert np.all(err <= 2.0 ** -20 * m[:, live.ravel()] + 1e-9), q


def _agree(got, want, share, t_rel, uv):
    """idx equal, t within t_rel (1 + t) and u, v within uv (1 + |value|)
    on >= `share` of the rays; every ray with equal idx within 100 times
    those limits. Returns the share of rays that hit."""
    got = [np.asarray(x) for x in got]
    assert got[3].dtype == np.int32
    same = got[3] == want[3]
    assert same.mean() >= share, same.mean()
    hit = same & (want[3] >= 0)
    assert np.array_equal(got[0][same & ~hit], want[0][same & ~hit])
    good = same.copy()
    for k, tol in ((0, t_rel), (1, uv), (2, uv)):
        err = np.abs(got[k] - want[k])[hit] / (1.0 + np.abs(want[k][hit]))
        assert np.all(err <= 100.0 * tol), (k, err.max())
        good[hit] &= err <= tol
    assert good.mean() >= share, good.mean()
    return float((want[3] >= 0).mean())


@pytest.mark.parametrize("name", CASES)
def test_vpu_reference_against_jax_kernel(name, jax_runs):
    tris, o, d, t_init = _torch_inputs(_case(name))
    before = dict(mxu_group.launches)
    got = mxu_group.run_vpu(tris, o, d, t_init, n_groups=N_GROUPS, reps=1)
    assert mxu_group.launches == before       # CPU tensors: the plain version
    hits = _agree([x.numpy() for x in got], jax_runs[name]["A"], 0.999, 1e-5,
                  uv=1e-4)
    assert hits > (0.4 if name != "tool" else 0.0)
    if name == "edge":      # nothing in the all-padding group
        assert int(got[3].max()) < mxu_tri.GROUP_TRIS
        assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("precision", mxu_group.PRECISIONS)
@pytest.mark.parametrize("name", CASES)
def test_mxu_reference_against_jax_kernels(name, precision, jax_runs):
    """B and C share one plain version; the JAX kernels `_mxu_kernel` and
    `_mxu_big_kernel` must both agree with it, and with each other."""
    coef, feats, t_init = _tables(_case(name))
    kw = dict(n_groups=N_GROUPS, reps=1, precision=precision)
    b = [x.numpy() for x in mxu_group.run_mxu(coef, feats, t_init, **kw)]
    c = [x.numpy() for x in mxu_group.run_mxu_big(coef, feats, t_init, **kw)]
    for x, y in zip(b, c):
        assert np.array_equal(x, y)
    hits = _agree(b, jax_runs[name][f"B {precision}"], 0.995, 1e-4, uv=1e-3)
    _agree(c, jax_runs[name][f"C {precision}"], 0.995, 1e-4, uv=1e-3)
    assert hits > (0.4 if name != "tool" else 0.0)
    assert np.all(np.isfinite(b[0])) and np.all(b[3][b[0] > 1e29] == -1)


@pytest.mark.parametrize("precision", mxu_group.PRECISIONS)
def test_nan_products_fail_the_sign_test_as_in_jax(precision, jtool):
    """A candidate with NaN in one of D, U, V, W or Tn is no hit, in the JAX
    kernel `_mxu_kernel` (jnp.minimum / jnp.maximum carry the NaN into the
    sign test) and in the plain version: NaN in one coefficient of the 20
    slots that win most often on the aimed rays, four in each quantity."""
    case = _case("aimed")
    coef, feats, t_init = _tables(case)
    kw = dict(n_groups=N_GROUPS, reps=1)
    clean = mxu_group.run_mxu(coef, feats, t_init, precision=precision, **kw)
    wins = torch.bincount(clean[3][clean[3] >= 0],
                          minlength=N_GROUPS * mxu_tri.GROUP_TRIS)
    slots = wins.argsort(descending=True)[:20]
    poisoned = coef.clone()
    for k, s in enumerate(slots.tolist()):
        g, j = divmod(s, mxu_tri.GROUP_TRIS)
        poisoned[g, (k % 5) * mxu_tri.QUANT_PAD + j, k % 16] = float("nan")
    got = [x.numpy() for x in mxu_group.run_mxu(poisoned, feats, t_init,
                                                precision=precision, **kw)]
    j = _to_jax(case)
    coef_j, feats_j = mxu_tri.jax_layout(poisoned).numpy(), feats.numpy()
    if precision == "default":
        want = jtool.run_mxu(_bf16(coef_j), _bf16(feats_j), j["t_b"], **kw)
    else:
        want = jtool.run_mxu(coef_j, feats_j, j["t_b"],
                             prec=jax.lax.Precision.HIGHEST, **kw)
    want = _from_jax(want)
    _agree(got, want, 0.995, 1e-4, uv=1e-3)
    for idx in (got[3], want[3]):
        assert not np.isin(idx, slots.numpy()).any()
    assert int(wins[slots].sum()) > N_RAYS // 8


@pytest.mark.parametrize("name", CASES)
def test_mm_only_reference_against_jax_kernel(name, jax_runs):
    coef, feats, _ = _tables(_case(name))
    zero = torch.zeros(N_RAYS)
    t, u, v, idx = mxu_group.run_mxu_big(
        coef, feats, zero, n_groups=N_GROUPS, reps=1, precision="highest",
        mm_only=True)
    want = jax_runs[name]["C mm_only"]
    mag = sum(coef[g, 0].abs() @ feats.abs() for g in range(N_GROUPS)).numpy()
    assert np.all(np.abs(t.numpy() - want[0]) <= 1e-5 * mag + 1e-30)
    assert np.abs(t.numpy()).max() > 0.0
    assert bool((idx == -1).all()) and not bool(u.any()) and not bool(v.any())
    # twice the passes add twice
    t2 = mxu_group.run_mxu_big(coef, feats, zero, n_groups=N_GROUPS, reps=2,
                               precision="highest", mm_only=True)[0]
    assert np.all(np.abs(t2.numpy() - 2.0 * t.numpy()) <= 2e-5 * mag + 1e-30)


@pytest.mark.parametrize("name", CASES)
def test_split3_reference_against_jax_kernel(name, jax_runs):
    coef, feats, t_init = _tables(_case(name))
    got = mxu_group.run_mxu_split3(coef, feats, t_init, n_groups=N_GROUPS,
                                   reps=1)
    _agree([x.numpy() for x in got], jax_runs[name]["D"], 0.995, 1e-4,
           uv=1e-3)
    hi, lo = mxu_group.split_bf16(coef)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert float((hi.float() + lo.float() - coef).abs().max()) \
        <= 2.0 ** -16 * float(coef.abs().max())
    want = _jax_split(jax_runs[name]["coef"])
    assert np.array_equal(mxu_tri.jax_layout(hi.float()).numpy(), want[0])
    assert np.array_equal(mxu_tri.jax_layout(lo.float()).numpy(), want[1])


def _jax_split(x):
    """The JAX tool's `_split_bf16`, as float32 arrays."""
    hi = jnp.asarray(x).astype(jnp.bfloat16)
    lo = (jnp.asarray(x) - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return (np.asarray(hi.astype(jnp.float32)),
            np.asarray(lo.astype(jnp.float32)))


@pytest.mark.parametrize("precision", ("highest", "default", "split3"))
def test_candidates_reference(precision):
    """`mxu_candidates` on the CPU: the products the plain versions test."""
    coef, feats, _ = _tables(_case("aimed"))
    cand = mxu_group.mxu_candidates(coef, feats, n_groups=N_GROUPS,
                                    precision=precision)
    assert cand.shape == (N_GROUPS, 320, N_RAYS)
    exact = coef.double() @ feats.double()
    mag = coef.double().abs() @ feats.double().abs()
    # float32, 8 mantissa bits, 16: the error each form may show
    bits = {"highest": 20, "default": 7, "split3": 14}[precision]
    assert bool(((cand.double() - exact).abs() <= 2.0 ** -bits * mag).all())
    if precision != "highest":
        assert float((cand.double() - exact).abs().max()) > 0.0


@pytest.mark.parametrize("precision", ("default", "split3", "highest"))
def test_b_image_is_a_permutation_the_plain_version_reads(precision):
    """The big form's B operand (mxu_tri.b_image): each part of a group's
    image holds the (rounded or split) table's entries at the byte offsets
    the kernel's `wgmma` descriptors read (core matrices of 8 columns x 16
    bytes, columns 40 j + 8 q + i = quantity q of triangle 8 j + i), read
    back it is the same table, and the products of the tables read back
    are the plain version's."""
    coef, feats, _ = _tables(_case("aimed"))
    img = mxu_tri.b_image(coef, precision)
    cols = mxu_tri.b_columns()
    assert sorted(cols.tolist()) == list(range(320))
    j, q, i = cols // 8 % 8, cols // 64, cols % 8
    assert torch.equal(torch.arange(320), 40 * j + 8 * q + i)
    if precision == "highest":
        big = mxu_tri.round_tf32(coef)
        parts = [big, mxu_tri.round_tf32(coef - big)]
        kb, size, dtype = 4, 4, torch.float32
    else:
        parts = list(mxu_group.split_bf16(coef))[:1 if precision == "default"
                                                 else 2]
        kb, size, dtype = 8, 2, torch.bfloat16
    part_bytes = 320 * 16 * size
    assert img.dtype == torch.uint8 and img.shape == (N_GROUPS,
                                                      part_bytes * len(parts))
    n, f = torch.meshgrid(torch.arange(320), torch.arange(16), indexing="ij")
    offset = ((n // 8) * 8 * 16 * (16 // kb) + (f // kb) * 128
              + (n % 8) * 16 + (f % kb) * size)
    for k, part in enumerate(parts):
        words = img[:, k * part_bytes:(k + 1) * part_bytes].contiguous() \
            .view(dtype)
        at = words[:, offset // size]                    # (G, 320, 16)
        assert torch.equal(at, part.to(dtype)[:, cols])
        assert torch.equal(words.sort(1).values,
                           part.to(dtype).reshape(N_GROUPS, -1).sort(1).values)
    tables = mxu_tri.b_image_tables(img, precision)
    for got, want in zip(tables, parts):
        assert torch.equal(got, want.to(dtype).to(torch.float32))
    want = mxu_group.candidates_reference(coef, feats, n_groups=N_GROUPS,
                                          precision=precision)
    if precision == "default":
        assert torch.equal(tables[0] @ mxu_group._rounded(feats, "default"),
                           want)
    elif precision == "split3":
        fh, fl = (x.to(torch.float32) for x in mxu_group.split_bf16(feats))
        ch, cl = tables
        assert torch.equal(ch @ fh + ch @ fl + cl @ fh, want)
    else:
        # big + small keeps 21 bits of each coefficient
        assert bool(((tables[0] + tables[1] - coef).abs()
                     <= 2.0 ** -21 * coef.abs()).all())
        got = tables[0] @ feats + tables[1] @ feats
        mag = coef.abs() @ feats.abs()
        assert bool(((got - want).abs() <= 2.0 ** -20 * mag).all())


@pytest.mark.parametrize("precision", ["default", "highest", "split3"])
def test_b_image_is_made_once_a_table(precision):
    """mxu_tri.b_image_of makes a table's B image at its first call and
    returns that image while the table is neither another tensor nor
    written in place; each image equals b_image of the table it holds."""
    coef = _tables(_case("aimed"))[0].clone()
    first = mxu_tri.b_image_of(coef, N_GROUPS, precision)
    assert torch.equal(first, mxu_tri.b_image(coef[:N_GROUPS], precision))
    assert mxu_tri.b_image_of(coef, N_GROUPS, precision) is first
    coef[0, 0, 0] += 1.0
    written = mxu_tri.b_image_of(coef, N_GROUPS, precision)
    assert written is not first and not torch.equal(written, first)
    assert torch.equal(written, mxu_tri.b_image(coef[:N_GROUPS], precision))
    other = coef.clone()
    again = mxu_tri.b_image_of(other, N_GROUPS, precision)
    assert again is not written and torch.equal(again, written)
    fewer = mxu_tri.b_image_of(other, 1, precision)
    assert torch.equal(fewer, written[:1])


def test_round_tf32_is_cvt_rna():
    """Nearest TF32 (10 mantissa bits), ties away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + 1.5 * ulp, -(1.0 + ulp / 2),
                      1.0 + ulp / 4, 1.0 + 0.75 * ulp, 3.0, 0.0, -0.0],
                     dtype=torch.float32)
    want = [1.0 + ulp, 1.0 + 2 * ulp, -(1.0 + ulp), 1.0, 1.0 + ulp, 3.0,
            0.0, -0.0]
    assert mxu_tri.round_tf32(x).tolist() == want
    assert (mxu_tri.round_tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()


def test_repeated_passes_change_nothing():
    tris, o, d, t_init = _torch_inputs(_case("aimed"))
    coef, feats, _ = _tables(_case("aimed"))
    kw = dict(n_groups=N_GROUPS)
    runs = {
        "A": lambda r: mxu_group.run_vpu(tris, o, d, t_init, reps=r, **kw),
        "B": lambda r: mxu_group.run_mxu(coef, feats, t_init, reps=r, **kw),
        "D": lambda r: mxu_group.run_mxu_split3(coef, feats, t_init, reps=r,
                                                **kw)}
    for fn in runs.values():
        for x, y in zip(fn(1), fn(3)):
            assert torch.equal(x, y)
    # no pass at all returns the start
    t, u, v, idx = runs["B"](0)
    assert torch.equal(t, t_init) and bool((idx == -1).all())


def test_a_closer_start_prunes():
    """A ray whose t_init lies before its hit keeps t_init and idx -1."""
    tris, o, d, t_init = _torch_inputs(_case("aimed"))
    coef, feats, _ = _tables(_case("aimed"))
    kw = dict(n_groups=N_GROUPS, reps=1)
    full = mxu_group.run_mxu(coef, feats, t_init, precision="highest", **kw)
    short = torch.where(torch.arange(N_RAYS) % 2 == 0, full[0] * 0.5, t_init)
    for out in (mxu_group.run_mxu(coef, feats, short, precision="highest",
                                  **kw),
                mxu_group.run_vpu(tris, o, d, short, **kw)):
        cut = (torch.arange(N_RAYS) % 2 == 0) & (full[3] >= 0)
        assert bool(cut.any())
        assert bool((out[3][cut] == -1).all())
        assert torch.equal(out[0][cut], short[cut])


def test_wrappers_refuse_what_they_do_not_take():
    tris, o, d, t_init = _torch_inputs(_case("tool"))
    coef, feats, _ = _tables(_case("tool"))
    kw = dict(n_groups=N_GROUPS, reps=1)
    with pytest.raises(ValueError, match="precision"):
        mxu_group.run_mxu(coef, feats, t_init, precision="float64", **kw)
    with pytest.raises(ValueError, match="coef"):
        mxu_group.run_mxu(coef[:1], feats, t_init, **kw)
    with pytest.raises(ValueError, match="coef"):
        mxu_group.run_mxu_big(mxu_tri.jax_layout(coef), feats, t_init, **kw)
    with pytest.raises(ValueError, match="feats"):
        mxu_group.run_mxu_split3(coef, feats[:, :-1], t_init, **kw)
    with pytest.raises(ValueError, match="tris"):
        mxu_group.run_vpu(tris[:100], o, d, t_init, **kw)
    with pytest.raises(ValueError, match="per ray"):
        mxu_group.run_vpu(tris, o, d, t_init[:-1], **kw)
    with pytest.raises(ValueError, match="56"):
        mxu_tri.coef_table_np(tris.numpy()[:100], CENTER)
    assert set(mxu_group.launches) == {"vpu_kernel", "mxu_kernel",
                                       "mxu_big_kernel", "mxu_split3_kernel",
                                       "prefilter_kernel"}


def test_tool_end_to_end_against_jax_rows(jax_runs, capsys):
    """The port's tool on the CPU at 2 groups x 1,024 rays x 1 pass against
    the JAX tool's rows, computed from its launchers as its `check` does."""
    rows = diag_mxu.main(N_GROUPS, 1, n_blocks=1, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == len(rows) == 9
    by = {r["row"]: r for r in rows}
    assert [r["row"][0] for r in rows] == list("ABCCBCCDE")
    assert all(r["us_per_group_1024_rays"] is None and r["device"] == "cpu"
               for r in rows)                 # no time is measured on the CPU
    j = jax_runs["tool"]
    ta, ia = j["A"][0], j["A"][3]
    assert by["A vpu rows"]["hits"] == float((ia >= 0).mean())
    pairs = {"B mxu rows (highest)": "B highest",
             "B mxu rows (default)": "B default",
             "C mxu big (highest)": "C highest",
             "C mxu big (default)": "C default",
             "D mxu split3 (manual bf16 x 3)": "D",
             "E bf16 prefilter + vpu": "E"}
    for label, key in pairs.items():
        row, (tb, _, _, ib) = by[label], j[key]
        assert row["hits_a"] == float((ia >= 0).mean())
        assert abs(row["idx_mismatch"] - float((ia != ib).mean())) <= 0.005
        both = (ia >= 0) & (ib >= 0)
        want_dt = float(np.abs(ta - tb)[both].max()) if both.any() else 0.0
        assert abs(row["max_abs_dt"] - want_dt) <= 1e-4 * (1.0 + want_dt)
    assert "hits" not in by["C mxu big mm-only (default)"]
    e = by["E bf16 prefilter + vpu"]
    assert e["hits_of_a_lost"] == 0 and e["margin_ratio"] > 0.0
    assert 0.0 < e["gate_pass_share"] <= 1.0


def test_tool_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        diag_mxu.main(1, 1, n_blocks=1)


def _prefilter_inputs(case):
    """Row E's inputs of the port: the tables, then the triangles and
    origins re-centred by the table's centre."""
    tris, o, d, _ = _torch_inputs(case)
    coef, feats, t_init = _tables(case)
    return (coef, mxu_tri.recentre_tris(tris, CENTER), feats,
            mxu_tri.recentre_origins(o, CENTER), d, t_init)


def test_recentred_inputs_match_jax_tool():
    """The re-centred triangles and origins bit-equal to the JAX tool's
    (tools/diag_mxu.py:646-650)."""
    case = _case("edge")
    j = _to_jax(case)
    _, tris_c, _, o_c, _, _ = _prefilter_inputs(case)
    rows = tris_c.shape[0] // 14
    assert np.array_equal(tris_c.numpy().reshape(rows, 126),
                          j["tris_c"][:, :126])
    assert np.array_equal(torch.stack(o_c).numpy(),
                          j["o_bc"].reshape(3, -1))


@pytest.mark.parametrize("name", CASES)
def test_prefilter_reference_against_jax_kernel(name, jax_runs):
    """Row E: the port (on the CPU its plain version, gate unit 32 rays)
    against the JAX `_prefilter_kernel` (gate unit 1,024 rays): while the
    filter is conservative both find every hit of the scalar test on the
    re-centred inputs, so idx is equal and t, u, v within 1e-4 (1 + t)."""
    before = dict(mxu_group.launches)
    got = mxu_group.run_prefilter(*_prefilter_inputs(_case(name)),
                                  n_groups=N_GROUPS, reps=1)
    assert mxu_group.launches == before       # CPU tensors: the plain version
    assert len(got) == 5 and got[4].shape == (N_RAYS // 32,)
    assert got[4].dtype == torch.int32
    assert bool((got[4] >= 0).all() and (got[4] <= N_GROUPS).all())
    hits = _agree([x.numpy() for x in got[:4]], jax_runs[name]["E"], 0.999,
                  1e-4, uv=1e-4)
    assert hits > (0.4 if name != "tool" else 0.0)
    if name == "edge":      # the all-padding group passes no gate
        assert int(got[4].max()) <= 1


@pytest.mark.parametrize("name", CASES)
def test_prefilter_loses_no_hit_of_the_scalar_test(name):
    """Every ray that row A (run_vpu) finds a hit for, row E finds one for
    too, at the triangle A found on >= 99.9% of them; the margin its hits
    needed stays above 0 (the filter is conservative); three passes find
    what one found, and the gate counts one pass."""
    case = _case(name)
    tris, o, d, t_init = _torch_inputs(case)
    a = mxu_group.run_vpu(tris, o, d, t_init, n_groups=N_GROUPS, reps=1)
    args = _prefilter_inputs(case)
    e = mxu_group.run_prefilter(*args, n_groups=N_GROUPS, reps=1)
    assert not bool(((a[3] >= 0) & (e[3] < 0)).any())
    assert float((a[3] == e[3]).float().mean()) >= 0.999
    coef, _, feats = args[:3]
    assert mxu_group.prefilter_margin(coef, feats, a[3]) > 0.0
    for x, y in zip(e, mxu_group.run_prefilter(*args, n_groups=N_GROUPS,
                                               reps=3)):
        assert torch.equal(x, y)


def test_prefilter_gate_unit_is_a_warp():
    """The gate passes a unit of 32 rays if any of its rays has a plausible
    candidate: rays of a unit that passes are tested even where they alone
    would not pass, and a closer start (t_init) prunes as in row A."""
    coef, tris_c, feats, o_c, d, t_init = _prefilter_inputs(_case("aimed"))
    ch, ca, fh, fa = mxu_group._bf16_tables(coef, feats)
    want = torch.zeros(N_RAYS // 32, dtype=torch.int32)
    for g in range(N_GROUPS):
        plaus = mxu_group._plausible(ch[g, :256] @ fh, ca[g, :256] @ fa)
        want += plaus.any(0).view(-1, 32).any(1).to(torch.int32)
    e = mxu_group.run_prefilter(coef, tris_c, feats, o_c, d, t_init,
                                n_groups=N_GROUPS, reps=1)
    assert torch.equal(e[4], want)
    short = torch.where(e[3] >= 0, e[0] * 0.5, t_init)
    cut = mxu_group.run_prefilter(coef, tris_c, feats, o_c, d, short,
                                  n_groups=N_GROUPS, reps=1)
    assert bool((cut[3][e[3] >= 0] == -1).all())
    assert torch.equal(cut[4], e[4])        # the gate reads no t


def _terrain_tris(n_groups):
    """A height field like the terrain's, v1, e1, e2 by slot, in groups of
    56: two triangles a quad of a 0.25-unit grid, every 9th slot empty."""
    quads = n_groups * mxu_tri.GROUP_TRIS // 2
    side = int(np.ceil(np.sqrt(quads)))
    xs = np.arange(side + 1) * 0.25
    x, z = np.meshgrid(xs, xs)
    p = np.stack([x, np.sin(3 * x) * np.cos(2 * z) * 0.4, z + 6], -1)
    a, b, c, e = (p[:-1, :-1], p[1:, :-1], p[:-1, 1:], p[1:, 1:])
    v1 = np.concatenate([a.reshape(-1, 3), e.reshape(-1, 3)])[:2 * quads]
    v2 = np.concatenate([b.reshape(-1, 3)] * 2)[:2 * quads]
    v3 = np.concatenate([c.reshape(-1, 3)] * 2)[:2 * quads]
    tris = np.concatenate([v1, v2 - v1, v3 - v1], 1).astype(np.float32)
    tris[::9] = 0.0
    return tris


@pytest.mark.parametrize("name", ("tool", "aimed", "terrain"))
def test_sign_cleared_frag_image_is_the_magnitude_image(name):
    """prefilter_kernel's magnitude operand: the fragment image of the
    table at "default" with each bf16 word's sign bit cleared equals, word
    for word, the fragment image of |coef| (bf16 rounding to nearest is
    symmetric), so one image serves both of row E's products; and its
    words are those of |coef| in bf16 (`coef.abs().to(torch.bfloat16)`,
    the table the kernel used to be handed) at every real candidate."""
    if name == "terrain":
        tris = _terrain_tris(N_GROUPS)
        center = (tris[:, 0:3].min(0) + tris[:, 0:3].max(0)) / 2.0
    else:
        tris, center = _case(name)["tris"], CENTER
    coef = torch.from_numpy(mxu_tri.coef_table_np(tris, center))
    words = mxu_tri.frag_image(coef, "default").view(torch.int16)
    cleared = words & 0x7fff
    magnitudes = mxu_tri.frag_image(coef.abs(), "default").view(torch.int16)
    assert torch.equal(cleared, magnitudes)
    assert bool((words < 0).any())      # some sign bits were set
    back = mxu_tri.frag_image_tables(cleared.view(torch.uint8), "default")[0]
    real = ~torch.isnan(back)
    assert int(real.sum()) == N_GROUPS * 5 * mxu_tri.GROUP_TRIS * 16
    assert torch.equal(back[real],
                       coef.abs().to(torch.bfloat16).to(torch.float32)[real])


def _chunk_gate(ch, ca, fh, fa, g, n_units):
    """Group g's gate decided as prefilter_kernel decides it, 8 triangles
    at a time, the rays of a unit leaving at the first chunk that passes
    it; the operands as `mxu_group._bf16_tables` gives them. Returns
    (unit, first): whether each of the n_units units of 32 rays passes,
    and the chunk it passed at (-1 where it passed none)."""
    n_rays = fh.shape[1]
    first = torch.full((n_units,), -1, dtype=torch.int64)
    for jt in range(mxu_tri.GROUP_TRIS // 8):
        left = (first < 0).repeat_interleave(32)[:n_rays].nonzero()[:, 0]
        if left.numel() == 0:
            break
        rows = (torch.arange(4)[:, None] * mxu_tri.QUANT_PAD + 8 * jt
                + torch.arange(8)).reshape(-1)
        out = (ch[g, rows] @ fh[:, left]).view(4, 8, -1)
        m = (ca[g, rows] @ fa[:, left]).view(4, 8, -1) * mxu_group.MARGIN
        plaus = torch.zeros(n_units * 32, dtype=torch.bool)
        plaus[left] = ((out > -m).all(0) | (out < m).all(0)).any(0)
        first[plaus.view(n_units, 32).any(1) & (first < 0)] = jt
    return first >= 0, first


def _chunk_gated(args, kw, monkeypatch):
    """prefilter_reference with its gate decided chunk by chunk
    (`_chunk_gate` in place of the whole group's `_unit_gate`)."""
    with monkeypatch.context() as mp:
        mp.setattr(mxu_group, "_unit_gate",
                   lambda *gate_args: _chunk_gate(*gate_args)[0])
        return mxu_group.prefilter_reference(*args, **kw)


@pytest.mark.parametrize("name", CASES)
def test_prefilter_gate_by_chunks_equals_the_whole_group_gate(
        name, jax_runs, monkeypatch):
    """prefilter_reference with the gate decided chunk by chunk, a unit
    leaving at the first chunk that passes it (the kernel's order), and
    with the gate over the whole group's product: the same gate on every
    unit and group, the same outputs and gate counts, and both against the
    JAX `_prefilter_kernel` as test_prefilter_reference_against_jax_kernel
    holds the second."""
    args = _prefilter_inputs(_case(name))
    kw = dict(n_groups=N_GROUPS, reps=1)
    ch, ca, fh, fa = mxu_group._bf16_tables(args[0], args[2])
    for g in range(N_GROUPS):
        assert torch.equal(
            _chunk_gate(ch, ca, fh, fa, g, N_RAYS // 32)[0],
            mxu_group._unit_gate(ch, ca, fh, fa, g, N_RAYS // 32))
    whole = mxu_group.prefilter_reference(*args, **kw)
    chunks = _chunk_gated(args, kw, monkeypatch)
    for x, y in zip(chunks, whole):
        assert torch.equal(x, y)
    for got in (chunks, whole):
        _agree([x.numpy() for x in got[:4]], jax_runs[name]["E"], 0.999,
               1e-4, uv=1e-4)


def test_prefilter_gate_leaves_at_the_first_chunk_that_passes(monkeypatch):
    """Groups whose only triangles sit in chunk 0, 3 or 6 (the others
    empty), one group all empty, rays aimed at them: the chunk-by-chunk
    gate passes units at those chunks and no unit in the empty group, with
    the same outputs and gate counts as the whole-group gate."""
    data = diag_mxu.synthetic(4, 1, "cpu")
    tris = data["tris"].clone()
    for g, keep in enumerate((0, 3, 6, None)):
        for jt in range(7):
            if jt != keep:
                tris[g * 56 + 8 * jt:g * 56 + 8 * jt + 8] = 0.0
    data = diag_mxu.aim({**data, "tris": tris})[0]
    o, d = data["o"], data["d"]
    coef = torch.from_numpy(mxu_tri.coef_table_np(tris.numpy(), CENTER))
    feats = mxu_tri.ray_features(o, d, CENTER)
    t_init = torch.full((o[0].shape[0],), 1e30)
    args = (coef, mxu_tri.recentre_tris(tris, CENTER), feats,
            mxu_tri.recentre_origins(o, CENTER), d, t_init)
    kw = dict(n_groups=4, reps=1)
    whole = mxu_group.prefilter_reference(*args, **kw)
    chunks = _chunk_gated(args, kw, monkeypatch)
    for x, y in zip(chunks, whole):
        assert torch.equal(x, y)
    ch, ca, fh, fa = mxu_group._bf16_tables(coef, feats)
    for g, keep in enumerate((0, 3, 6, None)):
        unit, first = _chunk_gate(ch, ca, fh, fa, g, 32)
        assert bool(unit.any()) == (keep is not None)
        assert bool((first[unit] == (-1 if keep is None else keep)).all())
    a = mxu_group.run_vpu(tris, o, d, t_init, **kw)
    assert not bool(((a[3] >= 0) & (whole[3] < 0)).any())
    assert float((a[3] >= 0).float().mean()) > 0.2


def test_prefilter_refuses_what_it_does_not_take():
    coef, tris_c, feats, o_c, d, t_init = _prefilter_inputs(_case("tool"))
    kw = dict(n_groups=N_GROUPS, reps=1)
    with pytest.raises(ValueError, match="tris_c"):
        mxu_group.run_prefilter(coef, tris_c[:100], feats, o_c, d, t_init,
                                **kw)
    with pytest.raises(ValueError, match="per ray"):
        mxu_group.run_prefilter(coef, tris_c, feats, (o_c[0][:-1], *o_c[1:]),
                                d, t_init, **kw)
    with pytest.raises(ValueError, match="coef"):
        mxu_group.run_prefilter(coef[:1], tris_c, feats, o_c, d, t_init,
                                **kw)
    with pytest.raises(ValueError, match="feats"):
        mxu_group.run_prefilter(coef, tris_c, feats[:, :-1], o_c, d, t_init,
                                **kw)
    with pytest.raises(ValueError, match="no group-test kernel"):
        mxu_group.run_prefilter(coef, tris_c, feats, o_c, d,
                                t_init.to("meta"), **kw)
    shifted = torch.zeros(tris_c.numel() + 1)[1:].view(-1, 9)
    shifted.copy_(tris_c)
    with pytest.raises(ValueError, match="16-byte"):
        mxu_group.run_prefilter(coef, shifted, feats, o_c, d, t_init, **kw)
