"""The group test four ways: the closest hit of a batch of rays against
`n_groups` groups of 56 leaf-packed triangles, `reps` times over.

Counterpart of the launchers of the JAX package's tools/diag_mxu.py and
their Pallas kernels:

  run_vpu         `_vpu_kernel`: the streamed route's division-free slot
                  test (csrc/tri_free.cuh), the slots in order; idx = group *
                  56 + slot
  run_mxu         `_mxu_kernel`: per group the product coef_g (320, 16) x
                  features (16, R) (kernels/mxu_tri.py), a warp's 16 rays at
                  a time (on the card `mma.sync`, whose B operand is the
                  table in the port-side layout mxu_tri.frag_image, made
                  once a table); a triangle is hit if det, u, v, w share a
                  sign, |det| >= 1e-10 and t = Tn / D lies in (1e-10,
                  closest so far); a group's winner is its least t, the
                  lowest slot on a tie, and replaces the closest hit if
                  strictly closer
  run_mxu_big     `_mxu_big_kernel`: the same with one product per group
                  over a whole block of rays (on the card a warpgroup's
                  `wgmma` of 64 rays, whose B operand is the table in the
                  port-side layout mxu_tri.b_image, made once a table);
                  `mm_only` skips the test and adds candidate 0 of each
                  product into t, to price the product alone
  run_mxu_split3  `_mxu_split3_kernel`: the same with both operands split
                  into bf16 hi and lo parts (`split_bf16`) and the product
                  taken as ch fh + ch fl + cl fh
  run_prefilter   `_prefilter_kernel`: a bf16 product as a conservative
                  filter before the scalar slot test. Per group the bf16
                  product of D, U, V, W and the product of magnitudes
                  |coef| |features|; a candidate is plausible if its four
                  could share a sign within MARGIN = 2^-6 of its magnitude
                  (tools/diag_mxu.py:320-322). The gate's unit is a warp of
                  GATE_RAYS = 32 consecutive rays (the TPU kernel's was a
                  block of 1,024): if any candidate of a group is plausible
                  for any ray of the unit, every ray of it runs run_vpu's
                  slot test over the group's 56 slots, on re-centred
                  triangles and origins (kernels/mxu_tri.py). While the
                  filter is conservative the hits do not depend on the
                  unit; the count of units that pass does. On the card
                  the products read run_mxu's fragment image ("default",
                  the magnitudes as its words with the sign bits
                  cleared), the gate is decided 8 triangles at a time
                  and a unit leaves it at the first chunk that passes

Rays are flat (R,) tensors for any R; o and d are (x, y, z) tuples. The
product forms take `precision`: "default" rounds both operands to bf16
(one tensor-core pass), "highest" keeps float32 accuracy (on the card an
error-compensated three-pass TF32 split). Every function returns (t, u, v,
idx): t is `t_init` and idx -1 where nothing was hit closer. `reps` repeats
the whole pass for timing; a repeated pass changes nothing (`mm_only` adds
again). `run_prefilter` also returns how many groups each unit passed in
one pass.

CUDA tensors go through csrc/mxu_group_kernel.cu and nothing else, CPU
tensors through the plain versions below (`vpu_reference`,
`mxu_reference`, `mm_only_reference`, `split3_reference`,
`prefilter_reference`). `launches` counts the kernels' launches.
`mxu_candidates` returns the products themselves, written out by a
kernel's check-only instantiation, for checks of their accuracy.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, mxu_tri
from .intersect import EPSILON
from .mxu_tri import GROUP_TRIS, N_CAND, N_FEATURES, QUANT_PAD
from .wavefront import group_accept

BIG = 1e33
PRECISIONS = ("highest", "default")
GATE_RAYS = 32          # run_prefilter: the rays of one gate unit, a warp
MARGIN = 2.0 ** -6      # tools/diag_mxu.py:253: >= bf16 eps x dot length

launches = {"vpu_kernel": 0, "mxu_kernel": 0, "mxu_big_kernel": 0,
            "mxu_split3_kernel": 0, "prefilter_kernel": 0}


def split_bf16(x):
    """x (float32) -> (hi, lo) bf16 with hi + lo ~= x to 16 mantissa bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


# ---- plain versions ---------------------------------------------------------

def vpu_reference(tris, o, d, t_init, *, n_groups, reps):
    """Plain version of `vpu_kernel`: per group the (R, 56) tensor form of
    the slot test with the sequential accept loop of the streamed walk."""
    best = [t_init.clone(), torch.ones_like(t_init), torch.zeros_like(t_init),
            torch.zeros_like(t_init),
            torch.full(t_init.shape, -1, dtype=torch.int32,
                       device=t_init.device), t_init.clone()]
    lanes = torch.arange(GROUP_TRIS, dtype=torch.int32, device=t_init.device)
    for _ in range(reps):
        for g in range(n_groups):
            best = group_accept(
                o, d, tris[g * GROUP_TRIS:(g + 1) * GROUP_TRIS],
                g * GROUP_TRIS + lanes, best)
    t, td, u, v, idx, _ = best
    inv = 1.0 / td
    return t * inv, u * inv, v * inv, idx


def _commit(out, g, best):
    """One group's candidates `out` (320, R) against the closest hits
    best = (t, u, v, idx): sign test (a NaN fails it, as in
    tools/diag_mxu.py), t = Tn / D, least t then lowest slot
    (csrc/group_test.cuh)."""
    tb, ub, vb, ib = best
    D, U, V, W, Tn = (out[q * QUANT_PAD:q * QUANT_PAD + GROUP_TRIS]
                      for q in range(5))
    mn = torch.minimum(torch.minimum(D, U), torch.minimum(V, W))
    mx = torch.maximum(torch.maximum(D, U), torch.maximum(V, W))
    rD = 1.0 / torch.where(D == 0.0, 1.0, D)
    tval = Tn * rD
    ok = (((mn > 0.0) | (mx < 0.0)) & (D.abs() >= EPSILON)
          & (tval > EPSILON) & (tval < tb))
    tsel = torch.where(ok, tval, BIG)
    wt, wj = tsel.min(dim=0)
    # the lowest slot among equal least t
    slot = torch.arange(GROUP_TRIS, device=out.device)[:, None]
    wj = torch.where(ok & (tsel <= wt), slot, 1 << 30).amin(dim=0)
    upd = wt < tb
    pick = wj.clamp(max=GROUP_TRIS - 1)[None]
    wu = (U * rD).gather(0, pick)[0]
    wv = (V * rD).gather(0, pick)[0]
    return (torch.where(upd, wt, tb), torch.where(upd, wu, ub),
            torch.where(upd, wv, vb),
            torch.where(upd, (wj + g * GROUP_TRIS).to(torch.int32), ib))


def _start(t_init):
    zero = torch.zeros_like(t_init)
    return (t_init, zero, zero,
            torch.full(t_init.shape, -1, dtype=torch.int32,
                       device=t_init.device))


def _check_precision(precision, allowed=PRECISIONS):
    if precision not in allowed:
        raise ValueError(f"precision must be one of {allowed}, "
                         f"not {precision!r}")


def _rounded(x, precision):
    """The operand as the product of that precision sees it."""
    _check_precision(precision)
    if precision == "default":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _check_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups):
    n_rays = _check_tables(coef, feats, t_init, n_groups)
    if tris_c.ndim != 2 or tris_c.shape[1] != 9 \
            or tris_c.shape[0] < n_groups * GROUP_TRIS:
        raise ValueError(f"tris_c must be (>= {n_groups * GROUP_TRIS}, 9), "
                         f"not {tuple(tris_c.shape)}")
    if tris_c.data_ptr() % 16:
        raise ValueError("tris_c must start on a 16-byte boundary: the "
                         "kernel reads a group's slots 16 bytes at a time")
    if any(c.shape != (n_rays,) for c in (*o_c, *d)):
        raise ValueError("o_c, d and t_init must hold one entry per ray")
    return n_rays


def _check_tables(coef, feats, t_init, n_groups):
    if coef.ndim != 3 or tuple(coef.shape[1:]) != (N_CAND, N_FEATURES) \
            or coef.shape[0] < n_groups or n_groups < 1:
        raise ValueError(f"coef must be (>= n_groups, {N_CAND}, "
                         f"{N_FEATURES}) (kernels/mxu_tri.py), not "
                         f"{tuple(coef.shape)} for {n_groups} groups")
    n_rays = t_init.shape[0]
    if n_rays < 1 or t_init.ndim != 1 \
            or tuple(feats.shape) != (N_FEATURES, n_rays):
        raise ValueError(f"feats must be ({N_FEATURES}, R) and t_init (R,), "
                         f"R >= 1, not {tuple(feats.shape)} and "
                         f"{tuple(t_init.shape)}")
    return n_rays


def mxu_reference(coef, feats, t_init, *, n_groups, reps,
                  precision="default"):
    """Plain version of `mxu_kernel` and `mxu_big_kernel`: a float32
    product per group, of operands rounded to bf16 for "default"."""
    _check_tables(coef, feats, t_init, n_groups)
    coef, feats = _rounded(coef, precision), _rounded(feats, precision)
    best = _start(t_init)
    for _ in range(reps):
        for g in range(n_groups):
            best = _commit(coef[g] @ feats, g, best)
    return best


def mm_only_reference(coef, feats, t_init, *, n_groups, reps,
                      precision="default"):
    """Plain version of `mxu_big_kernel` with `mm_only`: candidate 0 of each
    group's product added into t, group after group, `reps` times."""
    _check_tables(coef, feats, t_init, n_groups)
    coef, feats = _rounded(coef, precision), _rounded(feats, precision)
    t, u, v, idx = _start(t_init)
    for _ in range(reps):
        for g in range(n_groups):
            t = t + coef[g, 0] @ feats
    return t, u, v, idx


def _split3_product(hi_lo_coef, hi_lo_feats, g):
    (ch, cl), (fh, fl) = ([x.to(torch.float32) for x in pair]
                          for pair in (hi_lo_coef, hi_lo_feats))
    return ch[g] @ fh + ch[g] @ fl + cl[g] @ fh


def split3_reference(coef, feats, t_init, *, n_groups, reps):
    """Plain version of `mxu_split3_kernel`: three float32 products of the
    bf16 parts."""
    _check_tables(coef, feats, t_init, n_groups)
    parts = split_bf16(coef), split_bf16(feats)
    best = _start(t_init)
    for _ in range(reps):
        for g in range(n_groups):
            best = _commit(_split3_product(*parts, g), g, best)
    return best


def _bf16_tables(coef, feats):
    """Row E's operands as its products see them: bf16 coef and |coef|,
    bf16 features and |features|, all back in float32. |coef| |features|
    is the sum of magnitudes, which bounds the rounding error of the
    product of rounded operands."""
    return [_rounded(x, "default") for x in (
        coef, coef.abs(), feats, feats.abs())]


def _plausible(out, mag):
    """Row E's sign test with margin, (56, R) bool, of one group's bf16
    products `out` and magnitudes `mag` (256, R): D, U, V, W could share a
    sign within MARGIN of their magnitudes."""
    D, U, V, W = (out[q * QUANT_PAD:q * QUANT_PAD + GROUP_TRIS]
                  for q in range(4))
    mD, mU, mV, mW = (mag[q * QUANT_PAD:q * QUANT_PAD + GROUP_TRIS] * MARGIN
                      for q in range(4))
    pos = (D > -mD) & (U > -mU) & (V > -mV) & (W > -mW)
    neg = (D < mD) & (U < mU) & (V < mV) & (W < mW)
    return pos | neg


def _unit_gate(ch, ca, fh, fa, g, n_units):
    """Which of the n_units units of GATE_RAYS rays pass group g's gate:
    any ray of the unit with a plausible candidate, from the whole group's
    product at once (the kernel decides it 8 triangles at a time and
    leaves at the first chunk that passes: "any" over a prefix that holds
    is "any" over all)."""
    cand = 4 * QUANT_PAD
    plaus = _plausible(ch[g, :cand] @ fh, ca[g, :cand] @ fa).any(0)
    unit = torch.zeros(n_units * GATE_RAYS, dtype=torch.bool,
                       device=fh.device)
    unit[:fh.shape[1]] = plaus
    return unit.view(n_units, GATE_RAYS).any(1)


def prefilter_reference(coef, tris_c, feats, o_c, d, t_init, *, n_groups,
                        reps):
    """Plain version of `prefilter_kernel`: per group the gate of each unit
    of GATE_RAYS rays from float32 products of the bf16-rounded operands
    (`_unit_gate`), then `vpu_reference`'s accept loop for the rays of the
    units that passed. Returns (t, u, v, idx, passed): passed (n_units,)
    int32, the groups each unit passed in one pass."""
    n_rays = _check_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups)
    ch, ca, fh, fa = _bf16_tables(coef, feats)
    dev = t_init.device
    n_units = -(-n_rays // GATE_RAYS)
    best = [t_init.clone(), torch.ones_like(t_init), torch.zeros_like(t_init),
            torch.zeros_like(t_init),
            torch.full(t_init.shape, -1, dtype=torch.int32, device=dev),
            t_init.clone()]
    lanes = torch.arange(GROUP_TRIS, dtype=torch.int32, device=dev)
    passed = torch.zeros(n_units, dtype=torch.int32, device=dev)
    for rep in range(reps):
        for g in range(n_groups):
            unit = _unit_gate(ch, ca, fh, fa, g, n_units)
            if rep == 0:
                passed += unit.to(torch.int32)
            sel = unit.repeat_interleave(GATE_RAYS)[:n_rays].nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            sub = group_accept(
                tuple(c[sel] for c in o_c), tuple(c[sel] for c in d),
                tris_c[g * GROUP_TRIS:(g + 1) * GROUP_TRIS],
                g * GROUP_TRIS + lanes, [b[sel] for b in best])
            for b, x in zip(best, sub):
                b[sel] = x
    t, td, u, v, idx, _ = best
    inv = 1.0 / td
    return t * inv, u * inv, v * inv, idx, passed


def prefilter_margin(coef, feats, idx):
    """How much of row E's margin the hits `idx` (R,) needed: for each ray
    that hits, with X the bf16 products (float64 sums of the rounded
    operands) of D, U, V, W of its triangle and m = MARGIN |coef| |feats|,
    the larger of min (X + m) / m and min (m - X) / m over the four; the
    least over the hits (inf if none). A hit passes the filter while this
    is > 0; 1 or more means it needed no margin."""
    hit = (idx >= 0).nonzero()[:, 0]
    if hit.numel() == 0:
        return float("inf")
    g = (idx[hit] // GROUP_TRIS).long()
    j = (idx[hit] % GROUP_TRIS).long()
    ch, ca, fh, fa = (x.double() for x in _bf16_tables(coef, feats))
    f, fm = fh[:, hit].T, fa[:, hit].T
    x = torch.stack([(ch[g, q * QUANT_PAD + j] * f).sum(-1)
                     for q in range(4)])
    m = torch.stack([(ca[g, q * QUANT_PAD + j] * fm).sum(-1)
                     for q in range(4)]) * MARGIN
    pos = ((x + m) / m).amin(0)
    neg = ((m - x) / m).amin(0)
    return float(torch.maximum(pos, neg).min())


def candidates_reference(coef, feats, *, n_groups, precision="default"):
    """Plain version of `mxu_candidates`: (n_groups, 320, R) float32.
    `precision` may also be "split3"."""
    if precision == "split3":
        parts = split_bf16(coef), split_bf16(feats)
        return torch.stack([_split3_product(*parts, g)
                            for g in range(n_groups)])
    return _rounded(coef[:n_groups], precision) @ _rounded(feats, precision)


# ---- wrappers ---------------------------------------------------------------

class _VpuArgs(ctypes.Structure):
    """csrc/mxu_group_kernel.cu `VpuArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "ox", "oy", "oz", "dx", "dy", "dz", "t_init", "tris", "t", "u", "v",
        "idx")] + [(n, ctypes.c_int) for n in ("n_rays", "n_groups", "reps")]


class _MxuArgs(ctypes.Structure):
    """csrc/mxu_group_kernel.cu `MxuArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "coef", "feats", "fh", "fl", "t_init", "t", "u", "v",
        "idx", "cand", "bimg", "check_out")] + [(n, ctypes.c_int) for n in (
            "n_rays", "n_groups", "reps", "mm_only", "check")]


class _PrefilterArgs(ctypes.Structure):
    """csrc/mxu_group_kernel.cu `PrefilterArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "bimg", "feats", "tris", "ox", "oy", "oz", "dx", "dy", "dz",
        "t_init", "t", "u", "v", "idx", "passed", "check_out")] + [
        (n, ctypes.c_int) for n in ("n_rays", "n_groups", "reps", "check")]


def _on_card(t_init) -> bool:
    """True if the kernels take the batch, False if the plain versions do."""
    if t_init.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no group-test kernel for device {t_init.device}")
    return t_init.device.type == "cuda"


def _outputs(n_rays, dev):
    t, u, v = (torch.empty(n_rays, dtype=torch.float32, device=dev)
               for _ in range(3))
    return t, u, v, torch.empty(n_rays, dtype=torch.int32, device=dev)


def _launch(name, symbol, args, extra, dev, count=True):
    fn = getattr(build.load("mxu_group_kernel"), symbol)
    fn.argtypes = [ctypes.POINTER(type(args))] \
        + [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), *extra,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if count:
        launches[name] += 1


def run_vpu(tris, o, d, t_init, *, n_groups, reps):
    """Row A: the scalar slot test. `tris` (>= 56 n_groups, 9) float32 in
    the `st_tris` layout (v1, e1, e2 by slot), starting on a 16-byte
    boundary (the kernel reads a group 16 bytes at a time)."""
    if tris.ndim != 2 or tris.shape[1] != 9 \
            or tris.shape[0] < n_groups * GROUP_TRIS or n_groups < 1:
        raise ValueError(f"tris must be (>= {n_groups * GROUP_TRIS}, 9), "
                         f"not {tuple(tris.shape)}")
    n_rays = t_init.shape[0]
    if n_rays < 1 or any(c.shape != (n_rays,) for c in (*o, *d)):
        raise ValueError("o, d and t_init must hold one entry per ray, and "
                         "at least one ray")
    if tris.data_ptr() % 16:
        raise ValueError("tris must start on a 16-byte boundary: the kernel "
                         "reads a group's slots 16 bytes at a time")
    if not _on_card(t_init):
        return vpu_reference(tris, o, d, t_init, n_groups=n_groups, reps=reps)
    dev, f32 = t_init.device, torch.float32
    tris_at = build.ptr(tris, f32, dev)
    # the copies live until after the launch
    rays = [c.contiguous() for c in (*o, *d, t_init)]
    out = _outputs(n_rays, dev)
    args = _VpuArgs(*(build.ptr(c, f32, dev) for c in rays), tris=tris_at,
                    t=out[0].data_ptr(), u=out[1].data_ptr(),
                    v=out[2].data_ptr(), idx=out[3].data_ptr(),
                    n_rays=n_rays, n_groups=n_groups, reps=reps)
    _launch("vpu_kernel", "pt_launch_vpu", args, (), dev)
    return out


def _run_product(name, symbol, coef, feats, t_init, n_groups, reps, *,
                 precision="default", mm_only=False, want_cand=False,
                 check_out=None):
    """Launch one of the product kernels. mxu_kernel reads its fragment
    image (mxu_tri.frag_image_of), the big form (mxu_big_kernel,
    mxu_split3_kernel) its B image (mxu_tri.b_image_of): each made at the
    table's first launch, then kept.
    `precision` "split3" also hands the kernel the features' bf16 hi and
    lo parts, made here."""
    n_rays = _check_tables(coef, feats, t_init, n_groups)
    dev, f32 = t_init.device, torch.float32
    _check_precision(precision, (*PRECISIONS, "split3"))
    # the copies and parts live until after the launch
    keep = [t_init.contiguous(), feats.contiguous()]
    build.ptr(coef, f32, dev)
    build.ptr(keep[1], f32, dev)
    args = _MxuArgs(t_init=build.ptr(keep[0], f32, dev), n_rays=n_rays,
                    n_groups=n_groups, reps=reps, mm_only=int(mm_only))
    if precision == "split3":
        parts = [p.contiguous() for p in split_bf16(keep[1])]
        keep += parts
        args.fh, args.fl = (build.ptr(p, torch.bfloat16, dev) for p in parts)
    else:
        args.feats = keep[1].data_ptr()
    if name == "mxu_kernel":
        # DUMP also reads the pad candidates from the table itself
        args.coef = coef.data_ptr()
        args.bimg = mxu_tri.frag_image_of(coef, n_groups,
                                          precision).data_ptr()
    else:
        args.bimg = mxu_tri.b_image_of(coef, n_groups, precision).data_ptr()
    out = _outputs(n_rays, dev)
    args.t, args.u, args.v, args.idx = (x.data_ptr() for x in out)
    cand = None
    if want_cand:
        cand = torch.empty((n_groups, N_CAND, n_rays), dtype=f32, device=dev)
        args.cand = cand.data_ptr()
    if check_out is not None:
        args.check_out, args.check = check_out.data_ptr(), 1
    extra = () if precision == "split3" else (int(precision == "highest"),)
    _launch(name, symbol, args, extra, dev, count=check_out is None)
    return out, cand


def run_mxu(coef, feats, t_init, *, n_groups, reps, precision="default"):
    """Row B: the product a warp's 16 rays at a time. `coef` (n_groups,
    320, 16) and `feats` (16, R) from kernels/mxu_tri.py."""
    if not _on_card(t_init):
        return mxu_reference(coef, feats, t_init, n_groups=n_groups,
                             reps=reps, precision=precision)
    return _run_product("mxu_kernel", "pt_launch_mxu", coef, feats, t_init,
                        n_groups, reps, precision=precision)[0]


# the sums of the group-test kernels' check-only PHASES instantiations, in
# the order of csrc/mxu_group_kernel.cu GP_*: mxu_kernel fills all but
# "slot"; prefilter_kernel's test is its margin test, its commit the gate's
# vote (prefilter_phase_cycles names them so)
GROUP_PHASES = ("stage", "product", "test", "commit", "slot", "warp", "sink")


def mxu_phase_cycles(coef, feats, t_init, *, n_groups, reps,
                     precision="default"):
    """`run_mxu` on the card through mxu_kernel's check-only PHASES
    instantiation: (t, u, v, idx, sums), sums mapping each of
    GROUP_PHASES to its sum over the warps (clock64() cycles; "sink" is an
    xor of the accumulators, read only to end each product). A measurement
    of the card, counted in no launch count."""
    if not _on_card(t_init):
        raise ValueError("mxu_phase_cycles measures the card: it needs "
                         "CUDA tensors")
    sums = torch.zeros(len(GROUP_PHASES), dtype=torch.int64,
                       device=t_init.device)
    out = _run_product("mxu_kernel", "pt_launch_mxu", coef, feats, t_init,
                       n_groups, reps, precision=precision,
                       check_out=sums)[0]
    return (*out, {k: v for k, v in zip(GROUP_PHASES, sums.tolist())
                   if k != "slot"})


def run_mxu_big(coef, feats, t_init, *, n_groups, reps, precision="default",
                mm_only=False):
    """Row C: one product per group over a block of rays; `mm_only` prices
    the product alone (t_init + the sum of candidate 0 over groups and
    reps comes back as t)."""
    if not _on_card(t_init):
        ref = mm_only_reference if mm_only else mxu_reference
        return ref(coef, feats, t_init, n_groups=n_groups, reps=reps,
                   precision=precision)
    return _run_product("mxu_big_kernel", "pt_launch_mxu_big", coef, feats,
                        t_init, n_groups, reps, precision=precision,
                        mm_only=mm_only)[0]


def run_mxu_split3(coef, feats, t_init, *, n_groups, reps):
    """Row D: row C with the three-pass bf16 split."""
    if not _on_card(t_init):
        return split3_reference(coef, feats, t_init, n_groups=n_groups,
                                reps=reps)
    return _run_product("mxu_split3_kernel", "pt_launch_mxu_split3", coef,
                        feats, t_init, n_groups, reps,
                        precision="split3")[0]


def run_prefilter(coef, tris_c, feats, o_c, d, t_init, *, n_groups, reps):
    """Row E: the bf16 gate, then the scalar slot test for the units that
    pass. `coef` (n_groups, 320, 16) and `feats` (16, R) as for run_mxu;
    `tris_c` and `o_c` re-centred by the table's centre
    (mxu_tri.recentre_tris, recentre_origins), `tris_c` starting on a
    16-byte boundary (the slot test reads a group 16 bytes at a time, as
    run_vpu's). Returns (t, u, v, idx, passed) as `prefilter_reference`.
    On the card the kernel reads the table's fragment image at "default"
    (mxu_tri.frag_image_of: made at the table's first launch, then kept,
    and shared with run_mxu), which the copy engine brings a group at a
    time; the gate leaves at the first chunk of 8 triangles that passes,
    which changes neither the hits nor `passed`."""
    _check_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups)
    if not _on_card(t_init):
        return prefilter_reference(coef, tris_c, feats, o_c, d, t_init,
                                   n_groups=n_groups, reps=reps)
    return _run_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups,
                          reps)


def prefilter_phase_cycles(coef, tris_c, feats, o_c, d, t_init, *, n_groups,
                           reps):
    """`run_prefilter` on the card through prefilter_kernel's check-only
    PHASES instantiation: (t, u, v, idx, passed, sums), sums mapping each
    of GROUP_PHASES to its sum over the warps (clock64() cycles), "test"
    and "commit" named "margin" and "vote". A measurement of the card,
    counted in no launch count."""
    _check_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups)
    if not _on_card(t_init):
        raise ValueError("prefilter_phase_cycles measures the card: it "
                         "needs CUDA tensors")
    sums = torch.zeros(len(GROUP_PHASES), dtype=torch.int64,
                       device=t_init.device)
    out = _run_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups, reps,
                         check_out=sums)
    names = {"test": "margin", "commit": "vote"}
    return (*out, {names.get(k, k): v
                   for k, v in zip(GROUP_PHASES, sums.tolist())})


def _run_prefilter(coef, tris_c, feats, o_c, d, t_init, n_groups, reps,
                   check_out=None):
    """Launch prefilter_kernel. Its B operand is the table's fragment image
    at "default" (mxu_tri.frag_image_of, made at the table's first launch
    and shared with run_mxu); the magnitudes are the same words with the
    sign bits cleared."""
    n_rays = t_init.shape[0]
    dev, f32 = t_init.device, torch.float32
    build.ptr(coef, f32, dev)
    image = mxu_tri.frag_image_of(coef, n_groups, "default")
    # the copies live until after the launch
    keep = [feats.contiguous(), tris_c.contiguous(),
            *(c.contiguous() for c in (*o_c, *d, t_init))]
    out = _outputs(n_rays, dev)
    passed = torch.empty(-(-n_rays // GATE_RAYS), dtype=torch.int32,
                         device=dev)
    args = _PrefilterArgs(
        image.data_ptr(), *(build.ptr(x, f32, dev) for x in keep),
        *(x.data_ptr() for x in (*out, passed)),
        n_rays=n_rays, n_groups=n_groups, reps=reps)
    if check_out is not None:
        args.check_out, args.check = check_out.data_ptr(), 1
    _launch("prefilter_kernel", "pt_launch_prefilter", args, (), dev,
            count=check_out is None)
    return (*out, passed)


def mxu_candidates(coef, feats, *, n_groups, precision="default",
                   kernel="mxu_big_kernel"):
    """Every group's product, (n_groups, 320, R) float32, as `kernel`
    ("mxu_kernel" or "mxu_big_kernel"; `mxu_split3_kernel` for precision
    "split3") computes it: its check-only instantiation writes the product
    out beside its usual work. On CPU tensors the plain
    `candidates_reference`."""
    if kernel not in ("mxu_kernel", "mxu_big_kernel"):
        raise ValueError(f"no product to write out in {kernel!r}")
    t_init = feats.new_full((feats.shape[1],), 1e30)
    if not _on_card(t_init):
        return candidates_reference(coef, feats, n_groups=n_groups,
                                    precision=precision)
    if precision == "split3":
        kernel = "mxu_split3_kernel"
    return _run_product(kernel, "pt_launch_" + kernel[:-len("_kernel")],
                        coef, feats, t_init, n_groups, 1,
                        precision=precision, want_cand=True)[1]
