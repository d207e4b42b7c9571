"""Microbenchmark: the scalar slot test against the group test as a matrix
product on the tensor cores.

Counterpart of the JAX package's tools/diag_mxu.py, rows A to E. Five
kernels with the same meaning, the closest hit of a batch of rays against
G groups of 56 leaf-packed triangles (kernels/mxu_group.py):

  A  vpu rows     the streamed route's division-free slot test
  B  mxu rows     per group a (16 rays, 16 features) x (16, 320) product a
                  warp, at "highest" (three-pass TF32 split) and "default"
                  (bf16) precision
  C  mxu big      one product per group over a block of 128 rays, staged in
                  shared memory before the test; also `mm_only`, the product
                  alone
  D  mxu split3   C with the manual three-pass bf16 split
  E  prefilter    a bf16 product and its magnitudes as a conservative
                  filter per warp of 32 rays, then A's slot test on
                  re-centred inputs for the warps that pass

For each row: microseconds per group and 1,024 rays, by the difference of
a launch of 4 x reps and one of reps passes (CUDA events; launch, prologue
and epilogue cancel), and against row A the share of rays that hit, the
share whose idx differs and the largest |dt| where both hit. Row E also
gives the share of (warp, group) pairs that passed its gate, the hits of A
it lost (the filter must lose none) and how much of its margin A's hits
needed (`mxu_group.prefilter_margin`: above 0 passes, 1 or more needed
none).

Run:  python -m pathtracer0_tpu_torch.tools.diag_mxu [n_groups] [reps]
                                    [--n-blocks 16] [--device cpu]

with n_groups = 32 (one treelet), reps = 64 and 16 blocks of 1,024 rays
unless given.

It runs on the card and raises without one; `--device cpu` runs the plain
PyTorch versions (keep it tiny), checks the rows against each other and
measures no time.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import mxu_group, mxu_tri

T_INIT = 1e30
RAY_BLOCK = 1024      # the unit of the timing: one group against 1,024 rays


def synthetic(n_groups=32, n_blocks=16, device=None):
    """The tool's data, from np.random.RandomState(0): triangles with v1 in
    [100, 200]^3 and edges in [-2, 2]^3, every 37th slot empty; n_blocks x
    1,024 rays from [100, 200]^3 with normal directions; centre 150."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    slots = n_groups * mxu_tri.GROUP_TRIS
    v1 = rng.uniform(100, 200, (slots, 3)).astype(np.float32)
    e1 = rng.uniform(-2, 2, (slots, 3)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (slots, 3)).astype(np.float32)
    tris = np.concatenate([v1, e1, e2], 1)
    tris[::37] = 0.0
    n_rays = n_blocks * RAY_BLOCK
    o = rng.uniform(100, 200, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return {
        "tris": torch.from_numpy(tris).to(dev),
        "o": tuple(torch.from_numpy(o[:, i].copy()).to(dev) for i in range(3)),
        "d": tuple(torch.from_numpy(d[:, i].copy()).to(dev) for i in range(3)),
        "center": (150.0, 150.0, 150.0),
    }


def aim(data, seed=11, spread=0.3):
    """`data` with every ray turned towards the centroid of a non-empty
    triangle drawn from `seed`, `spread` of normal noise added, so that
    about half the rays hit (the tool's own hit one time in twenty): (data,
    centroids as an (R, 3) float64 array)."""
    rng = np.random.RandomState(seed)
    tris = data["tris"].cpu().numpy()
    o = np.stack([c.cpu().numpy() for c in data["o"]], 1)
    live = np.flatnonzero(np.abs(tris).max(axis=1) > 0)
    pick = live[rng.randint(0, live.size, o.shape[0])]
    centroid = tris[pick, 0:3] + (tris[pick, 3:6] + tris[pick, 6:9]) / 3.0
    d = centroid + rng.normal(size=o.shape) * spread - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dev = data["tris"].device
    return {**data, "d": tuple(torch.from_numpy(d[:, i].copy()).to(dev)
                               for i in range(3))}, centroid


def _event_ms(fn):
    """Least CUDA-event time of three calls of `fn`, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


def main(n_groups=32, reps=64, *, n_blocks=16, device=None, data=None,
         out=print):
    """Run rows A to E and return them as a list of dicts. `data`, if
    given, replaces `synthetic(n_groups, n_blocks)`: a dict of `tris`
    (>= 56 n_groups, 9), `o`, `d` ((x, y, z) tuples of (R,) tensors) and
    `center`, on one device."""
    if data is None:
        data = synthetic(n_groups, n_blocks, device)
    tris, o, d, center = (data[k] for k in ("tris", "o", "d", "center"))
    dev = tris.device
    on_card = dev.type == "cuda"
    n_rays = o[0].shape[0]
    coef = mxu_tri.coef_table(tris[:n_groups * mxu_tri.GROUP_TRIS], center)
    feats = mxu_tri.ray_features(o, d, center)
    t_init = torch.full((n_rays,), T_INIT, dtype=torch.float32, device=dev)
    rows = []

    def bench(label, fn, check_against=None, hits=True, more=None):
        row = {"row": label, "n_groups": n_groups, "rays": n_rays,
               "reps": reps, "device": str(dev),
               "us_per_group_1024_rays": None}
        if on_card:
            d1 = _event_ms(lambda: fn(reps))
            d4 = _event_ms(lambda: fn(4 * reps))
            row.update(
                ms_reps=d1, ms_4_reps=d4,
                us_per_group_1024_rays=(d4 - d1) * 1e3 / (3 * reps)
                / (n_groups * n_rays / RAY_BLOCK))
        result = fn(reps)
        if hits:
            row["hits"] = float((result[3] >= 0).float().mean())
        if check_against is not None:
            ta, ia = check_against[0], check_against[3]
            tb, ib = result[0], result[3]
            both = (ia >= 0) & (ib >= 0)
            row.update(
                hits_a=float((ia >= 0).float().mean()),
                idx_mismatch=float((ia != ib).float().mean()),
                max_abs_dt=float((ta - tb).abs()[both].max())
                if bool(both.any()) else 0.0)
        if more is not None:
            row.update(more(result))
        rows.append(row)
        out(json.dumps(row))
        return result

    kw = dict(n_groups=n_groups)
    a = bench("A vpu rows", lambda r: mxu_group.run_vpu(
        tris, o, d, t_init, reps=r, **kw))
    for precision in mxu_group.PRECISIONS:
        bench(f"B mxu rows ({precision})", lambda r: mxu_group.run_mxu(
            coef, feats, t_init, reps=r, precision=precision, **kw), a)
        bench(f"C mxu big mm-only ({precision})",
              lambda r: mxu_group.run_mxu_big(
                  coef, feats, t_init, reps=r, precision=precision,
                  mm_only=True, **kw), hits=False)
        bench(f"C mxu big ({precision})", lambda r: mxu_group.run_mxu_big(
            coef, feats, t_init, reps=r, precision=precision, **kw), a)
    bench("D mxu split3 (manual bf16 x 3)",
          lambda r: mxu_group.run_mxu_split3(coef, feats, t_init, reps=r,
                                             **kw), a)
    # E reads the triangles and origins in the frame the features use
    tris_c = mxu_tri.recentre_tris(tris[:n_groups * mxu_tri.GROUP_TRIS],
                                   center)
    o_c = mxu_tri.recentre_origins(o, center)

    def gate(result):
        passed = result[4]
        return {"gate_pass_share": float(passed.sum())
                / (passed.numel() * n_groups),
                "hits_of_a_lost": int(((a[3] >= 0) & (result[3] < 0)).sum()),
                "margin_ratio": mxu_group.prefilter_margin(coef, feats,
                                                           a[3])}

    bench("E bf16 prefilter + vpu", lambda r: mxu_group.run_prefilter(
        coef, tris_c, feats, o_c, d, t_init, reps=r, **kw), a, more=gate)
    return rows


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_groups", nargs="?", type=int, default=32)
    ap.add_argument("reps", nargs="?", type=int, default=64)
    ap.add_argument("--n-blocks", type=int, default=16,
                    help="blocks of 1,024 rays")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    main(args.n_groups, args.reps, n_blocks=args.n_blocks, device=args.device)


if __name__ == "__main__":
    _cli()
