"""Probe: what one small-K product (320, 16) x (16, N) costs on the tensor
cores in each operand layout.

Counterpart of the JAX package's tools/diag_mxu_mm.py. It prices the
operand forms of the group-test products (kernels/mm_probe.py): the
(320, 16) operand K-major and transposed ("tlhs") or M-major ("std"), a
slice that moves every rep ("dyn") or stays ("fix"), at precision "default"
(bf16, one pass) and "highest" (three TF32 passes), and with both operands
already in bf16 (the tool's two bf16 cases). Each case reports
microseconds per product by the difference of a launch of 4 x reps and one
of reps products (CUDA events: launch, prologue and epilogue cancel), and
`torch.matmul` of the same product, once in float32 and once in bf16, as
the library's figure.

Run:  python -m pathtracer0_tpu_torch.tools.diag_mxu_mm [N] [reps]
                                        [--device cpu]

with N = 1,024 and reps = 512 unless given (the JAX tool's shape). It runs
on the card and raises without one; `--device cpu` runs the plain version
(keep it tiny) and measures no time.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import mm_probe
from .diag_mxu import _event_ms


def operands(n=1024, device=None):
    """The tool's operands from np.random.RandomState(0): b (16, N), the
    K-major a (128, 320) and the M-major a (2560, 16), float32."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    b = rng.randn(16, n).astype(np.float32)
    a_t = rng.randn(8 * 16, 320).astype(np.float32)
    a_s = rng.randn(8 * 320, 16).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in (("b", b), ("tlhs", a_t), ("std", a_s))}


def cases():
    """(form, precision, operand dtype) of the JAX tool's list (:66-78):
    every form at "default" and "highest" in float32, then std_fix and
    tlhs_fix with bf16 operands."""
    out = [(form, precision, torch.float32)
           for precision in mm_probe.PRECISIONS for form in mm_probe.FORMS]
    return out + [("std_fix", "default", torch.bfloat16),
                  ("tlhs_fix", "default", torch.bfloat16)]


def main(n=1024, reps=512, *, device=None, data=None, out=print):
    """Run every case and the library's product; return the rows as a
    list of dicts. `data` replaces `operands(n)`."""
    if data is None:
        data = operands(n, device)
    b = data["b"]
    dev = b.device
    on_card = dev.type == "cuda"
    n = b.shape[1]
    rows = []

    def emit(row):
        rows.append(row)
        out(json.dumps(row))

    for form, precision, dtype in cases():
        a = data[form.split("_")[0]].to(dtype)
        bb = b.to(dtype)
        row = {"form": form, "precision": precision,
               "dtype": str(dtype).replace("torch.", ""), "n": n,
               "reps": reps, "device": str(dev), "us_per_product": None}

        def fn(r, a=a, bb=bb, form=form, precision=precision):
            return mm_probe.run(a, bb, reps=r, form=form,
                                precision=precision)

        if on_card:
            d1 = _event_ms(lambda: fn(reps))
            d4 = _event_ms(lambda: fn(4 * reps))
            row.update(ms_reps=d1, ms_4_reps=d4,
                       us_per_product=(d4 - d1) * 1e3 / (3 * reps))
        else:
            fn(reps)
        emit(row)
    # the library's figure: torch.matmul of the same whole product, `reps`
    # calls in a row (it writes all 320 rows)
    for dtype in (torch.float32, torch.bfloat16):
        a = data["std"][:mm_probe.M].to(dtype)
        bb = b.to(dtype)
        row = {"form": "torch.matmul", "dtype": str(dtype).replace(
            "torch.", ""), "n": n, "reps": reps, "device": str(dev),
            "us_per_product": None}
        if on_card:
            prod = torch.empty((mm_probe.M, n), dtype=dtype, device=dev)

            def calls(a=a, bb=bb, prod=prod):
                for _ in range(reps):
                    torch.matmul(a, bb, out=prod)

            row["us_per_product"] = 1e3 * _event_ms(calls) / reps
        emit(row)
    return rows


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1024)
    ap.add_argument("reps", nargs="?", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    main(args.n, args.reps, device=args.device)


if __name__ == "__main__":
    _cli()
