"""The small-K product probe: what one (320, 16) x (16, N) product costs in
each operand layout the group-test kernels could use.

Counterpart of the JAX package's tools/diag_mxu_mm.py `run` and its Pallas
kernel `_kernel`: o (8, N) float32 is the sum over `reps` of rows 0-7 of
the product of slice s of `a` with `b` (16, N), s = rep % 8 for the "dyn"
forms and 0 for the "fix" ones:

  tlhs_dyn, tlhs_fix  a (128, 320): slice s is rows [16 s, 16 s + 16), and
                      the product is its transpose times b (K-major operand)
  std_dyn, std_fix    a (2560, 16): slice s is rows [320 s, 320 s + 320),
                      the product is slice times b (M-major operand)

`precision` "default" rounds both operands to bf16 (one tensor-core pass);
"highest" keeps float32 accuracy (on the card the three-pass TF32 split of
csrc/mxu_group_kernel.cu). `a` and `b` may also come in bfloat16, with
"default" only: the JAX tool's bf16 cases. The kernel multiplies all 320
rows every rep, though only 8 reach `o`.

On the card each block reads the slices a launch needs once from `a` in
its own layout (min(reps, 8) for "dyn", one for "fix") and writes them to
shared memory in `mma.sync`'s B-fragment order, so a form's layout costs
only in that staging; its warps then loop over the columns, 16 or 32 at a
time (`launch_shape`).

CUDA tensors go through csrc/mxu_group_kernel.cu `mm_probe_kernel` and
nothing else, CPU tensors through `mm_probe_reference`. `launches` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

FORMS = ("tlhs_dyn", "tlhs_fix", "std_dyn", "std_fix")
PRECISIONS = ("default", "highest")
SLICES, M, K = 8, 320, 16
SHAPES = {"tlhs": (SLICES * K, M), "std": (SLICES * M, K)}
# csrc/mxu_group_kernel.cu mm_probe_kernel: warps a block (PROBE_WARPS),
# and blocks an SM at most (`launch_shape`)
WARPS_PER_BLOCK, BLOCKS_PER_SM = 16, 2

launches = {"mm_probe_kernel": 0}


def _check(a, b, reps, form, precision):
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, not {form!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"not {precision!r}")
    layout = form.split("_")[0]
    if tuple(a.shape) != SHAPES[layout] or b.ndim != 2 or b.shape[0] != K \
            or b.shape[1] < 1 or reps < 0:
        raise ValueError(f"{form} takes a {SHAPES[layout]} and b (16, N), "
                         f"not {tuple(a.shape)} and {tuple(b.shape)}")
    dtypes = {a.dtype, b.dtype}
    if dtypes not in ({torch.float32}, {torch.bfloat16}):
        raise ValueError("a and b must both be float32 or both bfloat16")
    if a.dtype == torch.bfloat16 and precision != "default":
        raise ValueError("bf16 operands take precision 'default' only")


def _slice(a, form, s):
    """Slice s of `a` as the (320, 16) operand of the product."""
    if form.startswith("tlhs"):
        return a[K * s:K * (s + 1)].T
    return a[M * s:M * (s + 1)]


def launch_shape(n, sms):
    """(m_tiles, blocks) of mm_probe_kernel's launch over `n` columns on a
    card of `sms` multiprocessors: two M tiles of 16 columns a warp, which
    share each B load, where the 32-column units fill every warp of the
    largest grid, else one, which spreads a narrow launch over more
    multiprocessors; a block for each unit, at most BLOCKS_PER_SM an SM."""
    cap = BLOCKS_PER_SM * sms
    m_tiles = 2 if -(-n // 32) >= cap * WARPS_PER_BLOCK else 1
    return m_tiles, min(-(-n // (16 * m_tiles)), cap)


def mm_probe_reference(a, b, *, reps, form, precision="default"):
    """Plain version of `mm_probe_kernel`: float32 products of the operands
    as the precision sees them (bf16-rounded for "default"), rows 0-7
    added rep after rep."""
    _check(a, b, reps, form, precision)
    if precision == "default":
        a, b = (x.to(torch.bfloat16) for x in (a, b))
    a, b = a.to(torch.float32), b.to(torch.float32)
    o = torch.zeros((8, b.shape[1]), dtype=torch.float32, device=b.device)
    for rep in range(reps):
        s = rep % SLICES if form.endswith("dyn") else 0
        o = o + _slice(a, form, s)[0:8] @ b
    return o


def magnitudes(a, b, *, reps, form):
    """The sum of magnitudes |a| |b| of `o`, in float64: what a product's
    rounding error is measured against."""
    a, b = a.to(torch.float64).abs(), b.to(torch.float64).abs()
    o = torch.zeros((8, b.shape[1]), dtype=torch.float64, device=b.device)
    for rep in range(reps):
        s = rep % SLICES if form.endswith("dyn") else 0
        o = o + _slice(a, form, s)[0:8] @ b
    return o


class _ProbeArgs(ctypes.Structure):
    """csrc/mxu_group_kernel.cu `ProbeArgs`, field for field."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "a", "feats", "b16", "o", "sink")] + [
        (n, ctypes.c_int) for n in ("n_rays", "reps", "n_blocks",
                                    "m_tiles")]


def run(a, b, *, reps, form, precision="default"):
    """o (8, N) float32 of `a` and `b` (module docstring): the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(a, b, reps, form, precision)
    dev = b.device
    if dev.type == "cpu":
        return mm_probe_reference(a, b, reps=reps, form=form,
                                  precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    in_bf16 = a.dtype == torch.bfloat16
    n = b.shape[1]
    # the copies live until after the launch
    keep = [a.contiguous(), b.contiguous()]
    o = torch.empty((8, n), dtype=torch.float32, device=dev)
    m_tiles, blocks = launch_shape(
        n, torch.cuda.get_device_properties(dev).multi_processor_count)
    sink = torch.empty(blocks * WARPS_PER_BLOCK * 32, dtype=torch.float32,
                       device=dev)
    args = _ProbeArgs(a=build.ptr(keep[0], a.dtype, dev), o=o.data_ptr(),
                      sink=sink.data_ptr(), n_rays=n, reps=reps,
                      n_blocks=blocks, m_tiles=m_tiles)
    if in_bf16:
        args.b16 = build.ptr(keep[1], torch.bfloat16, dev)
    else:
        args.feats = build.ptr(keep[1], torch.float32, dev)
    fn = build.load("mxu_group_kernel").pt_launch_mm_probe
    fn.argtypes = [ctypes.POINTER(_ProbeArgs)] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), int(form.startswith("tlhs")),
             int(form.endswith("dyn")), int(precision == "highest"),
             int(in_bf16),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"mm_probe_kernel launch failed: CUDA error {err}")
    launches["mm_probe_kernel"] += 1
    return o
