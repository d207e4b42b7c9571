"""The port's small-K product probe (kernels/mm_probe.py,
tools/diag_mxu_mm.py) against the JAX package's tools/diag_mxu_mm.py `run`,
its Pallas kernel `_kernel` run in interpret mode, on the CPU.

The JAX tool is imported by path (`tools/` is no package); its launcher
takes no `interpret` argument, so the module fixture wraps
`jax.experimental.pallas.pallas_call` with `interpret=True` while it traces.
On the CPU JAX computes `precision=None` in full float32, so for "default"
the JAX kernel is fed operands already rounded to bf16; the bf16 cases get
bf16 operands on both sides.

Tolerance: within 2^-20 of the sum of magnitudes |a| |b| of each output:
both sides multiply the same float32 (or bf16-rounded) operands, and only
the order of the float32 sums differs.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pathtracer0_tpu_torch.kernels import mm_probe
from pathtracer0_tpu_torch.tools import diag_mxu_mm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, REPS = 128, 3
CASES = diag_mxu_mm.cases()


@pytest.fixture(scope="module")
def jtool():
    """tools/diag_mxu_mm.py of the JAX package with its kernel in interpret
    mode."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_mxu_mm", os.path.join(ROOT, "tools", "diag_mxu_mm.py"))
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


def _operands(form, dtype):
    ops = diag_mxu_mm.operands(N, "cpu")
    return ops[form.split("_")[0]].to(dtype), ops["b"].to(dtype)


def _to_jax(x):
    """A torch tensor as a JAX array of its dtype."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("case", range(len(CASES)))
def test_probe_against_jax_kernel(case, jtool):
    form, precision, dtype = CASES[case]
    a, b = _operands(form, dtype)
    before = dict(mm_probe.launches)
    got = mm_probe.run(a, b, reps=REPS, form=form, precision=precision)
    assert mm_probe.launches == before      # CPU tensors: the plain version
    assert got.shape == (8, N) and got.dtype == torch.float32
    ja, jb = a, b
    if precision == "default" and dtype == torch.float32:
        ja, jb = (x.to(torch.bfloat16).float() for x in (a, b))
    prec = jax.lax.Precision.HIGHEST if precision == "highest" else None
    want = np.asarray(jtool.run(_to_jax(ja), _to_jax(jb), reps=REPS,
                                form=form, prec=prec))
    mag = mm_probe.magnitudes(a, b, reps=REPS, form=form).numpy()
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= 2.0 ** -20 * mag), (err / mag).max()
    assert np.abs(want).max() > 1.0


def test_probe_forms_read_their_slices():
    """Each form on hand-made operands: "fix" reads slice 0 every rep,
    "dyn" slice rep % 8; "tlhs" contracts a's rows (its transpose), "std"
    its columns; rows 0-7 come out."""
    rng = np.random.RandomState(3)
    b = torch.from_numpy(rng.randn(16, 5).astype(np.float32))
    a_t = torch.from_numpy(rng.randn(128, 320).astype(np.float32))
    a_s = torch.from_numpy(rng.randn(2560, 16).astype(np.float32))
    reps = 10
    for form, a, sl in (("tlhs", a_t, lambda s: a_t[16 * s:16 * s + 16].T),
                        ("std", a_s, lambda s: a_s[320 * s:320 * s + 320])):
        for kind in ("dyn", "fix"):
            want = sum(sl(r % 8 if kind == "dyn" else 0).double()[:8]
                       @ b.double() for r in range(reps))
            got = mm_probe.run(a, b, reps=reps, form=f"{form}_{kind}",
                               precision="highest")
            assert torch.allclose(got.double(), want, rtol=0, atol=1e-4)
    assert torch.equal(mm_probe.run(a_s, b, reps=0, form="std_fix"),
                       torch.zeros(8, 5))


@pytest.mark.parametrize("n", [1, 33, 1024, 8200, 135136, 135137, 480000])
def test_probe_launch_shape_covers_every_column(n):
    """The probe's launch on a card of 132 multiprocessors: two M tiles a
    warp from the column count at which the 32-column units fill every
    warp of the largest grid (4,224 warps in 2 x 132 blocks of 16: from
    135,137 columns), one below it; a block for each unit up to that grid,
    so no block is without a unit; and the warps' units, dealt to the
    blocks first, take every column once."""
    m_tiles, blocks = mm_probe.launch_shape(n, 132)
    cap = mm_probe.BLOCKS_PER_SM * 132
    assert m_tiles == (2 if n > 32 * (cap * mm_probe.WARPS_PER_BLOCK - 1)
                       else 1)
    units = -(-n // (16 * m_tiles))
    assert blocks == min(units, cap) and 1 <= blocks <= cap
    warps = blocks * mm_probe.WARPS_PER_BLOCK
    taken = torch.zeros(units, dtype=torch.int32)
    for block in range(blocks):
        for warp in range(mm_probe.WARPS_PER_BLOCK):
            taken[block + warp * blocks::warps] += 1
    assert bool((taken == 1).all())


def test_probe_refuses_what_it_does_not_take():
    a, b = _operands("std_fix", torch.float32)
    with pytest.raises(ValueError, match="form"):
        mm_probe.run(a, b, reps=1, form="std")
    with pytest.raises(ValueError, match="precision"):
        mm_probe.run(a, b, reps=1, form="std_fix", precision="tf32")
    with pytest.raises(ValueError, match="tlhs_fix takes"):
        mm_probe.run(a, b, reps=1, form="tlhs_fix")
    with pytest.raises(ValueError, match="both"):
        mm_probe.run(a, b.to(torch.bfloat16), reps=1, form="std_fix")
    with pytest.raises(ValueError, match="bf16"):
        mm_probe.run(a.to(torch.bfloat16), b.to(torch.bfloat16), reps=1,
                     form="std_fix", precision="highest")
    with pytest.raises(ValueError, match="no probe kernel"):
        mm_probe.run(a.to("meta"), b.to("meta"), reps=1, form="std_fix")
    assert set(mm_probe.launches) == {"mm_probe_kernel"}


def test_probe_tool_on_the_cpu(capsys):
    """The tool end to end on the CPU: every case of the JAX tool's list and
    the library's two rows, no time measured off the card."""
    rows = diag_mxu_mm.main(64, 2, device="cpu")
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == len(rows) == len(CASES) + 2
    assert all(r["us_per_product"] is None and r["device"] == "cpu"
               for r in rows)
    assert [r["form"] for r in rows[-2:]] == ["torch.matmul"] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            diag_mxu_mm.main(64, 1)
