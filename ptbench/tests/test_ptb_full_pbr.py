"""BASELINE config 4 (full PBR: a clearcoat, a dense glass, a rotated
ellipsoid of rough subsurface material, an implicit surface) through the
harness at the CPU size: the scene of `full_pbr.json` put into a cell of
BENCHMARK.json as its `overrides`, with no cell of its own. The sound run
is exact: the reference renders the frames of the port's CPU route bit
for bit, implicits and rotated ellipsoids too. A fault of the geometry is
not correct in the close view, where the primitive it breaks fills much
of the image (in the configuration's own view at 16 x 12 the implicit
takes one pixel of 192, and half the march reads 2e-8)."""
import json
from pathlib import Path

import pytest
import torch

from ptbench import bench, faults
from ptbench.reference import implicits as ref_implicits
from ptbench.run import run_cell
from ptbench.tests.conftest import tiny

FULL_PBR = json.loads((Path(__file__).parent / "full_pbr.json").read_text())


def overrides(view=None):
    """The overrides that render config 4 in FULL_PBR's cell at its CPU
    size, from the configuration's camera or the close view."""
    t = tiny(FULL_PBR["cell"])
    config = bench.merge(FULL_PBR["config"], t["config"])
    if view == "close":
        v = FULL_PBR["close_view"]
        config["camera"] = {"pos": v["pos"], "rot": v["rot"]}
    return {"config": config, "mix": t["mix"]}


def _run(seed, view=None):
    return run_cell(FULL_PBR["cell"], seed, 1.0, False, device="cpu",
                    overrides=overrides(view), log=lambda *a: None)


@pytest.mark.parametrize("view", [None, "close"])
def test_sound_run_is_exact(view):
    out = _run(2 ** 31 + 17, view)
    assert out["correct"], out["checks"]
    assert all(v["value"] == 0.0 for v in out["checks"].values())


@pytest.mark.parametrize("fault", faults.GEOMETRY_FAULTS)
def test_geometry_fault_is_not_correct(fault):
    assert faults.applies(fault, FULL_PBR["config"])
    undo = faults.plant(fault)
    try:
        out = _run(4242, "close")
    finally:
        undo()
    assert not out["correct"], out["checks"]


def test_march_constants_equal_the_port():
    from pathtracer0_tpu_torch.shade import implicits

    assert ref_implicits.LATTICE_STEPS == implicits.MARCH_STEPS
    assert ref_implicits.BISECTIONS == implicits.BISECT_ITERS
    assert ref_implicits.T_MAX == implicits.MARCH_TMAX
    assert ref_implicits.NORMAL_H == implicits.GRAD_H


@pytest.mark.parametrize("fn", range(1, 11))
def test_march_and_normal_equal_the_port(fn):
    """Each of the 10 surfaces: the reference's march and normal give the
    port's plain march's bits on rays about the surface's origin."""
    from pathtracer0_tpu_torch.shade import implicits

    g = torch.Generator().manual_seed(fn)
    n = 512
    o = tuple(torch.rand(n, generator=g) * 16.0 - 8.0 for _ in range(3))
    d = torch.randn(3, n, generator=g)
    d = tuple(d / d.norm(dim=0))
    t, found = ref_implicits.march(fn, o, d)
    tp, foundp = implicits.march(fn, *o, *d)
    assert torch.equal(found, foundp)
    assert torch.equal(t[found], tp[found])
    p = tuple(o[i][found] + d[i][found] * t[found] for i in range(3))
    for a, b in zip(ref_implicits.gradient(fn, p),
                    implicits.gradient_soa(fn, *p)):
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b))
        assert torch.equal(a[~nan], b[~nan])


def test_march_takes_the_whole_lattice(monkeypatch):
    """No sample is skipped: each ray evaluates the first value, every
    lattice sample, the bracket's low end and each bisection, whether or
    not a root is near (a ray far outside surface 1's sphere, one through
    it)."""
    points = []
    real = ref_implicits.surface

    def counted(fn, x, y, z):
        points.append(x.numel())
        return real(fn, x, y, z)

    monkeypatch.setattr(ref_implicits, "surface", counted)
    o = (torch.tensor([90.0, -9.0]), torch.tensor([90.0, 0.0]),
         torch.tensor([90.0, 0.0]))
    d = (torch.tensor([1.0, 1.0]), torch.tensor([0.0, 0.0]),
         torch.tensor([0.0, 0.0]))
    t, found = ref_implicits.march(1, o, d)
    assert found.tolist() == [False, True]
    assert sum(points) == 2 * (1 + ref_implicits.LATTICE_STEPS + 1
                               + ref_implicits.BISECTIONS)


@pytest.mark.parametrize("fn", [0, 11])
def test_check_config_refuses_an_unknown_surface(fn):
    config = json.loads(json.dumps(FULL_PBR["config"]))
    config["implicits"][0]["fn"] = fn
    with pytest.raises(ValueError, match="1..10"):
        bench.check_config(config)
