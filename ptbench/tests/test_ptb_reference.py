"""The plain reference against the port's CPU route at tiny sizes: the
same frames, pixel for pixel."""

import pytest
import torch

from ptbench import bench
from ptbench.reference import tracer
from ptbench.tests.conftest import TINY


def _frames(name, seeds, index=None):
    from pathtracer0_tpu_torch.render.renderer import render_frame

    c = bench.cell(f"{name}.progressive", {"config": TINY[name]})
    dev = torch.device("cpu")
    scene, info, rc = bench.build_program_scene(c.config, c.config_module,
                                                dev)
    pos, rot = bench.camera(c.config, c.config_module)
    prog = [render_frame(scene, info, rc, pos, rot, s, device=dev)[0]
            .reshape(-1, 3) for s in seeds]
    ref_scene = bench.build_reference_scene(c.config, c.config_module, dev)
    idx = torch.arange(rc.width * rc.height) if index is None else index
    ref, _ = tracer.render_frames(ref_scene, bench.render_fields(c.config),
                                  pos, rot, idx, seeds,
                                  sum_order=c.config["route"])
    return torch.stack([p[idx] for p in prog]), ref


@pytest.mark.parametrize("name", ["hero", "terrain1m"])
def test_frames_equal_the_port(name):
    prog, ref = _frames(name, [7, 4294967295, 123456789])
    assert torch.equal(prog, ref)


def test_pixel_subset_equals_whole_frame():
    idx = torch.tensor([0, 5, 17, 100, 191])
    prog, ref = _frames("hero", [99], idx)
    assert torch.equal(prog, ref)


def test_grid_query_equals_brute_force():
    c = bench.cell("terrain1m.progressive", {"config": TINY["terrain1m"]})
    verts, faces, xs = c.config_module.mesh(c.config["mesh"])
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    rows = tracer.triangle_rows(v1, v2, v3, "cpu")
    grid = c.config_module.GridQuery(xs, v1, v2, v3, rows)
    brute = tracer.BruteQuery(*rows)
    g = torch.Generator().manual_seed(5)
    n = 400
    o = (torch.rand(n, generator=g) * 6 - 3, torch.rand(n, generator=g) * 8,
         torch.rand(n, generator=g) * 6 - 3)
    d = torch.randn(3, n, generator=g)
    d = d / d.norm(dim=0)
    alive = torch.ones(n, dtype=torch.bool)
    tg, ug, vg, ig = grid(o, tuple(d), alive)
    tb, ub, vb, ib = brute(o, tuple(d), alive)
    hit = ib >= 0
    assert 0.1 < float(hit.float().mean()) < 0.9
    assert torch.equal(ig, ib)
    assert torch.equal(tg[hit], tb[hit])


def test_display_is_the_running_mean():
    f = torch.rand(5, 4, 3)
    acc = torch.zeros(4, 3)
    for k in range(5):
        acc = acc + f[k]
    assert torch.equal(tracer.display(f), acc / 5.0)


def test_bfloat16_reference_runs():
    c = bench.cell("hero.progressive", {"config": TINY["hero"]})
    dev = torch.device("cpu")
    ref = bench.build_reference_scene(c.config, c.config_module, dev)
    pos, rot = bench.camera(c.config, c.config_module)
    idx = torch.arange(192)
    lo, _ = tracer.render_frames(ref.to(torch.bfloat16),
                                 bench.render_fields(c.config), pos, rot,
                                 idx, [3], dtype=torch.bfloat16)
    hi, _ = tracer.render_frames(ref, bench.render_fields(c.config), pos,
                                 rot, idx, [3])
    assert lo.dtype == torch.bfloat16
    assert bool(torch.isfinite(lo.float()).all())
    assert not torch.equal(lo.float(), hi)


def test_matching_non_finite_pixels_agree():
    from ptbench import check
    from ptbench.drive import Image

    ims = [Image("full", (0.0,) * 3, (0.0,) * 3, [1], None, None)]
    r = torch.tensor([[1.0, 2.0, float("nan")], [0.5, 0.5, float("inf")]])
    p = r.clone()
    p[1, 0] += 0.01
    err = check.numbers(ims, [p], [r])[0]["err.full"]
    assert err == pytest.approx(0.01 / 4.0)
    p[0, 2] = 1.0
    assert check.numbers(ims, [p], [r])[0]["err.full"] == float("inf")


def test_each_image_draws_its_own_pixels():
    from ptbench.drive import pixels

    dev = torch.device("cpu")
    a, b, c = (pixels(9, k, 1920, 1080, 512, "full", dev) for k in (0, 1, 0))
    first = pixels(9, 0, 1920, 1080, 512, "first", dev)
    assert torch.equal(a, c)
    assert len(set(a.tolist()) & set(b.tolist())) < 8
    assert len(set(a.tolist()) & set(first.tolist())) < 8
    assert torch.equal(a, torch.unique(a)) and a.numel() == 512
