"""The plain reference against the port's CPU route at tiny sizes: the
same frames, pixel for pixel, for every configuration of BENCHMARK.json."""

import pytest
import torch

from ptbench import bench
from ptbench.reference import tracer
from ptbench.tests.conftest import CONFIGS, tiny_config, workload_of


def _cell(name):
    return bench.cell(workload_of(name), {"config": tiny_config(name)})


def _frames(name, seeds, index=None):
    from pathtracer0_tpu_torch.render.renderer import render_frame

    c = _cell(name)
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


@pytest.mark.parametrize("name", CONFIGS)
def test_frames_equal_the_port(name):
    prog, ref = _frames(name, [7, 4294967295, 123456789])
    assert torch.equal(prog, ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_pixel_subset_equals_whole_frame(name):
    r = bench.render_fields(_cell(name).config)
    n = r["width"] * r["height"]
    idx = torch.unique(torch.tensor([0, 5, 17, n // 2, n - 1]) % n)
    prog, ref = _frames(name, [99], idx)
    assert torch.equal(prog, ref)


def _queried():
    return [n for n in CONFIGS
            if hasattr(_cell(n).config_module, "reference_query")]


@pytest.mark.parametrize("name", _queried())
def test_grid_query_equals_brute_force(name):
    """A configuration's own scene query against every triangle, on rays
    in every direction from a box that holds the mesh's bounds and much
    room around them: origins beside the mesh's footprint, below its
    surface and above it, so that the query's clamped entry through the
    sides and its hits on the underside are tested too."""
    c = _cell(name)
    verts, faces, extra = c.config_module.mesh(c.config["mesh"])
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    rows = tracer.triangle_rows(v1, v2, v3, "cpu")
    query = c.config_module.reference_query(c.config["mesh"], verts, faces,
                                            extra, rows)
    brute = tracer.BruteQuery(*rows)
    lo, hi = verts.min(0), verts.max(0)
    half = (hi - lo) / 2.0
    g = torch.Generator().manual_seed(5)
    n = 400
    # x, z: mid -/+ 1.3 half; y: lo - 1.5 half to hi + 2 half
    below, above = (0.3, 1.5, 0.3), (0.3, 2.0, 0.3)
    o = tuple(float(lo[a] - below[a] * half[a])
              + torch.rand(n, generator=g)
              * float(hi[a] - lo[a] + (below[a] + above[a]) * half[a])
              for a in range(3))
    d = torch.randn(3, n, generator=g)
    d = d / d.norm(dim=0)
    alive = torch.ones(n, dtype=torch.bool)
    tg, ug, vg, ig = query(o, tuple(d), alive)
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


@pytest.mark.parametrize("name", CONFIGS)
def test_bfloat16_reference_runs(name):
    c = _cell(name)
    dev = torch.device("cpu")
    ref = bench.build_reference_scene(c.config, c.config_module, dev)
    pos, rot = bench.camera(c.config, c.config_module)
    r = bench.render_fields(c.config)
    idx = torch.arange(min(192, r["width"] * r["height"]))
    lo, _ = tracer.render_frames(ref.to(torch.bfloat16),
                                 bench.render_fields(c.config), pos, rot,
                                 idx, [3], dtype=torch.bfloat16)
    hi, _ = tracer.render_frames(ref, bench.render_fields(c.config), pos,
                                 rot, idx, [3])
    assert lo.dtype == torch.bfloat16
    if not c.config.get("implicits"):
        # an implicit surface's normal is a forward difference at 1e-4,
        # which vanishes in bfloat16 (x + 1e-4 == x): a zero gradient, a
        # NaN normal, and NaN pixels where a path meets the surface
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
