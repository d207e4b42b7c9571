"""The port's run tools (pathtracer0_tpu_torch/tools: profile,
diag_streamed, diag_scale_frame, diag_build4m, run_hero_full) against the
JAX package's tools of the same names, on the CPU at tiny sizes.

Tolerances:
  the terrain's triangles, the tools' rays and the origin-major sort key:
  bit-equal;
  streamed hits (the JAX `_streamed_kernel` in interpret mode against the
  port's `streamed_reference`, the rays as `run` sorts them): triangle id
  equal on >= 99.9% of rays (one t on a shared edge may go to either
  neighbour), t within 1e-5 where the ids agree, the hit share equal;
  live queries of a frame: within 1% + 16 of the JAX package's
  (tests/test_fused.py's limit: knife-edge rays diverge);
  the profile rows' RenderConfig: every field both packages have equal;
  the hero run's accumulation: bit-equal to the port's Renderer of the
  same seed (the same calls), its checkpoint loaded by the JAX Renderer
  bit for bit, and the repo-root HERO_RUN.json unchanged.
"""
import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Renderer as JRenderer
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu import scenes as jscenes
from pathtracer0_tpu.kernels import traverse as jtraverse
from pathtracer0_tpu.kernels import wavefront as jwavefront
from pathtracer0_tpu.render.renderer import render_frame as jrender_frame
from pathtracer0_tpu_torch import RenderConfig, Renderer, scenes
from pathtracer0_tpu_torch.tools import (diag_build4m, diag_scale_frame,
                                         diag_streamed, profile,
                                         run_hero_full)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TINY = 24
# a camera that sees the tiny terrain (the tools' own, at 14 units up,
# sees it only from n of about 150 on)
CAM_TINY = ((0.0, 5.5, -2.5), (0.5, 0.0, 0.0))


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def jstreamed():
    """The JAX package's tools/diag_streamed.py."""
    spec = importlib.util.spec_from_file_location(
        "jax_diag_streamed", os.path.join(ROOT, "tools", "diag_streamed.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_terrain_and_rays_bit_equal(jstreamed):
    dev, info = jstreamed.terrain(N_TINY)
    v = diag_streamed.terrain_mesh(N_TINY)
    for k, vk in enumerate(v):
        np.testing.assert_array_equal(
            vk.astype(np.float32), np.asarray(getattr(dev, f"tri_v{k + 1}")))
    sc, pinfo = diag_streamed.terrain(N_TINY, device="cpu")
    assert pinfo.num_tris == dev.num_tris == 2 * (N_TINY - 1) ** 2
    np.testing.assert_array_equal(sc.tris[:, 0:3].numpy(),
                                  np.asarray(dev.tri_v1))
    ext = diag_streamed.extent(N_TINY)
    for kind in ("primary", "bounce"):
        rj, rt = np.random.RandomState(3), np.random.RandomState(3)
        for a, b in zip(jstreamed.make_rays(kind, 1000, ext, rj),
                        diag_streamed.make_rays(kind, 1000, ext, rt)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["primary", "bounce"])
def test_origin_major_key_bit_equal(jstreamed, kind):
    """The key of the JAX tool on 4,096 rays, in the n = 708 terrain's box
    (the primary rays start outside it: negative cells, clipped)."""
    ext = diag_streamed.extent(708)
    o, d = diag_streamed.make_rays(kind, 4096, ext,
                                   np.random.RandomState(5))
    lo = np.array([-ext, -6.2, -ext], np.float32)
    hi = np.array([ext, 6.3, ext], np.float32)
    want = np.asarray(jstreamed._origin_major_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = diag_streamed.origin_major_key(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
        torch.from_numpy(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the primary rays share one origin: their keys differ by octant alone
    assert len(np.unique(want)) == 2 if kind == "primary" else \
        len(np.unique(want >> 3)) > 1000


def test_streamed_run_matches_jax_kernel(jstreamed):
    """`run` on the tiny terrain built streamed (both packages with
    stream_threshold=0), 512 rays of each kind in one batch, against the
    JAX `trace_streamed` interpreted on the same rays."""
    ext = diag_streamed.extent(N_TINY)
    rng = np.random.RandomState(3)
    o, d = (np.concatenate(x) for x in zip(
        diag_streamed.make_rays("primary", 512, ext, rng),
        diag_streamed.make_rays("bounce", 512, ext, rng)))
    js = JScene()
    js.set_constant_sky((0.5, 0.6, 0.9))
    js.add_material("m")
    js.add_mesh(*diag_streamed.terrain_mesh(N_TINY), 0)
    dev, info = js.build(JConfig(stream_threshold=0))
    sc, pinfo = diag_streamed.terrain(
        N_TINY, config=RenderConfig(stream_threshold=0), device="cpu")
    assert info.streamed and pinfo.streamed
    lines = []
    row, (_, _, _, res, order) = diag_streamed.run(
        sc, pinfo, o, d, True, "mixed+sort", out=lines.append)
    assert json.loads(lines[0]) == row and row["ms"] is None
    # the JAX tool's order: its spatial key, stable argsort
    key = jtraverse._spatial_sort_key(jnp.asarray(o), jnp.asarray(d),
                                      dev.st_top[0, 0:3], dev.st_top[0, 3:6])
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.argsort(key, stable=True)))
    tj, _, _, ij, _, _ = jwavefront.trace_streamed(
        jnp.asarray(o.T), jnp.asarray(d.T), jnp.full((1024,), 1e30,
                                                     jnp.float32),
        dev.st_top, dev.st_tris, dev.st_sub, n_treelets=info.st_n_treelets,
        treelet_rows=info.st_treelet_rows, leaf_cap=info.st_leaf_cap,
        block_rows=8, interpret=True)
    ij = np.asarray(ij)
    tri_j = np.where(ij >= 0, np.asarray(dev.st_perm)[np.maximum(ij, 0)], -1)
    t_s, idx_s = res[0], res[3]
    t_t = np.empty(1024, np.float32)
    tri_t = np.empty(1024, np.int64)
    t_t[order.numpy()] = t_s.numpy()
    tri_t[order.numpy()] = np.where(
        idx_s >= 0, sc.st_perm[idx_s.clamp(min=0).long()], -1)
    same = tri_j == tri_t
    assert same.mean() >= 0.999, same.mean()
    hit = tri_t >= 0
    assert 0.05 < hit.mean() < 0.95
    tj = np.asarray(tj)
    assert np.abs(tj[same & hit] - t_t[same & hit]).max() <= 1e-5
    assert row["hit_pct"] == pytest.approx(100.0 * (tj < 1e25).mean(),
                                           abs=0.0)
    assert row["pairs_per_ray"] == row["row_visits_per_ray"] * 14


def test_scale_frame_queries_match_jax():
    """spp 1 at bounces 1-3, 32x24, the tiny terrain in the tool's
    material: the port's live queries against the JAX render_frame's at
    the same seed."""
    rows = diag_scale_frame.main(N_TINY, size=(32, 24), cam=CAM_TINY,
                                 device="cpu", out=_quiet)
    assert [(r["spp"], r["bounces"]) for r in rows] == list(
        diag_scale_frame.SETTINGS)
    js = JScene()
    js.set_constant_sky((0.5, 0.6, 0.9))
    js.add_material("terrain")
    js.set_last_mtl("Kd", (0.45, 0.52, 0.38))
    js.set_last_mtl("Pr", 1.0)
    js.add_mesh(*diag_streamed.terrain_mesh(N_TINY), 0)
    dev, info = js.build(JConfig())
    cam, rot = (jnp.asarray(v, jnp.float32) for v in CAM_TINY)
    for r in rows:
        if r["spp"] != 1:
            continue
        cfg = JConfig(width=32, height=24, samples_per_frame=1,
                      max_bounces=r["bounces"], auto_focus=False, blur=0.0)
        _, q = jrender_frame(dev, cam, rot, jnp.uint32(r["seed"]),
                             **bench._frame_kwargs(cfg, info))
        q = int(q)
        assert abs(r["live_queries"] - q) <= 0.01 * q + 16, (r, q)
        assert r["ms"] is None and r["mrays_per_s"] is None
    # live queries rise with bounces at a fixed spp, and double with spp
    by = {(r["spp"], r["bounces"]): r["live_queries"] for r in rows}
    assert by[1, 1] == 32 * 24 and by[2, 1] == 2 * 32 * 24
    assert by[1, 1] < by[1, 2] <= by[1, 3]


# tools/profile.py:93-104 and :113-127: its base kwargs and row overrides
JAX_ROWS = ({}, {"max_bounces": 1}, {"samples_per_frame": 1},
            {"fused": "off"}, {"fused": "on"})


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5, 6])
def test_profile_rows_configs_equal_jax(config):
    w, h, spp, bounces, raytracing = bench.BENCH_PARAMS.get(
        config, (800, 600, 8, 6, True))
    spp = min(spp, 8)
    assert [kw for _, kw in profile.ROWS] == list(JAX_ROWS)
    for kw in JAX_ROWS:
        base = dict(width=w, height=h, samples_per_frame=spp,
                    max_bounces=bounces, raytracing=raytracing,
                    auto_focus=False, blur=0.001)
        base.update(kw)
        want = JConfig(**base)
        got = profile.frame_config(config, None, kw)
        shared = ({f.name for f in dataclasses.fields(want)}
                  & {f.name for f in dataclasses.fields(got)})
        assert len(shared) > 20
        for name in shared:
            assert getattr(got, name) == getattr(want, name), (kw, name)
    assert profile.frame_config(config, 3).samples_per_frame == 3


def test_profile_bench_params_copy():
    assert profile.BENCH_PARAMS == bench.BENCH_PARAMS


def test_profile_main_on_cpu_writes_a_trace(tmp_path):
    """Config 6 (triangles and maps) at 16x12, 2 spp, 2 bounces: every
    row runs, no time is measured off the card, and --trace writes
    Chrome's trace of one frame."""
    lines = []
    out = profile.main(["--config", "6", "--frames", "1", "--device", "cpu",
                        "--trace", str(tmp_path)], params=(16, 12, 2, 2, True),
                       out=lines.append)
    assert [r["row"] for r in out["rows"]] == [n for n, _ in profile.ROWS]
    assert all(r["ms"] is None and r["launches_per_frame"] == {}
               for r in out["rows"])
    path = tmp_path / "profile_config6.json"
    assert out["trace"]["trace"] == str(path)
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert out["trace"]["busy_share"] is None
    assert len(lines) == 1 + len(profile.ROWS) + 1


def test_build4m_bytes_on_cpu():
    rec, sc, info = diag_build4m.main(N_TINY, device="cpu", out=_quiet)
    total = sum(getattr(sc, f.name).numel() * getattr(sc, f.name)
                .element_size() for f in dataclasses.fields(sc))
    assert rec["total_bytes"] == total > 0
    assert rec["fields"] == [] and rec["build_s"] is None
    assert info.num_tris == 2 * (N_TINY - 1) ** 2


def test_hero_run_on_cpu(tmp_path):
    """32x18, 2 spp a frame to 8 spp (4 frames), chunk 2, a checkpoint
    every 2 frames."""
    hero = os.path.join(ROOT, "HERO_RUN.json")
    with open(hero, "rb") as f:
        before = f.read()
    kw = dict(width=32, height=18, samples_per_frame=2)
    rec = run_hero_full.run(8, 2, 2, out_dir=str(tmp_path), device="cpu",
                            overrides=kw, log=_quiet)
    with open(hero, "rb") as f:
        assert f.read() == before
    assert set(json.loads(before)) <= set(rec)
    assert sorted(os.listdir(tmp_path)) == [
        "GLSL_render.png", "hero_ckpt_torch.npz", "hero_run_torch.json"]
    with open(tmp_path / "hero_run_torch.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert rec["frames"] == 4 and rec["checkpoints"] == 2
    assert rec["time_to_4096spp_s"] is None and rec["device"] == "cpu"
    assert np.isfinite(rec["residual_noise_per_image"])
    # the same calls through the port's Renderer: one warm-up chunk, a
    # reset, then one render of the 4 frames
    cfg = dataclasses.replace(RenderConfig(**run_hero_full.HERO), **kw)
    sc, info = scenes.BUILDERS[5]().build(max_leaf=4, device="cpu")
    cam, rot = scenes.CAMERAS[5]
    r = Renderer(sc, info, cfg, cam_pos=cam, cam_rot=rot, device="cpu")
    r.render(frames=2, chunk=2)
    r.reset_accumulation()
    r.render(frames=4, chunk=2)
    ck = np.load(tmp_path / "hero_ckpt_torch.npz")
    assert np.array_equal(ck["sum"], r._sum.numpy())
    assert (int(ck["count"]), int(ck["seed_draws"])) == (4, 6)
    # the JAX package's Renderer resumes from it
    dev, jinfo = jscenes.BUILDERS[5]().build(max_leaf=4)
    jr = JRenderer(dev, jinfo, JConfig(**dict(run_hero_full.HERO, **kw)),
                   cam_pos=np.asarray(cam, np.float32),
                   cam_rot=np.asarray(rot, np.float32))
    jr.load_checkpoint(str(tmp_path / "hero_ckpt_torch.npz"))
    assert (jr._count, jr._seed_draws) == (4, 6)
    np.testing.assert_array_equal(np.asarray(jr.display_image()),
                                  r.display_image().numpy())
