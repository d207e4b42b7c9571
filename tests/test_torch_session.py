"""The port's session surface (pathtracer0_tpu_torch.render.renderer
`Renderer`, config.RenderConfig.preview) against the JAX package's on the
CPU: the seed stream by chunk and by explicit seeds, checkpoint and
resume within the port and across the two packages, the mouse inspector
(`pick`, `display_image_with_pick`), `telemetry` and `auto_screenshot`.

Each scene is built through both packages from the same calls, and the
same seeds, drawn by the same `RandomState`, go to both. Tolerances:
  seeds, counters, checkpoint keys and dtypes, telemetry text: equal;
  a checkpoint round trip within the port: images bit-equal after the
  load and after one more step;
  images across the packages: those of tests/test_torch_route.py
  (per-pixel max-abs difference < 1e-4 on >= 99% of the pixels, mean abs
  difference < 5e-3);
  pick records: hit, kind, obj and material equal; distance within
  1e-5 x (1 + t); normal and loc within 1e-5 x (1 + |loc|).
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from pathtracer0_tpu import RenderConfig as JConfig
from pathtracer0_tpu import Renderer as JRenderer
from pathtracer0_tpu import Scene as JScene
from pathtracer0_tpu_torch import RenderConfig, Renderer, Scene
from pathtracer0_tpu_torch.render import renderer as trenderer

torch.set_num_threads(1)

KW = dict(width=64, height=48, samples_per_frame=2, max_bounces=3,
          auto_focus=False, blur=0.0)
SHOT = re.compile(r"autoScreenshot_(\d+)_\d{4}_\d{2}_\d{2}_\d{2}_\d{2}\.png")


def _simple(sc):
    """The analytic scene of tests/conftest.py `simple_scene` through
    either package's Scene API: two spheres under a constant sky."""
    sc.set_constant_sky((0.6, 0.7, 0.9))
    sc.add_material("diffuse_red")
    sc.set_last_mtl("Kd", (0.8, 0.2, 0.2))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_material("floorish")
    sc.set_last_mtl("Kd", (0.7, 0.7, 0.7))
    sc.set_last_mtl("Pr", 1.0)
    sc.add_sphere((0.0, 0.0, 3.0), 1.0, m=0)
    sc.add_ellipsoid((0.0, -101.0, 3.0), (1, 1, 1), (0, 0, 0), 100.0, m=1)
    return sc


def _table_obj(path):
    """A small table in one OBJ file, four objects: a top and three legs
    (stand-in for the reference's table fixture)."""
    lines, vid = [], 0

    def box(name, lo, hi):
        nonlocal vid
        lines.append(f"o {name}")
        for x in (lo[0], hi[0]):
            for y in (lo[1], hi[1]):
                for z in (lo[2], hi[2]):
                    lines.append(f"v {x} {y} {z}")
        for a, b, c, d in ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                           (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)):
            lines.append(f"f {vid + a + 1} {vid + b + 1} {vid + c + 1}")
            lines.append(f"f {vid + a + 1} {vid + c + 1} {vid + d + 1}")
        vid += 8

    box("top", (-0.8, 0.3, 2.6), (0.8, 0.4, 3.6))
    for k, x in enumerate((-0.7, 0.0, 0.6)):
        box(f"leg{k}", (x, -0.6, 2.9), (x + 0.1, 0.3, 3.0))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def pair():
    """(JAX scene, info, port scene, info) of the simple scene."""
    dev, info = _simple(JScene()).build(JConfig(**KW))
    sc, pinfo = _simple(Scene()).build(RenderConfig(**KW), device="cpu")
    return dev, info, sc, pinfo


def _renderers(pair, seed, **kw):
    dev, info, sc, pinfo = pair
    cfg = dict(KW, **kw)
    return (JRenderer(dev, info, JConfig(**cfg), seed=seed),
            Renderer(sc, pinfo, RenderConfig(**cfg), seed=seed,
                     device="cpu"))


def _assert_images(a, b):
    a, b = np.asarray(a), b.numpy() if torch.is_tensor(b) else b
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, (diff.max(), (diff < 1e-4).mean())
    assert np.abs(a - b).mean() < 5e-3


def _assert_records(rj, rt):
    assert set(rj) == set(rt)
    for key in ("hit", "kind", "obj", "material"):
        assert rj[key] == rt[key] and type(rj[key]) is type(rt[key]), key
    assert isinstance(rt["distance"], float)
    assert abs(rj["distance"] - rt["distance"]) <= 1e-5 * (
        1.0 + abs(rj["distance"]))
    for key in ("normal", "loc"):
        assert rt[key].dtype == np.float32 and rt[key].shape == (3,)
    limit = 1e-5 * (1.0 + np.abs(rj["loc"]).max())
    assert np.abs(rj["normal"] - rt["normal"]).max() <= limit
    assert np.abs(rj["loc"] - rt["loc"]).max() <= limit


@pytest.mark.parametrize("kw", [{}, dict(width=64, height=48),
                                dict(width=1920, height=1080,
                                     samples_per_frame=8, raytracing=False)])
def test_preview_matches_jax(kw):
    """500 px wide at the same aspect, 4 spp, 2 bounces; every other field
    kept."""
    j, t = JConfig(**kw).preview(), RenderConfig(**kw).preview()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.width, t.samples_per_frame, t.max_bounces) == (500, 4, 2)


def _record_port(monkeypatch):
    calls = []
    real = trenderer.render_frames_accum

    def spy(scene, info, config, cam_pos, cam_rot, frame_seeds, *a, **k):
        calls.append(list(frame_seeds))
        return real(scene, info, config, cam_pos, cam_rot, frame_seeds,
                    *a, **k)

    monkeypatch.setattr(trenderer, "render_frames_accum", spy)
    return calls


def _record_jax(r):
    """The JAX renderer's seeds by dispatch, its frames not rendered (the
    JAX package is the seed stream's reference here)."""
    calls = []
    r._accum_frames = lambda seeds: calls.append(list(seeds))
    return calls


def test_render_chunks_draw_the_same_seeds(pair, monkeypatch):
    """render(5, chunk=2): three calls of 2, 2 and 1 frames, the same
    seeds as chunk=8 (one call) and as the JAX package's render(5, 2); the
    same image either way."""
    calls = _record_port(monkeypatch)
    jr, a = _renderers(pair, seed=11)
    jcalls = _record_jax(jr)
    img_a = a.render(frames=5, chunk=2).clone()
    jr.render(5, 2)
    assert [len(c) for c in calls] == [2, 2, 1] == [len(c) for c in jcalls]
    assert calls == jcalls
    b = _renderers(pair, seed=11)[1]
    img_b = b.render(frames=5)
    assert calls[3:] == [sum(jcalls, [])]
    assert torch.equal(img_a, img_b)
    for r in (a, b):
        assert (r._count, r._frame_index, r._seed_draws) == (5, 5, 5)
        assert isinstance(r.rays_traced, int) and r.rays_traced > 0
    assert a.rays_traced == b.rays_traced


def test_seed_draws_count_mixed_seeds(pair, monkeypatch):
    """Explicit seeds draw nothing from the stream; drawn ones count, as
    in the JAX package."""
    calls = _record_port(monkeypatch)
    jr, r = _renderers(pair, seed=4)
    jcalls = _record_jax(jr)
    for x in (jr, r):
        x.step(frame_seed=5)
        x.step()
        x.render(3, chunk=2)
        x.step(frame_seed=9)
        x.step()
    assert calls == jcalls
    assert calls[0] == [5] and calls[-2] == [9]
    assert (r._seed_draws, r._frame_index) == (jr._seed_draws,
                                               jr._frame_index) == (5, 7)


def test_checkpoint_round_trip_is_bit_equal(pair, tmp_path):
    """save -> load in a fresh Renderer of the same seed: the display
    image bit-equal, and again after one more drawn frame each; the
    autofocus cache is dropped on load."""
    _, r = _renderers(pair, seed=8, auto_focus=True)
    r.step(frame_seed=3)
    r.render(2)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    _, s = _renderers(pair, seed=8, auto_focus=True)
    s.move_camera(pos=(0.0, 0.4, 0.0))
    s.step()
    assert s._ifd is not None
    s.load_checkpoint(path)
    assert s._ifd is None
    assert torch.equal(r.display_image(), s.display_image())
    assert (s._count, s._frame_index, s._seed_draws) == (3, 3, 2)
    assert torch.equal(s.cam_pos, r.cam_pos)
    r.step()
    s.step()
    assert torch.equal(r.display_image(), s.display_image())
    # a file without seed_draws fast-forwards by frame_index
    data = dict(np.load(path))
    del data["seed_draws"]
    old = str(tmp_path / "old.npz")
    np.savez(old, **data)
    s.load_checkpoint(old)
    ref = np.random.RandomState(8)
    for _ in range(3):
        ref.randint(0, 10000)
    assert s._seed_draws == 3
    assert s._rng.randint(0, 10000) == ref.randint(0, 10000)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(pair, tmp_path, writer):
    """A checkpoint of either package loads in the other: the same keys
    and dtypes, the same counters and pose, the same next seed, and after
    one more frame each the images agree within the route limits."""
    jr, tr = _renderers(pair, seed=21)
    src, dst = (jr, tr) if writer == "jax" else (tr, jr)
    src.move_camera(pos=(0.0, 0.2, -0.1), rot=(0.05, 0.0, 0.0))
    src.step(frame_seed=17)
    src.step()
    paths = {}
    for name, r in (("jax", jr), ("port", tr)):
        paths[name] = str(tmp_path / f"{name}.npz")
        r.save_checkpoint(paths[name])
    own, other = (np.load(paths[k]) for k in ("jax", "port"))
    assert sorted(own.files) == sorted(other.files) == sorted(
        ["sum", "count", "frame_index", "seed_draws", "cam_pos", "cam_rot"])
    for key in own.files:
        assert own[key].dtype == other[key].dtype, key
        assert own[key].shape == other[key].shape, key
    dst.load_checkpoint(paths[writer])
    assert (dst._count, dst._frame_index, dst._seed_draws) == (2, 2, 1)
    np.testing.assert_array_equal(np.asarray(dst.cam_pos),
                                  np.asarray(src.cam_pos))
    np.testing.assert_array_equal(np.asarray(dst.cam_rot),
                                  np.asarray(src.cam_rot))
    np.testing.assert_array_equal(np.asarray(dst.display_image()),
                                  np.asarray(src.display_image()))
    state_j, state_t = jr._rng.get_state(), tr._rng.get_state()
    assert state_j[2] == state_t[2]
    np.testing.assert_array_equal(state_j[1], state_t[1])
    jr.step()
    tr.step()
    assert jr._seed_draws == tr._seed_draws == 2
    _assert_images(jr.display_image(), tr.display_image())


def test_pick_known_sphere(pair):
    """The centre pixel looks straight at the unit sphere at (0, 0, 3):
    distance 2, normal -z, material 0, an ellipsoid; the same record as
    the JAX package's."""
    jr, r = _renderers(pair, seed=0, width=64, height=64)
    p = r.pick(32, 32)
    assert p["hit"] and p["kind"] == 3 and p["material"] == 0
    assert p["obj"] == -1
    assert p["distance"] == pytest.approx(2.0, abs=1e-2)
    assert p["normal"][2] == pytest.approx(-1.0, abs=1e-2)
    _assert_records(jr.pick(32, 32), p)


def test_pick_miss(pair):
    jr, r = _renderers(pair, seed=0, width=64, height=64)
    p = r.pick(0, 63)   # the top-left corner: sky
    assert not p["hit"] and p["kind"] == 0 and p["material"] == -1
    _assert_records(jr.pick(0, 63), p)


def test_pick_triangle_object(tmp_path):
    """A four-object OBJ (a generated table) through the forest: the
    triangle hits name the object by its root node, as in the JAX
    package."""
    path = str(tmp_path / "table.obj")
    _table_obj(path)
    out = []
    for S, C in ((JScene, JConfig), (Scene, RenderConfig)):
        sc = S()
        sc.set_constant_sky((0.3, 0.4, 0.6))
        sc.add_material("default")
        sc.set_last_mtl("Kd", (0.75, 0.7, 0.6))
        sc.add_object(path, material=0)
        cfg = C(width=64, height=64, auto_focus=False)
        kw = {} if S is JScene else {"device": "cpu"}
        built = sc.build(cfg, 4, **kw)
        out.append((built, cfg, kw))
    ((dev, info), jcfg, _), ((sc, pinfo), cfg, _) = out
    assert pinfo.num_objects == info.num_objects == 4
    jr = JRenderer(dev, info, jcfg, cam_pos=(0.0, 0.5, 0.0))
    r = Renderer(sc, pinfo, cfg, cam_pos=(0.0, 0.5, 0.0), device="cpu")
    # the top, a leg, the sky beside and below them
    picks = [(28, 30), (32, 30), (36, 30), (36, 26), (24, 26), (40, 34)]
    hits = []
    for x, y in picks:
        rj, rt = jr.pick(x, y), r.pick(x, y)
        _assert_records(rj, rt)
        hits.append(rt)
    tri = [p for p in hits if p["hit"] and p["kind"] == 1]
    assert tri
    roots = set(sc.roots.tolist())
    assert all(p["obj"] in roots for p in tri)
    assert len({p["obj"] for p in tri}) >= 2      # the top and a leg
    assert any(not p["hit"] for p in hits)


def test_display_image_with_pick(pair):
    """Pixels within `radius` of the cursor show the picked normal exactly,
    the others the display image; the same disc as the JAX package's."""
    jr, r = _renderers(pair, seed=2)
    for x in (jr, r):
        x.step(frame_seed=31)
    cfg = r.config
    px, py = cfg.width // 2, cfg.height // 2
    rec = r.pick(px, py)
    img = r.display_image_with_pick(px, py, radius=0.02)
    base = r.display_image().numpy()
    assert isinstance(img, np.ndarray) and img.shape == base.shape
    np.testing.assert_array_equal(img[py, px], rec["normal"])
    np.testing.assert_array_equal(img[0, 0], base[0, 0])
    jimg = jr.display_image_with_pick(px, py, radius=0.02)
    jbase = np.asarray(jr.display_image())
    disc = (img != base).any(-1)
    assert disc.sum() > 1
    np.testing.assert_array_equal(disc, (jimg != jbase).any(-1))
    _assert_images(jimg, img)


@pytest.mark.parametrize("pose", [((1.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                                  ((0.0, 1.2, 0.0), (0.25, 0.0, 0.0)),
                                  ((-0.1, 0.7, 2.5), (0.1, -0.45, 1e-8))])
def test_telemetry_matches_jax(pair, pose):
    """The same text, character for character: the pose as float32
    values, formatted as the JAX package formats them."""
    jr, r = _renderers(pair, seed=0)
    for x in (jr, r):
        x.move_camera(pos=np.asarray(pose[0], np.float32),
                      rot=np.asarray(pose[1], np.float32))
    assert r.telemetry() == jr.telemetry()
    assert r.telemetry().startswith("Camera Position: \n(")


def test_auto_screenshot_name(pair, tmp_path, monkeypatch):
    """autoScreenshot_<frames>_<Y_m_d_H_M>.png, the frame count the
    accumulation's, as the JAX package names it."""
    monkeypatch.chdir(tmp_path)
    jr, r = _renderers(pair, seed=0)
    r.step(frame_seed=1)
    r.step(frame_seed=2)
    path = r.auto_screenshot(str(tmp_path / "shots"))
    assert os.path.dirname(path) == str(tmp_path / "shots")
    assert os.path.exists(path)
    m = SHOT.fullmatch(os.path.basename(path))
    assert m and m.group(1) == "2"
    jr._count = 2
    jr.display_image = lambda: np.zeros((48, 64, 3), np.float32)
    jpath = jr.auto_screenshot()
    assert SHOT.fullmatch(os.path.basename(jpath)).group(1) == "2"
    # the default directory is the JAX package's, relative to the cwd
    assert os.path.dirname(r.auto_screenshot()) == "screenshots"
