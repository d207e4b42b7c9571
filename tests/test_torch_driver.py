"""The port's frame-loop driver (pathtracer0_tpu_torch.render.driver) and
CLI (python -m pathtracer0_tpu_torch) on the CPU: the 13 cases of the JAX
package's tests/test_driver.py on the port (move -> preview quality ->
stop -> full-quality re-converge -> screenshot / telemetry /
auto-screenshot, the watchdog, the pick overlay), a scripted session
through both drivers, the CLI in-process, and the device rule.

Tolerances: replies, counters and screenshot names equal between the two
drivers; their final images within the limits of tests/test_torch_route.py
(per-pixel max-abs difference < 1e-4 on >= 99% of the pixels, mean abs
difference < 5e-3).
"""
import os

import numpy as np
import pytest
import torch

from pathtracer0_tpu_torch import RenderConfig, Scene
from pathtracer0_tpu_torch.__main__ import main
from pathtracer0_tpu_torch.render.driver import FrameLoopDriver
from tests.test_torch_session import _simple

torch.set_num_threads(1)

KW = dict(width=64, height=48, samples_per_frame=2, max_bounces=2,
          auto_focus=False, blur=0.0)
SCRIPT = [None, "move 0 0 0.5", None, None, None, "screenshot end.png"]


@pytest.fixture(scope="module")
def built():
    return _simple(Scene()).build(device="cpu")


@pytest.fixture()
def driver(built, tmp_path):
    sc, info = built
    return FrameLoopDriver(
        sc, info, RenderConfig(**KW), cam_pos=(0.0, 0.0, 0.0),
        auto_screenshot_after=3, screenshot_dir=str(tmp_path),
        preview_frames=2, device="cpu")


class TestAdaptivePreview:
    def test_move_drops_to_preview_quality(self, driver):
        """While moving, frames render at the reference's 500 px / 4 spp /
        2-bounce preview (dispatch.java:649-662)."""
        driver.tick()                      # still frame at full quality
        assert driver.renderer._count == 1
        driver.submit("move 0 0 0.5")
        assert driver.moving
        img = driver.tick()
        pc = driver.preview_config
        assert img.shape == (pc.height, pc.width, 3)
        assert pc.width == 500 and pc.samples_per_frame == 4 \
            and pc.max_bounces == 2
        assert driver.preview_renderer._count == 1

    def test_stop_restores_full_quality_and_resets(self, driver):
        driver.tick()
        driver.submit("move 0 0 0.5")
        driver.tick()                      # preview 1
        driver.tick()                      # preview 2 (preview_frames=2)
        assert not driver.moving
        img = driver.tick()                # full quality again
        cfg = driver.full_config
        assert img.shape == (cfg.height, cfg.width, 3)
        # the accumulation was reset on the way back: count starts at 1
        assert driver.renderer._count == 1
        assert driver.frames_still == 1

    def test_accumulation_reconverges_after_stop(self, driver):
        driver.submit("move 0 0 1.0")
        for _ in range(2):
            driver.tick()
        imgs = [driver.tick().clone() for _ in range(3)]
        assert not torch.equal(imgs[0], imgs[1])
        assert driver.renderer._count == 3


class TestCommands:
    def test_telemetry_format(self, driver):
        driver.submit("move 1 2 3")
        reply = driver.submit("telemetry")
        assert "Camera Position" in reply and "(1.0,2.0,3.0)" in reply

    def test_screenshot_command(self, driver, tmp_path):
        driver.tick()
        path = driver.submit("screenshot shot.png")
        assert os.path.exists(path)
        assert path == os.path.join(str(tmp_path), "shot.png")

    def test_auto_screenshot_after_still_frames(self, driver, tmp_path):
        for _ in range(3):
            driver.tick()
        assert driver.last_screenshot is not None
        assert "autoScreenshot_3_" in driver.last_screenshot
        assert os.path.dirname(driver.last_screenshot) == str(tmp_path)
        assert os.path.exists(driver.last_screenshot)
        before = driver.last_screenshot
        driver.tick()                      # no second shot while still
        assert driver.last_screenshot == before

    def test_key_movement_conventions(self, driver):
        """'w' moves along +z when unrotated; '=' / '-' scale the speed
        (dispatch.java:742-776)."""
        driver.submit("w")
        np.testing.assert_allclose(driver.cam_pos, [0.0, 0.0, 0.5],
                                   atol=1e-6)
        driver.submit("=")
        driver.submit("e")                 # vertical, 10x speed now
        np.testing.assert_allclose(driver.cam_pos, [0.0, 5.0, 0.5],
                                   atol=1e-5)
        driver.submit("left")
        assert driver.cam_rot[1] == pytest.approx(0.15)

    def test_quit(self, driver):
        driver.run_script(["quit", None, None])
        assert driver.closed
        assert driver.renderer._count == 0  # no frame after quit

    def test_scripted_session(self, driver, tmp_path):
        """move -> preview -> stop -> full-quality re-converge ->
        screenshot."""
        replies = driver.run_script(SCRIPT, trailing_frames=1)
        assert any(str(tmp_path) in r for r in replies)
        assert driver.renderer._count >= 2


class TestWatchdog:
    """The render-anomaly watchdog (the reference closes on FPS > 4000,
    dispatch.java:611-615)."""

    def test_nan_accumulation_aborts(self, driver):
        driver.watchdog_every = 2
        driver.tick()
        assert driver.anomaly is None and not driver.closed
        driver.renderer._sum[0, 0, 0] = float("nan")   # a crashed render
        driver.tick()                      # frames_still hits the cadence
        assert driver.anomaly == "non-finite accumulation"
        assert driver.closed

    def test_all_black_reported_not_fatal(self):
        sc = Scene()
        sc.set_constant_sky((0.0, 0.0, 0.0))   # a pitch-black empty scene
        sc.add_material("m")
        scene, info = sc.build(device="cpu")
        cfg = RenderConfig(width=32, height=24, samples_per_frame=1,
                           max_bounces=2, auto_focus=False, blur=0.0)
        logs = []
        drv = FrameLoopDriver(scene, info, cfg, watchdog_every=1,
                              log=logs.append, device="cpu")
        drv.tick()
        assert drv.anomaly == "all-black accumulation"
        assert not drv.closed              # reported only: empty is legal
        assert any("watchdog" in m for m in logs)
        drv.tick()                         # latched: logged once
        assert sum("watchdog" in m for m in logs) == 1

    def test_healthy_render_untouched(self, driver):
        driver.watchdog_every = 1
        for _ in range(3):
            driver.tick()
        assert driver.anomaly is None and not driver.closed


def test_pick_overlay(driver):
    """The in-image inspector (frag.glsl:888-893): pixels within the radius
    of the cursor show the picked normal."""
    driver.tick()
    r = driver.renderer
    cfg = r.config
    px, py = cfg.width // 2, cfg.height // 2
    rec = r.pick(px, py)
    img = r.display_image_with_pick(px, py, radius=0.02)
    base = r.display_image().numpy()
    assert img.shape == base.shape
    np.testing.assert_array_equal(img[py, px], rec["normal"])
    np.testing.assert_array_equal(img[0, 0], base[0, 0])


def test_scripted_session_matches_jax(built, tmp_path):
    """The scripted session through both drivers: the same replies (the
    screenshot's name in each driver's directory), telemetry, counters at
    both qualities and final images within the route limits."""
    from pathtracer0_tpu import RenderConfig as JConfig
    from pathtracer0_tpu import Scene as JScene
    from pathtracer0_tpu.render.driver import FrameLoopDriver as JDriver

    dev, info = _simple(JScene()).build()
    script = SCRIPT[:5] + ["telemetry", "screenshot end.png"]
    kw = dict(cam_pos=(0.0, 0.2, -0.5), preview_frames=2)
    drivers = {
        "jax": JDriver(dev, info, JConfig(**KW), screenshot_dir=str(
            tmp_path / "jax"), **kw),
        "port": FrameLoopDriver(*built, RenderConfig(**KW),
                                screenshot_dir=str(tmp_path / "port"),
                                device="cpu", **kw)}
    out = {k: d.run_script(script, trailing_frames=1)
           for k, d in drivers.items()}
    j, t = drivers["jax"], drivers["port"]
    assert len(out["port"]) == len(out["jax"]) == 2
    assert out["port"][0] == out["jax"][0]          # telemetry
    for name, reply in out.items():
        assert reply[1] == str(tmp_path / name / "end.png")
        assert os.path.exists(reply[1])
    for attr in ("_count", "_frame_index", "_seed_draws"):
        assert getattr(t.renderer, attr) == getattr(j.renderer, attr)
        assert getattr(t.preview_renderer, attr) \
            == getattr(j.preview_renderer, attr)
    assert (t.frames_still, t.moving, t.closed) == (j.frames_still,
                                                     j.moving, j.closed)
    assert t.renderer._count == 5 and t.preview_renderer._count == 2
    a, b = np.asarray(j.display_image()), t.display_image().numpy()
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-4).mean() >= 0.99, (diff < 1e-4).mean()
    assert np.abs(a - b).mean() < 5e-3


def test_cli_runs_in_process(tmp_path, monkeypatch, capsys):
    """`main([...])` on the CPU with a stdin that stays open: a command
    written to it is answered, and the loop stops at --frames."""
    r_fd, w_fd = os.pipe()
    reader = os.fdopen(r_fd, "r")
    writer = os.fdopen(w_fd, "w")
    try:
        writer.write("telemetry\n")
        writer.flush()
        monkeypatch.setattr("sys.stdin", reader)
        rc = main(["--device", "cpu", "--scene", "1", "--width", "32",
                   "--height", "24", "--spp", "1", "--frames", "2",
                   "--out", str(tmp_path)])
    finally:
        writer.close()
        reader.close()
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("scene built in ")
    assert "(tris=0, streamed=False)" in lines[0]
    assert lines[1] == "Camera Position: "
    assert lines[2] == "(0.0,0.6000000238418579,0.0)"
    assert lines[-1].startswith("2 frames in ")


def test_driver_and_cli_need_the_card_or_cpu(built):
    """Without a card the driver and the CLI raise unless given the CPU;
    they never fall back to it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        FrameLoopDriver(*built, RenderConfig(**KW))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scene", "1", "--width", "32", "--height", "24",
              "--frames", "1"])
    assert FrameLoopDriver(*built, RenderConfig(**KW),
                           device="cpu").renderer.device.type == "cpu"
