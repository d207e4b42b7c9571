"""Frame-loop driver: the reference's interactive loop (dispatch.java:
593-713), headless; the port of the JAX package's render/driver.py.

  * progressive accumulation while the camera is still (FRAMES_STILL++,
    frag.glsl:924-933);
  * adaptive preview while the camera moves: the reference's 500-px-wide,
    4 spp, 2-bounce quality (`RenderConfig.preview`) with an accumulation
    reset, and full quality with another reset once motion stops
    (dispatch.java:646-691);
  * movement with the reference's key bindings: WASD planar, q/e
    vertical, arrow keys rotate, '=' / '-' scale the move speed by 10
    (dispatch.java:738-777);
  * the stdin commands `telemetry` and `screenshot` (dispatch.java:
    779-802);
  * an auto-screenshot once the view has been still for
    `auto_screenshot_after` frames (dispatch.java:594-602), written to
    `screenshot_dir`;
  * a render-anomaly watchdog (the reference closes on FPS > 4000,
    dispatch.java:611-615).

Commands arrive as text lines: from stdin in `run()` (polled once a frame
without blocking, like functions.commands) or from an iterable in
`run_script()`.
"""
from __future__ import annotations

import math
import sys
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..config import RenderConfig
from .renderer import Renderer

KEYS = ("w", "a", "s", "d", "q", "e", "up", "down", "left", "right", "=",
        "-")


class FrameLoopDriver:
    """Progressive render loop with adaptive preview quality. Renders on
    `device` (default: the card)."""

    def __init__(self, scene, info, config: RenderConfig,
                 cam_pos=(0.0, 0.0, 0.0), cam_rot=(0.0, 0.0, 0.0),
                 move_speed: float = 0.5, sensitivity: float = 0.15,
                 auto_screenshot_after: Optional[int] = None,
                 screenshot_dir: str = "screenshots",
                 preview_frames: int = 1, log=None,
                 watchdog_every: Optional[int] = 8, device=None):
        self.full_config = config
        self.preview_config = config.preview()
        self.scene = scene
        self.info = info
        self.move_speed = move_speed          # dispatch.java:73 MOVE_SPEED
        self.sensitivity = sensitivity        # dispatch.java:74
        self.auto_screenshot_after = auto_screenshot_after
        self.screenshot_dir = screenshot_dir
        self.preview_frames = preview_frames
        self.log = log or (lambda *_: None)
        pos = np.asarray(cam_pos, np.float32)
        rot = np.asarray(cam_rot, np.float32)
        self.renderer = Renderer(scene, info, config, cam_pos=pos,
                                 cam_rot=rot, device=device)
        self.preview_renderer = Renderer(scene, info, self.preview_config,
                                         cam_pos=pos, cam_rot=rot,
                                         device=device)
        self._moving_frames = 0   # frames left at preview quality
        self._was_moving = False
        self.frames_still = 0     # FRAMES_STILL (dispatch.java:86)
        self._auto_shot_done = False
        self.closed = False
        self.last_screenshot: Optional[str] = None
        # Every `watchdog_every` still frames (None: never) the
        # accumulation's statistics come to the host: a non-finite sum
        # closes the loop, an all-black one after real frames is reported
        # (an empty scene may be black). The copy waits for the device,
        # hence the cadence.
        self.watchdog_every = watchdog_every
        self.anomaly: Optional[str] = None

    # -- camera ----------------------------------------------------------
    @property
    def cam_pos(self) -> np.ndarray:
        return self.renderer.cam_pos.cpu().numpy()

    @property
    def cam_rot(self) -> np.ndarray:
        return self.renderer.cam_rot.cpu().numpy()

    def _move(self, dpos=None, drot=None):
        """Apply a camera delta (float32, as the JAX driver adds it); the
        next tick renders at preview quality."""
        pos = self.cam_pos
        rot = self.cam_rot
        if dpos is not None:
            pos = pos + np.asarray(dpos, np.float32)
        if drot is not None:
            rot = rot + np.asarray(drot, np.float32)
        self.renderer.move_camera(pos, rot)
        self.preview_renderer.move_camera(pos, rot)
        self._moving_frames = self.preview_frames
        self.frames_still = 0
        self._auto_shot_done = False

    def _key_move(self, key: str):
        """WASD/qe/arrows with the reference's axes (dispatch.java:742-776:
        planar motion rotated by the Y angle)."""
        ry = float(self.cam_rot[1])
        s, c = math.sin(ry), math.cos(ry)
        v = self.move_speed
        planar = {
            "w": (v * s, 0.0, v * c),
            "s": (-v * s, 0.0, -v * c),
            "a": (-v * c, 0.0, v * s),
            "d": (v * c, 0.0, -v * s),
            "q": (0.0, -v, 0.0),
            "e": (0.0, v, 0.0),
        }
        rots = {
            "up": (self.sensitivity, 0.0, 0.0),
            "down": (-self.sensitivity, 0.0, 0.0),
            "left": (0.0, self.sensitivity, 0.0),
            "right": (0.0, -self.sensitivity, 0.0),
        }
        if key in planar:
            self._move(dpos=planar[key])
        elif key in rots:
            self._move(drot=rots[key])
        elif key == "=":
            self.move_speed *= 10.0   # dispatch.java:771-776
        elif key == "-":
            self.move_speed /= 10.0

    # -- commands ----------------------------------------------------------
    def submit(self, line: str) -> Optional[str]:
        """One command line (functions.commands, dispatch.java:779-802, and
        the keyboard handler). Returns the reply of a printable command."""
        parts = line.strip().split()
        if not parts:
            return None
        cmd = parts[0].lower()
        if cmd == "telemetry":
            reply = self.renderer.telemetry()
            self.log(reply)
            return reply
        if cmd == "screenshot":
            name = parts[1] if len(parts) > 1 else None
            path = self.renderer.screenshot(name,
                                            directory=self.screenshot_dir)
            self.last_screenshot = path
            self.log(f"saved {path}")
            return path
        if cmd == "move" and len(parts) == 4:
            self._move(dpos=[float(x) for x in parts[1:4]])
            return None
        if cmd == "rot" and len(parts) == 4:
            self._move(drot=[float(x) for x in parts[1:4]])
            return None
        if cmd in KEYS:
            self._key_move(cmd)
            return None
        if cmd in ("quit", "exit"):
            self.closed = True
            return None
        self.log(f"unknown command: {line!r}")
        return None

    # -- loop ---------------------------------------------------------------
    @property
    def moving(self) -> bool:
        return self._moving_frames > 0

    def tick(self) -> torch.Tensor:
        """One frame: preview quality while moving, full quality while
        still, with an accumulation reset on each change
        (dispatch.java:646-691)."""
        if self.moving:
            if not self._was_moving:
                self.preview_renderer.reset_accumulation()
            img = self.preview_renderer.step()
            self._moving_frames -= 1
            self._was_moving = True
            return img
        if self._was_moving:
            self.renderer.reset_accumulation()
            self._was_moving = False
        img = self.renderer.step()
        self.frames_still += 1
        if (self.watchdog_every
                and self.frames_still % self.watchdog_every == 0):
            self._watchdog_check()
        if (self.auto_screenshot_after is not None
                and not self._auto_shot_done
                and self.frames_still >= self.auto_screenshot_after):
            self.last_screenshot = self.renderer.auto_screenshot(
                self.screenshot_dir)
            self._auto_shot_done = True
            self.log(f"auto-screenshot {self.last_screenshot}")
        return img

    def _watchdog_check(self):
        """Flag a crashed render (dispatch.java:611-615): both statistics
        come to the host in one copy."""
        s = self.renderer._sum
        finite, peak = torch.stack([torch.isfinite(s).all().float(),
                                    s.abs().amax()]).tolist()
        if not finite:
            self.anomaly = "non-finite accumulation"
            self.log(f"watchdog: {self.anomaly} after "
                     f"{self.frames_still} frames — aborting")
            self.closed = True
        elif peak == 0.0:
            # latched: a dark view would otherwise log at every cadence tick
            if self.anomaly != "all-black accumulation":
                self.anomaly = "all-black accumulation"
                self.log(f"watchdog: {self.anomaly} after "
                         f"{self.frames_still} frames")
        elif self.anomaly == "all-black accumulation":
            self.anomaly = None  # the view came back to content

    def display_image(self) -> torch.Tensor:
        return (self.preview_renderer if self._was_moving
                else self.renderer).display_image()

    def run_script(self, commands: Iterable[Optional[str]],
                   trailing_frames: int = 0) -> List[str]:
        """A scripted session: each entry is a command line, or None for no
        input that frame; one frame renders after each entry, then
        `trailing_frames` more. Returns the replies."""
        replies = []
        for cmd in commands:
            if cmd is not None:
                r = self.submit(cmd)
                if r is not None:
                    replies.append(r)
            if self.closed:
                break
            self.tick()
        for _ in range(trailing_frames):
            self.tick()
        return replies

    def run(self, max_frames: Optional[int] = None):
        """The interactive loop: poll stdin once a frame without blocking
        and render until `quit`, the end of stdin or `max_frames`."""
        import select

        frames = 0
        while not self.closed:
            if max_frames is not None and frames >= max_frames:
                break
            while select.select([sys.stdin], [], [], 0.0)[0]:
                line = sys.stdin.readline()
                if not line:
                    self.closed = True
                    break
                reply = self.submit(line)
                if reply:
                    print(reply, flush=True)
            if self.closed:
                break
            self.tick()
            frames += 1
